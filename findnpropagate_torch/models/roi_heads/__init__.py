"""The ported ROI heads by their yaml NAME. The heads of later items raise
NotImplementedError naming their ROADMAP.md item."""

from .pvrcnn_head import PVRCNNHead
from .second_head import SECONDHead
from .voxelrcnn_head import VoxelRCNNHead

ROI_HEAD_REGISTRY = {
    "SECONDHead": SECONDHead,
    "PVRCNNHead": PVRCNNHead,
    "VoxelRCNNHead": VoxelRCNNHead,
}
NOT_PORTED = {"PartA2FCHead": "15.5", "PointRCNNHead": "15.5",
              "MPPNetHead": "15.8", "MPPNetHeadE2E": "15.8"}
