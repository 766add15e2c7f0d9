"""The ported ROI heads by their yaml NAME. The heads of later items raise
NotImplementedError naming their ROADMAP.md item."""

from .parta2_head import PartA2FCHead
from .pointrcnn_head import PointRCNNHead
from .pvrcnn_head import PVRCNNHead
from .second_head import SECONDHead
from .voxelrcnn_head import VoxelRCNNHead

ROI_HEAD_REGISTRY = {
    "SECONDHead": SECONDHead,
    "PVRCNNHead": PVRCNNHead,
    "VoxelRCNNHead": VoxelRCNNHead,
    "PartA2FCHead": PartA2FCHead,
    "PointRCNNHead": PointRCNNHead,
}
NOT_PORTED = {"MPPNetHead": "15.8", "MPPNetHeadE2E": "15.8"}
