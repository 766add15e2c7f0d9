"""The ported ROI heads by their yaml NAME."""

from .mppnet_head import MPPNetHead, MPPNetHeadE2E
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
    "MPPNetHead": MPPNetHead,
    "MPPNetHeadE2E": MPPNetHeadE2E,
}
