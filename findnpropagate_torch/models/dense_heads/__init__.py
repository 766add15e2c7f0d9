"""The ported dense heads by their yaml NAME."""

from .anchor_head import AnchorHeadSingle
from .anchor_head_multi import AnchorHeadMulti
from .center_head import CenterHead
from .center_head_clip import CenterHeadCLIP
from .frustum_heads import FrustumPointNetHead, FrustumViTHead
from .transfusion_head import TransFusionHead
from .transfusion_head_am import TransFusionHeadAM
from .voxelnext_head import VoxelNeXtHead

DENSE_HEAD_REGISTRY = {
    "AnchorHeadSingle": AnchorHeadSingle,
    "AnchorHeadMulti": AnchorHeadMulti,
    "CenterHead": CenterHead,
    "CenterHeadCLIP": CenterHeadCLIP,
    "TransFusionHead": TransFusionHead,
    "TransFusionHeadAM": TransFusionHeadAM,
    "VoxelNeXtHead": VoxelNeXtHead,
    "FrustumViTHead": FrustumViTHead,
    "FrustumPointNetHead": FrustumPointNetHead,
}
