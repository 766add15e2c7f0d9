"""The ported dense heads by their yaml NAME."""

from .center_head import CenterHead
from .center_head_clip import CenterHeadCLIP
from .transfusion_head import TransFusionHead

DENSE_HEAD_REGISTRY = {
    "CenterHead": CenterHead,
    "CenterHeadCLIP": CenterHeadCLIP,
    "TransFusionHead": TransFusionHead,
}
