"""The ported camera-to-BEV view transforms by their yaml NAME."""

from .depth_lss import DepthLSSTransform

VTRANSFORM_REGISTRY = {"DepthLSSTransform": DepthLSSTransform}
