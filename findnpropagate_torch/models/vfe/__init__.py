"""The ported voxel feature encoders by their yaml NAME. MeanVFE has no
module: the detector folds it into ops/voxelize.py::voxelize_mean."""

from .dynamic_vfe import (
    DynamicMeanVFE,
    DynamicPillarVFE,
    DynamicPillarVFESimple2D,
)
from .image_vfe import ImageVFE
from .pillar_vfe import PillarVFE

VFE_REGISTRY = {
    "PillarVFE": PillarVFE,
    "DynMeanVFE": DynamicMeanVFE,
    "DynamicMeanVFE": DynamicMeanVFE,
    "DynPillarVFE": DynamicPillarVFE,
    "DynamicPillarVFE": DynamicPillarVFE,
    "DynamicPillarVFESimple2D": DynamicPillarVFESimple2D,
    "ImageVFE": ImageVFE,
}
