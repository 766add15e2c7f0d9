"""The ported 2D backbones and BEV projections by their yaml NAME."""

from .base_bev_backbone import BaseBEVBackbone, BaseBEVBackboneV1
from .map_to_bev import Conv2DCollapse, HeightCompression, PointPillarScatter

BACKBONE_2D_REGISTRY = {"BaseBEVBackbone": BaseBEVBackbone,
                        "BaseBEVBackboneV1": BaseBEVBackboneV1}

MAP_TO_BEV_REGISTRY = {
    "PointPillarScatter": PointPillarScatter,
    "HeightCompression": HeightCompression,
    "Conv2DCollapse": Conv2DCollapse,
}
