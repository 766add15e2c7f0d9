"""The ported 3D backbones (sparse and point-based) by their yaml NAME."""

from .pointnet2_backbone import PointNet2MSG
from .spconv_backbone import VoxelBackBone8x, VoxelResBackBone8x
from .spconv_backbone_2d import PillarBackBone8x, PillarRes18BackBone8x
from .spconv_backbone_focal import VoxelBackBone8xFocal
from .spconv_backbone_voxelnext import VoxelResBackBone8xVoxelNeXt
from .spconv_backbone_voxelnext2d import VoxelResBackBone8xVoxelNeXt2D
from .spconv_unet import UNetV2

BACKBONE_3D_REGISTRY = {
    "VoxelBackBone8x": VoxelBackBone8x,
    "VoxelResBackBone8x": VoxelResBackBone8x,
    "VoxelBackBone8xFocal": VoxelBackBone8xFocal,
    "VoxelResBackBone8xVoxelNeXt": VoxelResBackBone8xVoxelNeXt,
    "VoxelResBackBone8xVoxelNeXt2D": VoxelResBackBone8xVoxelNeXt2D,
    "PillarBackBone8x": PillarBackBone8x,
    "PillarRes18BackBone8x": PillarRes18BackBone8x,
    "UNetV2": UNetV2,
    "PointNet2MSG": PointNet2MSG,
}
