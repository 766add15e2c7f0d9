"""The ported sparse 3D backbones by their yaml NAME."""

from .spconv_backbone import VoxelBackBone8x, VoxelResBackBone8x

BACKBONE_3D_REGISTRY = {
    "VoxelBackBone8x": VoxelBackBone8x,
    "VoxelResBackBone8x": VoxelResBackBone8x,
}
