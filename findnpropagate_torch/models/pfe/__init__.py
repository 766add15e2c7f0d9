"""The ported point-feature extractors by their yaml NAME."""

from .voxel_set_abstraction import VoxelSetAbstraction

PFE_REGISTRY = {
    "VoxelSetAbstraction": VoxelSetAbstraction,
}
