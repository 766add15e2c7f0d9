"""VoxelResBackBone8x of the PyTorch port against the JAX backbone on its
posgather path (Pallas interpret mode), through the flax->torch weight
bridge, at batch 1 (dense downsample) and batch 3 (sort downsample).

Tolerance: 1e-4 absolute and relative on the dense output. Both sides run
float32 end to end (interpret mode computes the convs in f32, the dense
tail is f32 here); the residue is f32 summation order across 16 sparse and
6 dense convs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.models.backbones_3d.spconv_backbone import (
    VoxelResBackBone8x as TorchBackbone,
)
from findnpropagate_torch.utils.weights import from_jax_variables
from findnpropagate_tpu.models.backbones_3d import VoxelResBackBone8x

GRID = (32, 32, 40)  # nx, ny, nz -> sparse z 41
CFG = {"MAX_VOXELS": 1024,
       "LEVEL_CAPACITIES": [1024, 1024, 1024, 1024, 1024],
       "DENSE_FROM_LEVEL": 3, "DENSE_DTYPE": "f32",
       "SUBM_MODE": "windowed", "SUBM_IMPL": "posgather",
       "PALLAS_INTERPRET": True, "FUSE_BN_EPILOGUE": True,
       "WINDOWED_BLOCK": 512, "WINDOWED_WINDOW": 512,
       "POSGATHER_BAND": 1, "STRIDED_BAND": 1,
       # one width and one capacity everywhere: interpret mode compiles
       # each distinct kernel signature once, ~10 s each on the CPU
       "CHANNELS": [16, 16, 16, 16, 16], "OUT_CHANNELS": 16}


def make_batch(rng, b, n=300, v_cap=400, c=4):
    nx, ny, nz = GRID
    coords = np.full((b, v_cap, 3), -1, np.int32)
    valid = np.zeros((b, v_cap), bool)
    for i in range(b):
        lin = rng.choice(nx * ny * nz, n, replace=False)
        z, rem = lin // (ny * nx), lin % (ny * nx)
        coords[i, :n] = np.stack([z, rem // nx, rem % nx], -1)
        valid[i, :n] = True
    feats = rng.randn(b, v_cap, c).astype(np.float32) * valid[..., None]
    return {"voxel_features": feats, "voxel_coords": coords,
            "voxel_mask": valid}


def _random_bn(variables, rng):
    """Nontrivial BN statistics so the fused epilogue is exercised."""
    def f(path, leaf):
        name = path[-1].key
        if name == "var":
            return jnp.asarray(rng.uniform(0.5, 2.0, leaf.shape), jnp.float32)
        if name == "mean":
            return jnp.asarray(rng.normal(0, 0.1, leaf.shape), jnp.float32)
        return leaf
    out = dict(variables)
    out["batch_stats"] = jax.tree_util.tree_map_with_path(
        f, variables["batch_stats"])
    return out


@pytest.fixture(scope="module")
def reference():
    """One JAX run at batch 3 (interpret mode compiles ~100 s on a CPU, so
    it is shared): the backbone is per-sample, so its sample 0 is also the
    batch-1 reference."""
    rng = np.random.RandomState(3)
    batch = make_batch(rng, 3)
    jbb = VoxelResBackBone8x(model_cfg=CFG, input_channels=4, grid_size=GRID)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _random_bn(jbb.init(jax.random.PRNGKey(0), dict(jb),
                                    train=False), rng)
    ref = jbb.apply(variables, dict(jb), train=False)
    assert int(ref["sparse_window_overflow"]) == 0
    return batch, jax.tree.map(np.asarray, variables), ref


@pytest.mark.parametrize("b", [1, 3])
def test_backbone_matches_jax_posgather(reference, b):
    """batch 1 takes the dense downsample, batch 3 the sort downsample."""
    batch, variables, ref = reference
    tbb = TorchBackbone(CFG, 4, GRID).eval()
    from_jax_variables(variables, tbb)
    with torch.no_grad():
        got = tbb({k: torch.from_numpy(v[:b]) for k, v in batch.items()})
    assert int(got["sparse_window_overflow"]) == 0
    if b == 3:
        np.testing.assert_array_equal(
            got["sparse_active_counts"].numpy(),
            np.asarray(ref["sparse_active_counts"]))
    np.testing.assert_allclose(
        got["encoded_spconv_tensor"].permute(0, 2, 3, 4, 1).numpy(),
        np.asarray(ref["encoded_spconv_tensor"])[:b], rtol=1e-4, atol=1e-4)
