"""The pillar data path of the PyTorch port against the JAX package, on the
same numpy-seeded inputs and weights (the flax->torch weight bridge):
`voxelize` (the (V, T, C) bucket) and `dynamic_voxelize`, with the
truncation at T points a voxel and at MAX_VOXELS; `PillarVFE` with BN on
batch statistics (training) and on running statistics (eval), with and
without USE_NORM, WITH_DISTANCE and USE_ABSLOTE_XYZ; the dynamic VFEs
(DynamicMeanVFE, DynamicPillarVFE, DynamicPillarVFESimple2D); and
`PointPillarScatter`.

Tolerances: the voxelizer's outputs and the scatter exact (gathers and
scatters of the same floats); the VFEs' outputs within 1e-5 (float32 on
both sides, BN statistics summed in another order), their updated BN
statistics within 1e-5 and their gradients within 1e-4 of each leaf's
largest entry.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.models.backbones_2d.map_to_bev import (
    PointPillarScatter as TorchScatter,
)
from findnpropagate_torch.models.vfe import VFE_REGISTRY as TORCH_VFE
from findnpropagate_torch.ops import voxelize as tvox
from findnpropagate_torch.utils.weights import from_jax_variables, to_jax_tree
from findnpropagate_tpu.models.backbones_2d.map_to_bev import (
    PointPillarScatter,
)
from findnpropagate_tpu.models.vfe import VFE_REGISTRY as JAX_VFE
from findnpropagate_tpu.ops import voxelize as jvox

PCR = (-6.4, -6.4, -3.0, 6.4, 6.4, 1.0)
VOXEL = (0.4, 0.4, 4.0)
GRID = (32, 32, 1)
B = 2
TOL = dict(rtol=1e-5, atol=1e-5)


def flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if hasattr(v, "items"):
            out.update(flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def scene(rng, p=900, c=4):
    """Points in and around the range, a third of them piled into 12
    pillars (more than T points each), the last 50 masked out."""
    pts = np.zeros((B, p, c), np.float32)
    pts[..., 0:2] = rng.uniform(-7.0, 7.0, (B, p, 2))
    pts[..., 2] = rng.uniform(-3.5, 1.5, (B, p))
    pts[..., 3:] = rng.uniform(0, 1, (B, p, c - 3))
    hot = rng.uniform(-6.0, 6.0, (B, 12, 2))
    k = p // 3
    pts[:, :k, 0:2] = hot[np.arange(B)[:, None], rng.randint(0, 12, (B, k))] \
        + rng.uniform(-0.1, 0.1, (B, k, 2))
    mask = np.ones((B, p), bool)
    mask[:, -50:] = False
    return pts, mask


def jax_voxelize(pts, mask, v_cap, t_cap):
    outs = [jvox.voxelize(jnp.asarray(pts[i]), jnp.asarray(mask[i]), PCR,
                          VOXEL, GRID, v_cap, t_cap) for i in range(B)]
    return {f: np.stack([np.asarray(getattr(o, f)) for o in outs])
            for f in outs[0]._fields}


@pytest.mark.parametrize("v_cap,t_cap", [(700, 32), (150, 6), (60, 1)])
def test_voxelize_matches_jax(v_cap, t_cap):
    """Bucket, coords, counts, masks and each point's slot exact; the
    smaller caps cut voxels (MAX_VOXELS) and points (T)."""
    pts, mask = scene(np.random.RandomState(v_cap))
    want = jax_voxelize(pts, mask, v_cap, t_cap)
    got = tvox.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), PCR,
                        VOXEL, GRID, v_cap, t_cap)
    for f in want:
        np.testing.assert_array_equal(getattr(got, f).numpy(), want[f],
                                      err_msg=f)
    total = len({tuple(c) for c in np.floor(
        (pts[0, mask[0], :3] - PCR[:3]) / VOXEL).astype(int)})
    if v_cap < 700:
        assert int(want["num_voxels"][0]) == v_cap < total
        assert (want["point_voxel_idx"][0][mask[0]] == -1).any()
    assert int(want["num_points"].max()) == t_cap


def test_dynamic_voxelize_and_mean_bucket_match_jax():
    pts, mask = scene(np.random.RandomState(5))
    got = tvox.dynamic_voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                                PCR, VOXEL, GRID, 200)
    for i in range(B):
        want = jvox.dynamic_voxelize(jnp.asarray(pts[i]),
                                     jnp.asarray(mask[i]), PCR, VOXEL, GRID,
                                     200)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    # the mean of voxelize_mean is the mean over voxelize's bucket
    bucket = tvox.voxelize(torch.from_numpy(pts), torch.from_numpy(mask), PCR,
                           VOXEL, GRID, 200, 8)
    mean = tvox.voxelize_mean(torch.from_numpy(pts), torch.from_numpy(mask),
                              PCR, VOXEL, GRID, 200, 8)
    ref = bucket.voxels.sum(2) / torch.clamp(
        bucket.num_points.float(), min=1)[..., None]
    np.testing.assert_allclose(mean.means.numpy(), ref.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(mean.coords.numpy(), bucket.coords.numpy())


# ---------------------------------------------------------------- VFEs

V_CAP, T_CAP = 700, 8


def vfe_batch(seed, c=4):
    pts, mask = scene(np.random.RandomState(seed), c=c)
    vox = jax_voxelize(pts, mask, V_CAP, T_CAP)
    return {"points": pts, "points_mask": mask, "voxels": vox["voxels"],
            "voxel_num_points": vox["num_points"],
            "voxel_coords": vox["coords"], "voxel_mask": vox["voxel_mask"]}


def random_variables(mod, jb, rng):
    shapes = jax.eval_shape(lambda b: mod.init(jax.random.PRNGKey(0), b,
                                               train=False), jb)

    def leaf(path, s):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        return (rng.standard_normal(s.shape) * 0.3).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


VFE_CASES = {
    "pillar": ("PillarVFE", {"NUM_FILTERS": [16]}),
    "pillar_two_layers_distance": (
        "PillarVFE", {"NUM_FILTERS": [16, 8], "WITH_DISTANCE": True}),
    "pillar_no_norm_no_abs": (
        "PillarVFE", {"NUM_FILTERS": [8, 16], "USE_NORM": False,
                      "USE_ABSLOTE_XYZ": False}),
    "dyn_pillar": ("DynPillarVFE", {"NUM_FILTERS": [16, 16]}),
    "dyn_pillar_distance_no_abs": (
        "DynPillarVFE", {"NUM_FILTERS": [8], "WITH_DISTANCE": True,
                         "USE_ABSLOTE_XYZ": False}),
    "dyn_simple2d": ("DynamicPillarVFESimple2D", {"NUM_FILTERS": [16, 8]}),
    "dyn_mean": ("DynMeanVFE", {}),
}


@pytest.mark.parametrize("case", list(VFE_CASES))
def test_vfe_matches_jax(case):
    """Eval (running BN statistics) and training (batch statistics: the
    output, the updated statistics and the gradients of a weighted sum)."""
    name, cfg = VFE_CASES[case]
    c = 5
    batch = vfe_batch(len(case), c)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    kw = dict(model_cfg=copy.deepcopy(cfg), num_point_features=c,
              voxel_size=VOXEL, point_cloud_range=PCR, grid_size=GRID)
    jmod = JAX_VFE[name](**kw)
    tmod = TORCH_VFE[name](copy.deepcopy(cfg), c, VOXEL, PCR, GRID)
    variables = random_variables(jmod, jb, np.random.RandomState(1))
    from_jax_variables(variables, tmod)
    key = "voxel_features" if name == "DynMeanVFE" else "pillar_features"
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    with jax.default_matmul_precision("highest"):
        want = jmod.apply(variables, dict(jb), train=False)[key]
    with torch.no_grad():
        got = tmod.eval()(dict(tb))[key]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert not batch["voxel_mask"].all()
    assert int(batch["voxel_num_points"].max()) == T_CAP
    if name == "DynMeanVFE":
        return

    proj = np.random.RandomState(2).standard_normal(
        np.asarray(want).shape).astype(np.float32)

    def loss_fn(params):
        out, mut = jmod.apply({**variables, "params": params}, dict(jb),
                              train=True, mutable=["batch_stats"])
        return jnp.sum(out[key] * proj), (out[key],
                                          mut.get("batch_stats", {}))

    with jax.default_matmul_precision("highest"):
        (_, (jout, jstats)), jgrad = jax.value_and_grad(
            loss_fn, has_aux=True)(variables["params"])
    tmod.train()
    tout = tmod(dict(tb))[key]
    (tout * torch.from_numpy(proj)).sum().backward()
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               **TOL)
    got_s, want_s = flat(to_jax_tree(tmod, "batch_stats")), flat(jstats)
    assert set(got_s) == set(want_s)
    for path, w in want_s.items():
        np.testing.assert_allclose(got_s[path], w, err_msg="/".join(path),
                                   **TOL)
    got_g, want_g = flat(to_jax_tree(tmod, "grad")), flat(jgrad)
    assert set(got_g) == set(want_g)
    for path, w in want_g.items():
        np.testing.assert_allclose(
            got_g[path], w, rtol=1e-4, atol=1e-4 * float(np.abs(w).max()),
            err_msg="/".join(path))


def test_point_pillar_scatter_matches_jax():
    batch = vfe_batch(9)
    feats = np.random.RandomState(3).standard_normal(
        (B, V_CAP, 6)).astype(np.float32)
    cfg = {"NUM_BEV_FEATURES": 6}
    jb = {"pillar_features": jnp.asarray(feats),
          "voxel_coords": jnp.asarray(batch["voxel_coords"]),
          "voxel_mask": jnp.asarray(batch["voxel_mask"])}
    want = PointPillarScatter(model_cfg=cfg, grid_size=GRID).apply(
        {}, jb, train=False)["spatial_features"]
    got = TorchScatter(cfg, GRID)({k: torch.from_numpy(np.array(v))
                                   for k, v in jb.items()})[
        "spatial_features"]
    assert not batch["voxel_mask"].all()
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))
