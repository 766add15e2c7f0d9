"""The dense-z pillar conv of the PyTorch port (ops/zdense.py) against the
JAX package's on tests/test_zdense.py's random sparse scenes (pillar
capacity padding, empty pillars, grid-border neighbourhoods), and against
the port's own gather-mode `subm_conv`: the pillarize / depillarize round
trip and its slabs bit for bit, `make_zband`, `zdense_subm` in float32
and bfloat16, and `zdense_downsample` (output pillars, masks and
features).

Tolerances: ids, coords, masks and round-tripped features exact;
features 1e-4 (float32 sums in another order); bfloat16 inputs 1e-4 as
both packages multiply in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.ops import sparse_ops as tso
from findnpropagate_torch.ops import zdense as tz
from findnpropagate_tpu.ops import zdense as jz
from test_zdense import SHAPE, scene

TOL = 1e-4


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=msg)


def both_pillars(coords, valid, feats, cap, shape=SHAPE):
    nz = shape[0]
    got = tz.pillarize(t(coords), t(valid), t(feats), shape, cap, nz)
    want = jz.pillarize(jnp.asarray(coords), jnp.asarray(valid),
                        jnp.asarray(feats), shape, cap, nz)
    return got, want


@pytest.mark.parametrize("cap", [64, 256])
def test_pillarize_and_depillarize_match_jax_and_round_trip(cap):
    coords, valid, feats = scene(v=200, seed=5)
    got, want = both_pillars(coords, valid, feats, cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    ids3, coords3, valid3, feats3 = tz.depillarize(got[0], got[2], got[3],
                                                   got[4], SHAPE, SHAPE[0])
    jout = jz.depillarize(*(jnp.asarray(want[i]) for i in (0, 2, 3, 4)),
                          SHAPE, SHAPE[0])
    for g, w in zip((ids3, coords3, valid3, feats3), jout):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if cap == 256:
        # every valid voxel exactly once, its features unchanged
        kept = {tuple(c): f for c, v, f in zip(coords3.numpy(),
                                               valid3.numpy(),
                                               feats3.numpy()) if v}
        want_set = {tuple(c): f for c, v, f in zip(coords, valid, feats)
                    if v}
        assert kept.keys() == want_set.keys()
        for k, f in want_set.items():
            np.testing.assert_array_equal(kept[k], f)
    else:
        assert bool(got[2].all())        # the capacity cuts pillars


@pytest.mark.parametrize("stride,zc", [(1, 4), (2, 2)])
def test_zband_weight_matches_jax(stride, zc):
    w = np.random.RandomState(1).standard_normal((3, 4, 5)).astype(
        np.float32)
    got = tz.make_zband(t(w), zc, stride)
    if stride == 1:
        want = jz.make_zband(jnp.asarray(w), zc)
    else:
        want = np.zeros(((2 * zc + 1) * 4, zc * 5), np.float32)
        for j in range(zc):
            for dz in range(3):
                want[(2 * j + dz) * 4:(2 * j + dz + 1) * 4,
                     j * 5:(j + 1) * 5] = w[dz]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,dtype", [(0, "float32"), (3, "float32"),
                                        (7, "bfloat16")])
def test_zdense_subm_matches_jax_and_the_gather_conv(seed, dtype):
    nz = SHAPE[0]
    c, cout = 16, 24
    coords, valid, feats = scene(v=400, c=c, seed=seed)
    w = np.random.RandomState(100 + seed).standard_normal(
        (27, c, cout)).astype(np.float32) * 0.2
    (ids2, coords2, pvalid, pfeats, pmask), jp = both_pillars(
        coords, valid, feats, 512)
    tdt = getattr(torch, dtype)
    got = tz.zdense_subm(ids2, pfeats.to(tdt), pmask, pvalid,
                         t(w).to(tdt), SHAPE, nz, c, zc=4)
    want = jz.zdense_subm(jp[0], jp[3].astype(dtype), jp[4], jp[2],
                          jnp.asarray(w).astype(dtype), SHAPE, nz, c, zc=4)
    assert got.dtype == torch.float32
    close(got, want)
    # the port's gather-mode submanifold conv on the voxel list
    grid = tso.build_grid(t(coords)[None], t(valid)[None], SHAPE)
    ref = tso.subm_conv(grid, t(feats)[None].to(tdt).float(),
                        t(w).to(tdt).float())[0]
    g = got.reshape(-1, nz, cout)
    c2, pv = coords2.numpy(), pvalid.numpy()
    row = {tuple(c2[p]): p for p in range(len(pv)) if pv[p]}
    for i, (z, y, x) in enumerate(coords):
        if valid[i]:
            close(g[row[(y, x)], z], ref[i], msg=f"voxel {i}")


@pytest.mark.parametrize("cap", [48, 256])
def test_zdense_downsample_matches_jax(cap):
    nz, ny, nx = SHAPE
    c, cout = 16, 32
    coords, valid, feats = scene(v=350, seed=9)
    w = np.random.RandomState(21).standard_normal((27, c, cout)).astype(
        np.float32) * 0.2
    out_shape = ((nz + 2 - 3) // 2 + 1, (ny + 2 - 3) // 2 + 1,
                 (nx + 2 - 3) // 2 + 1)
    (ids2, coords2, pvalid, pfeats, pmask), jp = both_pillars(
        coords, valid, feats, 256)
    got = tz.zdense_downsample(ids2, coords2, pfeats, pmask, pvalid, t(w),
                               SHAPE, out_shape, nz, out_shape[0], c, cap,
                               zc=2)
    want = jz.zdense_downsample(jp[0], jp[1], jp[3], jp[4], jp[2],
                                jnp.asarray(w), SHAPE, out_shape, nz,
                                out_shape[0], c, cap, zc=2)
    for i in (0, 1, 2, 4):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    close(got[3], want[3])
    assert int(got[2].sum()) == min(cap, int(np.asarray(want[2]).sum()))


def test_profile_zdense_on_the_cpu(capsys):
    """The port's profile_zdense on a small scene of its grid: the dense-z
    conv and K3's plain version agree on every active voxel, K3's window
    drops nothing, nothing is timed on the CPU."""
    from findnpropagate_torch.tools import profile_zdense

    assert profile_zdense.main(["--device", "cpu", "--v", "6000",
                                "--pillars", "4096"]) == 0
    out = capsys.readouterr().out
    assert "K3 overflow 0" in out and "not measured" in out
