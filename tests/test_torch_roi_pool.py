"""ROI-aware voxel pooling and ROI point pooling of the PyTorch port
(findnpropagate_torch/ops/roi_pool.py) against the JAX package
(findnpropagate_tpu/ops/roi_pool.py, vmapped over the batch) and against
per-ROI numpy oracles built on tests/oracles.py's points_in_box, on the
same numpy-seeded scenes: ROIs around point clusters, rotated, one far
from every point (empty), one over masked-out points only, and padded
points; max pooling with tied features (the gradient splits evenly among
equal maxima, as the reference's scatter-max does); the chunked pooling
(one ROI a chunk) equal to the unchunked one.

Tolerances: indices, counts and empty flags exact; max-pooled features
and point-pooled rows bit-equal (selections of the inputs); avg pooling
and gradients 1e-6 (float32 sums in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.ops import roi_pool as trp
from findnpropagate_tpu.ops import roi_pool as jrp
from oracles import points_in_box

B = 2
OUT = (3, 4, 2)


def scene(seed, p=600, c=5, ties=False):
    rng = np.random.RandomState(seed)
    centres = np.array([[0, 0, 0], [5, 5, 0.5], [-4, 3, -0.5]], np.float32)
    rois = np.zeros((B, 6, 7), np.float32)
    pts = np.zeros((B, p, 3), np.float32)
    for b in range(B):
        pts[b] = centres[rng.randint(0, 3, p)] + rng.randn(p, 3) * 1.3
        for r in range(4):
            k = r % 3
            rois[b, r, :3] = centres[k] + rng.randn(3) * 0.3
            rois[b, r, 3:6] = rng.uniform(1.5, 4.0, 3)
            rois[b, r, 6] = rng.uniform(-np.pi, np.pi)
        rois[b, 4] = [40, 40, 0, 2, 2, 2, 0.1]          # no point inside
        rois[b, 5] = [20, 20, 0, 2, 2, 2, 0.0]          # masked points only
        pts[b, -20:] = np.array([20, 20, 0]) + rng.uniform(-0.5, 0.5, (20, 3))
    mask = np.ones((B, p), bool)
    mask[:, -20:] = False
    mask[1, :50] = False
    feats = rng.randn(B, p, c).astype(np.float32)
    if ties:
        feats = np.round(feats)             # many equal values per cell
    return rois, pts.astype(np.float32), feats, mask


def t(x):
    return torch.from_numpy(np.array(x))


def aware_oracle(roi, pts, feats, mask, out, pool):
    """The pooled cells of one ROI: inside by oracles.points_in_box, the
    reference's clamped cell index, 0 in empty cells."""
    ox, oy, oz = out
    res = np.zeros((ox, oy, oz, feats.shape[1]), np.float32)
    cnt = np.zeros((ox, oy, oz), np.int32)
    c, s = np.cos(-roi[6]), np.sin(-roi[6])
    inside = points_in_box(pts, roi) & mask
    for p, f in zip(pts[inside], feats[inside]):
        sh = p - roi[:3]
        lx, ly = sh[0] * c - sh[1] * s, sh[0] * s + sh[1] * c
        cell = tuple(min(max(int((v + d / 2) / (d / n)), 0), n - 1)
                     for v, d, n in ((lx, roi[3], ox), (ly, roi[4], oy),
                                     (sh[2], roi[5], oz)))
        if pool == "max":
            res[cell] = f if cnt[cell] == 0 else np.maximum(res[cell], f)
        else:
            res[cell] += f
        cnt[cell] += 1
    if pool == "avg":
        res = res / np.maximum(cnt[..., None], 1)
    return res


def jax_aware(rois, pts, feats, mask, pool):
    return jax.vmap(lambda r, p, f, m: jrp.roiaware_pool3d(
        r, p, f, m, out_size=OUT, pool=pool))(
            jnp.asarray(rois), jnp.asarray(pts), jnp.asarray(feats),
            jnp.asarray(mask))


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_roiaware_pool_matches_jax_and_oracle(pool):
    rois, pts, feats, mask = scene(0)
    got = trp.roiaware_pool3d(t(rois), t(pts), t(feats), t(mask), OUT, pool)
    want = np.asarray(jax_aware(rois, pts, feats, mask, pool))
    assert got.shape == want.shape == (B, 6) + OUT + (5,)
    tol = 0 if pool == "max" else 1e-6
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    for b in range(B):
        for r in range(6):
            np.testing.assert_allclose(
                got[b, r].numpy(), aware_oracle(rois[b, r], pts[b], feats[b],
                                                mask[b], OUT, pool),
                rtol=1e-6, atol=1e-6, err_msg=f"{pool} sample {b} roi {r}")
    # the far ROI and the one over masked points pool nothing
    assert float(got[:, 4:].abs().sum()) == 0.0
    assert float(got[:, :4].abs().sum()) > 0


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_roiaware_pool_gradient_matches_jax(pool):
    """With tied features in a cell the max's gradient is shared evenly
    among them in both packages."""
    rois, pts, feats, mask = scene(1, ties=True)
    w = np.random.RandomState(2).randn(B, 6, *OUT, 5).astype(np.float32)
    want = np.asarray(jax.grad(lambda f: jnp.sum(jax_aware(
        rois, pts, f, mask, pool) * w))(jnp.asarray(feats)))
    f = t(feats).requires_grad_()
    (trp.roiaware_pool3d(t(rois), t(pts), f, t(mask), OUT, pool)
     * t(w)).sum().backward()
    np.testing.assert_allclose(f.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    assert np.abs(want).sum() > 0
    if pool == "max":
        # some gradient entries are shares of a tie
        assert np.any(np.abs(want[np.abs(want) > 0]) < np.abs(w).max() / 1.9)


def test_pools_chunked_equal_unchunked():
    rois, pts, feats, mask = scene(3)
    args = (t(rois), t(pts), t(feats), t(mask))
    for pool in ("max", "avg"):
        whole = trp.roiaware_pool3d(*args, OUT, pool)
        one = trp.roiaware_pool3d(*args, OUT, pool, chunk_elems=1)
        two = trp.roiaware_pool3d(*args, OUT, pool,
                                  chunk_elems=2 * pts.shape[1])
        assert torch.equal(whole, one) and torch.equal(whole, two)
    whole = trp.roipoint_pool3d(*args, 16)
    one = trp.roipoint_pool3d(*args, 16, chunk_elems=1)
    assert torch.equal(whole[0], one[0]) and torch.equal(whole[1], one[1])


@pytest.mark.parametrize("num_sampled", [16, 200])
def test_roipoint_pool_matches_jax_and_oracle(num_sampled):
    rois, pts, feats, mask = scene(4)
    pooled, empty = trp.roipoint_pool3d(t(rois), t(pts), t(feats), t(mask),
                                        num_sampled)
    jp, je = jax.vmap(lambda r, p, f, m: jrp.roipoint_pool3d(
        r, p, f, m, num_sampled=num_sampled))(
            jnp.asarray(rois), jnp.asarray(pts), jnp.asarray(feats),
            jnp.asarray(mask))
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(empty.numpy(), np.asarray(je))
    assert empty[:, 4:].all() and not empty[:, :4].any()
    for b in range(B):
        for r in range(6):
            idx = np.flatnonzero(points_in_box(pts[b], rois[b, r])
                                 & mask[b])[:num_sampled]
            want = np.zeros((num_sampled, 3 + feats.shape[2]), np.float32)
            want[:len(idx)] = np.concatenate([pts[b, idx], feats[b, idx]], 1)
            np.testing.assert_array_equal(pooled[b, r].numpy(), want)
    # 200 slots outnumber some ROIs' points: zero tails
    if num_sampled == 200:
        assert (pooled[:, :4].abs().sum(-1) == 0).any()
