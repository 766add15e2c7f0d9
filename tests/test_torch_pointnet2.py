"""The PointNet++ ops of the PyTorch port (findnpropagate_torch/ops/
pointnet2.py) against the JAX package's on the same numpy-seeded inputs,
after tests/test_pointnet2_ops.py's first four cases (its ROI-pool cases
belong to a later slice), and against brute-force oracles.

Tolerances: FPS and ball-query indices and counts exact (integers);
three_nn's indices exact and its distances, three_interpolate and
query_and_group within 1e-5. The chunked ball query (the port's memory
bound on the centers x points block) equals the unchunked one exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.ops import pointnet2 as tp
from findnpropagate_tpu.ops import pointnet2 as jp
from test_pointnet2_ops import fps_oracle


def t(x):
    return torch.from_numpy(np.asarray(x))


def scene(seed, b=2, p=300, m=40, spread=1.0):
    """Batched points (B, P, 3) with a padded tail, centers near points."""
    rng = np.random.RandomState(seed)
    pts = (rng.randn(b, p, 3) * spread).astype(np.float32)
    pmask = np.ones((b, p), bool)
    pmask[0, p - 50:] = False
    pmask[1, :7] = False
    ctr = (pts[:, :m] + rng.randn(b, m, 3).astype(np.float32) * 0.3)
    cmask = np.ones((b, m), bool)
    cmask[1, -5:] = False
    return pts, pmask, ctr.astype(np.float32), cmask


@pytest.mark.parametrize("k", [1, 32, 120])
def test_fps_matches_jax_and_oracle(k):
    pts, pmask, _, _ = scene(0)
    got = tp.farthest_point_sample(t(pts), t(pmask), k).numpy()
    for i in range(len(pts)):
        want = np.asarray(jp.farthest_point_sample(
            jnp.asarray(pts[i]), jnp.asarray(pmask[i]), k))
        np.testing.assert_array_equal(got[i], want)
        np.testing.assert_array_equal(got[i], fps_oracle(pts[i], pmask[i],
                                                          k))
    assert pmask[0][got[0]].all()


def test_fps_with_fewer_valid_points_than_k():
    """Fewer valid points than k (and none): indices repeat as the
    reference's argmax over -INF / 0 distances gives them."""
    pts, pmask, _, _ = scene(3, p=40)
    pmask[0, 5:] = False
    pmask[1] = False
    got = tp.farthest_point_sample(t(pts), t(pmask), 12).numpy()
    for i in range(2):
        want = np.asarray(jp.farthest_point_sample(
            jnp.asarray(pts[i]), jnp.asarray(pmask[i]), 12))
        np.testing.assert_array_equal(got[i], want)


@pytest.mark.parametrize("radius,nsample", [(0.8, 8), (1.5, 16), (0.2, 4)])
def test_ball_query_matches_jax(radius, nsample):
    pts, pmask, ctr, cmask = scene(1)
    idx, cnt = tp.ball_query(t(ctr), t(cmask), t(pts), t(pmask), radius,
                             nsample)
    for i in range(len(pts)):
        wi, wc = jp.ball_query(jnp.asarray(ctr[i]), jnp.asarray(cmask[i]),
                               jnp.asarray(pts[i]), jnp.asarray(pmask[i]),
                               radius, nsample)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(wi))
        np.testing.assert_array_equal(cnt[i].numpy(), np.asarray(wc))
    # the scene holds partial balls, and full ones at the larger radius
    assert ((cnt > 0) & (cnt < nsample)).any()
    assert (cnt == nsample).any() or radius < 1.0


def test_ball_query_first_k_and_backfill():
    """The reference's case: the first nsample in-radius indices in point
    order, the empty slots back-filled with the first."""
    rng = np.random.RandomState(1)
    pts = rng.randn(1, 100, 3).astype(np.float32)
    ctr = pts[:, :5] + 0.01
    idx, cnt = tp.ball_query(t(ctr), torch.ones(1, 5, dtype=torch.bool),
                             t(pts), torch.ones(1, 100, dtype=torch.bool),
                             0.8, 8)
    for i in range(5):
        d = np.linalg.norm(ctr[0, i] - pts[0], axis=-1)
        within = np.where(d < 0.8)[0]
        n = min(len(within), 8)
        assert int(cnt[0, i]) == n
        np.testing.assert_array_equal(idx[0, i, :n].numpy(), within[:n])
        np.testing.assert_array_equal(idx[0, i, n:].numpy(),
                                      np.full(8 - n, within[0]))


def test_ball_query_empty_center():
    pts = torch.zeros(1, 10, 3)
    ctr = torch.full((1, 1, 3), 100.0)
    ones = torch.ones(1, 10, dtype=torch.bool)
    idx, cnt = tp.ball_query(ctr, ones[:, :1], pts, ones, 0.5, 4)
    assert int(cnt[0, 0]) == 0 and (idx == 0).all()
    g, _ = tp.query_and_group(ctr, ones[:, :1], pts, ones,
                              torch.ones(1, 10, 2), 0.5, 4)
    assert (g == 0).all()


@pytest.mark.parametrize("chunk_elems", [1, 300, 4999, 300 * 17])
def test_chunked_ball_query_equals_unchunked(chunk_elems):
    """Chunks of one center, of a center per block of 300 points, and
    blocks that do not divide the centers: the same indices and counts."""
    pts, pmask, ctr, cmask = scene(2)
    whole = tp.ball_query(t(ctr), t(cmask), t(pts), t(pmask), 1.2, 16,
                          chunk_elems=1 << 30)
    part = tp.ball_query(t(ctr), t(cmask), t(pts), t(pmask), 1.2, 16,
                         chunk_elems=chunk_elems)
    for a, b in zip(whole, part):
        assert torch.equal(a, b)


def test_three_nn_and_interpolate_match_jax():
    rng = np.random.RandomState(2)
    known = rng.randn(2, 50, 3).astype(np.float32)
    unknown = rng.randn(2, 20, 3).astype(np.float32)
    kmask = np.ones((2, 50), bool)
    kmask[1, ::3] = False
    feats = rng.randn(2, 50, 4).astype(np.float32)
    dist, idx = tp.three_nn(t(unknown), torch.ones(2, 20, dtype=torch.bool),
                            t(known), t(kmask))
    out = tp.three_interpolate(t(feats), idx, dist)
    for i in range(2):
        wd, wi = jp.three_nn(jnp.asarray(unknown[i]), jnp.ones(20, bool),
                             jnp.asarray(known[i]), jnp.asarray(kmask[i]))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(wi))
        np.testing.assert_allclose(dist[i].numpy(), np.asarray(wd),
                                   rtol=1e-5, atol=1e-5)
        wo = jp.three_interpolate(jnp.asarray(feats[i]), wi, wd)
        np.testing.assert_allclose(out[i].numpy(), np.asarray(wo),
                                   rtol=1e-5, atol=1e-5)
        assert kmask[i][idx[i].numpy()].all()


@pytest.mark.parametrize("with_feats,use_xyz", [(True, True), (True, False),
                                                (False, True)])
def test_query_and_group_matches_jax(with_feats, use_xyz):
    pts, pmask, ctr, cmask = scene(4)
    rng = np.random.RandomState(5)
    feats = rng.randn(*pts.shape[:2], 5).astype(np.float32) \
        if with_feats else None
    got, cnt = tp.query_and_group(t(ctr), t(cmask), t(pts), t(pmask),
                                  None if feats is None else t(feats), 0.9,
                                  8, use_xyz=use_xyz)
    for i in range(len(pts)):
        want, wc = jp.query_and_group(
            jnp.asarray(ctr[i]), jnp.asarray(cmask[i]), jnp.asarray(pts[i]),
            jnp.asarray(pmask[i]),
            None if feats is None else jnp.asarray(feats[i]), 0.9, 8,
            use_xyz=use_xyz)
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(cnt[i].numpy(), np.asarray(wc))
