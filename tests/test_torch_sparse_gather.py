"""The gather-mode and XLA-windowed sparse ops of the port
(findnpropagate_torch/ops/sparse_ops.py) against the JAX package's
(findnpropagate_tpu/ops/sparse_ops.py), on numpy-seeded inputs.

The JAX side runs single samples through jax.vmap, as its backbone does.
Tolerances: active sets, tables, ids, coordinates and overflow counts
exact; conv outputs 1e-5 absolute and relative (both sides multiply in
float32 at full precision and sum the 27 * Cin products in a different
order); batch statistics 1e-6. The reference's own oracle cases
(tests/test_sparse_ops.py, marked slow there) run here without the mark
through its helpers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import findnpropagate_torch.ops.sparse_ops as T
import findnpropagate_tpu.ops.sparse_ops as J
from test_sparse_ops import SHAPE, dense_conv3d, random_sparse

CASES = [  # kernel, stride, padding, max_out
    ((3, 3, 3), (2, 2, 2), (1, 1, 1), 96),
    ((3, 3, 3), (2, 2, 2), (0, 1, 1), 96),
    ((3, 1, 1), (2, 1, 1), (0, 0, 0), 128),
    ((3, 3, 3), (2, 2, 2), (1, 1, 1), 16),   # max_out overflow
]


def out_shape_of(kernel, stride, padding, shape=SHAPE):
    return tuple((n + 2 * p - k) // s + 1
                 for n, k, s, p in zip(shape, kernel, stride, padding))


def batch_sparse(seed, b=2, n_active=70, v_cap=96, cin=4):
    rng = np.random.RandomState(seed)
    parts = [random_sparse(rng, n_active - 9 * i, v_cap, cin)
             for i in range(b)]
    # the voxelizer's order is not sorted: shuffle the active rows
    for c, v, f in parts:
        p = rng.permutation(v_cap)
        c[:], v[:], f[:] = c[p], v[p], f[p]
    return [np.stack(x) for x in zip(*parts)]


def grids(coords, valid, shape):
    jg = jax.vmap(lambda c, v: J.build_grid(c, v, shape))(
        jnp.asarray(coords), jnp.asarray(valid))
    tg = T.build_grid(torch.from_numpy(coords), torch.from_numpy(valid),
                      shape)
    return jg, tg


def test_build_grid_table_matches_jax():
    coords, valid, _ = batch_sparse(0)
    coords[0, 3] = [SHAPE[0], 0, 0]          # outside the grid
    jg, tg = grids(coords, valid, SHAPE)
    np.testing.assert_array_equal(tg.table.numpy(), np.asarray(jg.table))
    np.testing.assert_array_equal(tg.valid.numpy(), np.asarray(jg.valid))
    lin, inside = T.linear_id(torch.from_numpy(coords), SHAPE)
    jl, ji = jax.vmap(lambda c: J.linear_id(c, SHAPE))(jnp.asarray(coords))
    np.testing.assert_array_equal(lin.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(inside.numpy(), np.asarray(ji))


@pytest.mark.parametrize("kernel,bias", [((3, 3, 3), False),
                                         ((3, 3, 3), True),
                                         ((1, 1, 1), True),
                                         ((3, 1, 1), False)])
def test_subm_conv_matches_jax(kernel, bias):
    coords, valid, feats = batch_sparse(1)
    rng = np.random.RandomState(2)
    k = int(np.prod(kernel))
    w = rng.randn(k, 4, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32) if bias else None
    jg, tg = grids(coords, valid, SHAPE)
    want = jax.vmap(lambda g, f: J.subm_conv(
        g, f, jnp.asarray(w), None if b is None else jnp.asarray(b),
        kernel_size=kernel))(jg, jnp.asarray(feats))
    got = T.subm_conv(tg, torch.from_numpy(feats), torch.from_numpy(w),
                      None if b is None else torch.from_numpy(b),
                      kernel_size=kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_subm_conv_matches_dense_oracle():
    """The reference's oracle (test_sparse_ops.py::
    test_subm_conv_matches_dense): a dense conv of the densified volume,
    read at the active sites."""
    rng = np.random.RandomState(0)
    coords, valid, feats = random_sparse(rng, 60, 80, 4)
    w = rng.randn(27, 4, 6).astype(np.float32)
    tg = T.build_grid(torch.from_numpy(coords[None]),
                      torch.from_numpy(valid[None]), SHAPE)
    got = T.subm_conv(tg, torch.from_numpy(feats[None]),
                      torch.from_numpy(w))[0].numpy()
    dense = T.sparse_to_dense(tg, torch.from_numpy(feats[None]))
    dense = dense[0].permute(1, 2, 3, 0).numpy()
    want = dense_conv3d(jnp.asarray(dense), jnp.asarray(w))
    c = coords[valid]
    np.testing.assert_allclose(got[valid], want[c[:, 0], c[:, 1], c[:, 2]],
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_downsample_and_strided_conv_match_jax(case):
    kernel, stride, padding, max_out = CASES[case]
    out_shape = out_shape_of(kernel, stride, padding)
    coords, valid, feats = batch_sparse(3 + case)
    w = np.random.RandomState(4).randn(int(np.prod(kernel)), 4, 5).astype(
        np.float32)
    b = np.linspace(-1, 1, 5).astype(np.float32)
    jg, tg = grids(coords, valid, SHAPE)
    kw = dict(kernel_size=kernel, stride=stride, padding=padding)
    joc, jov = jax.vmap(lambda g: J.downsample_active_set(
        g, out_shape, max_out, **kw))(jg)
    toc, tov = T.downsample_active_set(tg, out_shape, max_out, **kw)
    np.testing.assert_array_equal(toc.numpy(), np.asarray(joc))
    np.testing.assert_array_equal(tov.numpy(), np.asarray(jov))

    jgo = jax.vmap(lambda c, v: J.build_grid(c, v, out_shape))(joc, jov)
    tgo = T.build_grid(toc, tov, out_shape)
    want = jax.vmap(lambda gi, f, go: J.strided_conv(
        gi, f, go, jnp.asarray(w), jnp.asarray(b), **kw))(
            jg, jnp.asarray(feats), jgo)
    got = T.strided_conv(tg, torch.from_numpy(feats), tgo,
                         torch.from_numpy(w), torch.from_numpy(b), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_sparse_to_dense_and_stats_match_jax():
    coords, valid, feats = batch_sparse(5)
    jg, tg = grids(coords, valid, SHAPE)
    want = jax.vmap(J.sparse_to_dense)(jg, jnp.asarray(feats))
    got = T.sparse_to_dense(tg, torch.from_numpy(feats))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 4, 1).numpy(),
                                  np.asarray(want))
    mean, var = J.masked_batch_stats(jnp.asarray(feats[0]),
                                     jnp.asarray(valid[0]))
    tm, tv = T.masked_batch_stats(torch.from_numpy(feats[0]),
                                  torch.from_numpy(valid[0]))
    np.testing.assert_allclose(tm.numpy(), np.asarray(mean), atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(var), atol=1e-6)


def sorted_win(coords, valid, feats, shape, block):
    """Per sample: sorted by yxz id, padded to a block multiple with
    ascending sentinel ids (the backbone's windowed entry)."""
    ids = np.asarray(jax.vmap(lambda c, v: J.yxz_linear_ids(c, v, shape))(
        jnp.asarray(coords), jnp.asarray(valid)))
    order = np.argsort(ids, axis=1)
    take = lambda a: np.take_along_axis(  # noqa: E731
        a, order.reshape(order.shape + (1,) * (a.ndim - 2)), axis=1)
    ids, coords, valid, feats = take(ids), take(coords), take(valid), \
        take(feats)
    pad = (-ids.shape[1]) % block
    start = np.maximum(ids[:, -1:] + 1, J.yxz_sentinel_start(shape))
    ids = np.concatenate([ids, start + np.arange(pad)], axis=1)
    coords = np.pad(coords, ((0, 0), (0, pad), (0, 0)), constant_values=-1)
    valid = np.pad(valid, ((0, 0), (0, pad)))
    feats = np.pad(feats, ((0, 0), (0, pad), (0, 0)))
    return ids.astype(np.int32), coords, valid, feats


@pytest.mark.parametrize("window", [128, 24])
def test_subm_conv_windowed_matches_jax(window):
    """Window 128 is exact (overflow 0) and equals the gather path; window
    24 overflows: the port counts the same (block, tap) pairs and drops the
    same neighbours."""
    coords, valid, feats = batch_sparse(6, n_active=90, v_cap=100)
    ids, sc, sv, sf = sorted_win(coords, valid, feats, SHAPE, 32)
    w = np.random.RandomState(7).randn(27, 4, 5).astype(np.float32)
    deltas = J.yxz_offset_deltas((3, 3, 3), SHAPE)
    want, jovf = jax.vmap(lambda i, f: J.subm_conv_windowed(
        i, f, jnp.asarray(w), jnp.asarray(deltas), block=32, window=window,
        precision=jax.lax.Precision.HIGHEST))(jnp.asarray(ids),
                                              jnp.asarray(sf))
    got, tovf = T.subm_conv_windowed(
        torch.from_numpy(ids), torch.from_numpy(sf), torch.from_numpy(w),
        T.yxz_offset_deltas((3, 3, 3), SHAPE), block=32, window=window)
    np.testing.assert_array_equal(tovf.numpy(), np.asarray(jovf))
    assert (tovf.sum() == 0) == (window == 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    if window == 128:
        tg = T.build_grid(torch.from_numpy(sc), torch.from_numpy(sv), SHAPE)
        gather = T.subm_conv(tg, torch.from_numpy(sf), torch.from_numpy(w))
        np.testing.assert_allclose(got.numpy() * sv[..., None],
                                   gather.numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("window", [128, 20])
def test_windowed_strided_conv_matches_jax(window):
    """The strided conv in windowed form (outputs mapped into the input id
    space, sentinel targets excluded from the spans) against the JAX
    windowed_conv, exact and overflowing."""
    kernel, stride, padding = (3, 3, 3), (2, 2, 2), (1, 1, 1)
    out_shape = out_shape_of(kernel, stride, padding)
    coords, valid, feats = batch_sparse(8, n_active=90, v_cap=128)
    ids, sc, sv, sf = sorted_win(coords, valid, feats, SHAPE, 32)
    oi, oc, ov = T.win_downsample(torch.from_numpy(sc), torch.from_numpy(sv),
                                  SHAPE, out_shape, 64)
    base = T.strided_base_ids(oc, ov, stride, SHAPE, out_shape)
    deltas = T.strided_deltas(kernel, stride, padding, SHAPE)
    sent = T.strided_sentinel_start(SHAPE)
    w = np.random.RandomState(9).randn(27, 4, 6).astype(np.float32)
    want, jovf = jax.vmap(lambda si, sf_, ti: J.windowed_conv(
        si, sf_, ti, jnp.asarray(w), jnp.asarray(deltas), block=32,
        window=window, precision=jax.lax.Precision.HIGHEST,
        sentinel_start=sent))(jnp.asarray(ids), jnp.asarray(sf),
                              jnp.asarray(base.numpy()))
    got, tovf = T.windowed_conv(
        torch.from_numpy(ids), torch.from_numpy(sf), base,
        torch.from_numpy(w), deltas, block=32, window=window,
        sentinel_start=sent)
    np.testing.assert_array_equal(tovf.numpy(), np.asarray(jovf))
    assert (tovf.sum() == 0) == (window == 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_windowed_conv_gradients_match_jax():
    """The XLA windowed conv is trained through autodiff in the reference:
    its feature and weight gradients against the port's autograd."""
    coords, valid, feats = batch_sparse(10, n_active=80, v_cap=96)
    ids, _, _, sf = sorted_win(coords, valid, feats, SHAPE, 32)
    w = np.random.RandomState(11).randn(27, 4, 5).astype(np.float32)
    g = np.random.RandomState(12).randn(*sf.shape[:2], 5).astype(np.float32)
    deltas = J.yxz_offset_deltas((3, 3, 3), SHAPE)

    def loss(f, wt):
        out, _ = jax.vmap(lambda i, f_: J.subm_conv_windowed(
            i, f_, wt, jnp.asarray(deltas), block=32, window=128,
            precision=jax.lax.Precision.HIGHEST))(jnp.asarray(ids), f)
        return jnp.sum(out * jnp.asarray(g))

    jf, jw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(sf), jnp.asarray(w))
    tf = torch.from_numpy(sf).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    out, _ = T.subm_conv_windowed(torch.from_numpy(ids), tf, tw,
                                  T.yxz_offset_deltas((3, 3, 3), SHAPE),
                                  block=32, window=128)
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_win_downsample_scatter_matches_jax(case):
    """As test_sparse_ops.py::test_win_downsample_scatter_matches_sort: the
    sort-free build equals the JAX scatter build and the sort build."""
    kernel, stride, padding, max_out = CASES[case]
    out_shape = out_shape_of(kernel, stride, padding)
    coords, valid, _ = batch_sparse(13 + case, cin=1)
    kw = dict(kernel_size=kernel, stride=stride, padding=padding)
    ji, jc, jv = jax.vmap(lambda c, v: J.win_downsample_scatter(
        c, v, SHAPE, out_shape, max_out, sel_block=64, **kw))(
            jnp.asarray(coords), jnp.asarray(valid))
    args = (torch.from_numpy(coords), torch.from_numpy(valid), SHAPE,
            out_shape, max_out)
    gi, gc, gv = T.win_downsample_scatter(*args, **kw)
    si, sc, sv = T.win_downsample(*args, **kw)
    for got in ((gi, gc, gv), (si, sc, sv)):
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(jv))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(jc))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ji))
