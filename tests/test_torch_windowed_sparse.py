"""ops/windowed_sparse.py (K3 union-window conv, K4 weight gradient, the
overflow count, the differentiable WindowedConv) against the JAX
package's Pallas kernels run in interpret mode at float32, on the case
generator of tests/test_pallas_sparse.py plus a strided (source != target)
case built with the port's own level bookkeeping.

On the CPU the port's wrappers run the plain PyTorch versions (the CUDA
kernels are held against those on the card by chip_smoke.py). Tolerances
are the JAX tests' own: rtol/atol 1e-4 forward, 2e-3 gradients (f32 on both
sides, different summation orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.ops import sparse_ops as so
from findnpropagate_torch.ops import windowed_sparse as ws
from findnpropagate_tpu.ops.pallas_sparse import (
    windowed_conv_pallas,
    windowed_conv_pallas_diff,
    windowed_dw_pallas,
    windowed_overflow,
)

BLOCK = 512


def make_case(seed=0, n_active=1500, shape=(9, 64, 64), c_in=8, c_out=16):
    """tests/test_pallas_sparse.py's generator, in numpy: unique active
    cells sorted by guard-banded id, padded to a block multiple with
    ascending ids above the last."""
    rng = np.random.RandomState(seed)
    nz, ny, nx = shape
    lin = rng.choice(nz * ny * nx, n_active, replace=False)
    coords = np.stack([lin % nz, (lin // nz) % ny, lin // (nz * ny)],
                      1).astype(np.int32)
    ids = so.yxz_linear_ids(torch.from_numpy(coords)[None],
                            torch.ones(1, n_active, dtype=torch.bool),
                            shape)[0].numpy()
    order = np.argsort(ids)
    ids, coords = ids[order], coords[order]
    feats = rng.standard_normal((n_active, c_in)).astype(np.float32)
    pad = (-n_active) % BLOCK
    ids = np.concatenate([ids, ids[-1] + 1 + np.arange(pad)]).astype(np.int32)
    feats = np.concatenate([feats, np.zeros((pad, c_in), np.float32)])
    w = rng.standard_normal((27, c_in, c_out)).astype(np.float32) * 0.1
    deltas = so.yxz_offset_deltas((3, 3, 3), shape)
    return dict(src=ids, tgt=ids, feats=feats, w=w, deltas=deltas,
                sent=so.yxz_sentinel_start(shape), coords=coords,
                shape=shape, n=n_active)


def strided_case(seed=2, n_active=1300, c_in=8, c_out=16):
    """A stride-2 conv over make_case's level: targets are the output
    voxels' base ids in the input id space (source != target)."""
    c = make_case(seed, n_active, c_in=c_in, c_out=c_out)
    shape = c["shape"]
    out_shape = tuple((n + 2 - 3) // 2 + 1 for n in shape)
    coords = np.full((1, c["src"].shape[0], 3), -1, np.int32)
    coords[0, :n_active] = c["coords"]
    valid = torch.zeros(1, c["src"].shape[0], dtype=torch.bool)
    valid[0, :n_active] = True
    _, oc, ov = so.win_downsample(torch.from_numpy(coords), valid, shape,
                                  out_shape, 2048)
    base = so.strided_base_ids(oc, ov, (2, 2, 2), shape, out_shape)
    assert bool((base[0, 1:] > base[0, :-1]).all())   # padding rows too
    c.update(tgt=base[0].numpy(),
             deltas=so.strided_deltas((3, 3, 3), (2, 2, 2), (1, 1, 1), shape),
             sent=so.strided_sentinel_start(shape))
    return c


def t(a):
    return torch.from_numpy(np.asarray(a))[None]


def j(a):
    return jnp.asarray(a)


def port_conv(c, window, **kw):
    out, ovf = ws.windowed_conv(t(c["src"]), t(c["feats"]), t(c["tgt"]),
                                torch.from_numpy(c["w"]), c["deltas"],
                                block=BLOCK, window=window, **kw)
    return out[0].numpy(), int(ovf[0])


def jax_conv(c, window, **kw):
    out, ovf = windowed_conv_pallas(
        j(c["src"]), j(c["feats"]), j(c["tgt"]), j(c["w"]), j(c["deltas"]),
        block=BLOCK, window=window, compute_dtype=jnp.float32,
        interpret=True, **kw)
    return np.asarray(out), int(ovf)


@pytest.mark.parametrize("case", ["subm", "strided"])
def test_forward_matches_pallas(case):
    c = make_case() if case == "subm" else strided_case()
    want, ovf_j = jax_conv(c, 1536, sentinel_start=c["sent"])
    got, ovf = port_conv(c, 1536, sentinel_start=c["sent"])
    assert ovf == ovf_j == 0
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("relu", [True, False])
def test_epilogue_matches_pallas(relu):
    c = make_case(seed=5, n_active=1200)
    rng = np.random.RandomState(7)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    shift = rng.standard_normal(16).astype(np.float32)
    want, _ = jax_conv(c, 1536, sentinel_start=c["sent"], scale=j(scale),
                       shift=j(shift), relu=relu)
    got, ovf = port_conv(c, 1536, sentinel_start=c["sent"],
                         scale=torch.from_numpy(scale),
                         shift=torch.from_numpy(shift), relu=relu)
    assert ovf == 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(got).max() > 0.1
    # rows in sentinel space are zeroed whatever the affine map gives
    c["tgt"] = c["src"] = np.concatenate(
        [c["src"][:-BLOCK], c["sent"] + np.arange(BLOCK)]).astype(np.int32)
    got, _ = port_conv(c, 1536, sentinel_start=c["sent"],
                       scale=torch.from_numpy(scale),
                       shift=torch.from_numpy(shift), relu=relu)
    assert (got[-BLOCK:] == 0).all() and np.abs(got[:-BLOCK]).max() > 0.1
    with pytest.raises(ValueError, match="sentinel_start"):
        port_conv(c, 1536, scale=torch.from_numpy(scale),
                  shift=torch.from_numpy(shift))


def test_transposed_call_matches_pallas():
    """The backward's d_feats: source and target lists swapped, deltas
    negated, weights (K, Cout, Cin)."""
    c = strided_case()
    g = np.random.RandomState(1).standard_normal(
        (c["tgt"].shape[0], 16)).astype(np.float32)
    tc = dict(src=c["tgt"], tgt=c["src"], feats=g,
              w=np.ascontiguousarray(c["w"].transpose(0, 2, 1)),
              deltas=-c["deltas"])
    want, ovf_j = jax_conv(tc, 1536)
    got, ovf = port_conv(tc, 1536)
    assert ovf == ovf_j == 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_overflowing_window_drops_the_same_neighbours():
    """A window too small for the scene: both packages search the same
    slice, so they keep and drop the same neighbours."""
    c = make_case(seed=4, n_active=2000, shape=(9, 24, 24))
    want, ovf_j = jax_conv(c, 512, sentinel_start=c["sent"])
    got, ovf = port_conv(c, 512, sentinel_start=c["sent"])
    full, ovf_full = port_conv(c, 4096, sentinel_start=c["sent"])
    assert ovf == ovf_j > 0 and ovf_full == 0
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert np.abs(got - full).max() > 0.1       # neighbours were dropped


@pytest.mark.parametrize("case", ["subm", "strided"])
def test_windowed_dw_matches_pallas(case):
    c = make_case(seed=3, n_active=900) if case == "subm" else strided_case()
    g = np.random.RandomState(1).standard_normal(
        (c["tgt"].shape[0], 16)).astype(np.float32)
    want = np.asarray(windowed_dw_pallas(
        j(c["src"]), j(c["feats"]), j(c["tgt"]), j(g), j(c["deltas"]),
        block=BLOCK, window=1536, compute_dtype=jnp.float32, interpret=True))
    got = ws.windowed_dw(t(c["src"]), t(c["feats"]), t(c["tgt"]), t(g),
                         c["deltas"], block=BLOCK, window=1536).numpy()
    assert got.shape == (27, 8, 16)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    # two samples sum, as the vmapped reference's gradient does
    two = ws.windowed_dw(
        torch.cat([t(c["src"])] * 2), torch.cat([t(c["feats"])] * 2),
        torch.cat([t(c["tgt"])] * 2), torch.cat([t(g), 2 * t(g)]),
        c["deltas"], block=BLOCK, window=1536).numpy()
    np.testing.assert_allclose(two, 3 * got, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("window,tap_window", [
    (1536, None), (512, None), (1536, 640), (1536, 128), (4096, 1024)])
def test_windowed_overflow_matches_jax(window, tap_window):
    for c in (make_case(seed=5), strided_case(),
              make_case(seed=4, n_active=2000, shape=(9, 24, 24))):
        for sent in (None, c["sent"]):
            want = int(windowed_overflow(
                j(c["src"]), j(c["tgt"]), j(c["deltas"]), BLOCK, window,
                sentinel_start=sent, tap_window=tap_window))
            got = ws.windowed_overflow(
                t(c["src"]), t(c["tgt"]), c["deltas"], BLOCK, window,
                sentinel_start=sent, tap_window=tap_window)
            assert int(got[0]) == want
    huge = np.asarray([-10 ** 6, 10 ** 6], np.int32)
    assert int(ws.windowed_overflow(t(c["src"]), t(c["src"]), huge, BLOCK,
                                    512, sentinel_start=c["sent"])[0]) > 0


@pytest.mark.parametrize("case", ["subm", "strided"])
def test_windowed_conv_gradients_match_pallas(case):
    c = make_case(seed=3, n_active=900) if case == "subm" else strided_case()
    vt = c["tgt"].shape[0]
    cosw = np.cos(np.arange(vt * 16).reshape(vt, 16) * 0.01).astype(
        np.float32)

    def loss_jax(f, ww):
        out, ovf = windowed_conv_pallas_diff(
            j(c["src"]), f, j(c["tgt"]), ww, j(c["deltas"]), block=BLOCK,
            window=1536, sentinel_start=c["sent"],
            compute_dtype=jnp.float32, interpret=True)
        return jnp.sum(out * cosw), ovf

    (v_j, ovf_j), (gf_j, gw_j) = jax.value_and_grad(
        loss_jax, (0, 1), has_aux=True)(j(c["feats"]), j(c["w"]))

    f = t(c["feats"]).requires_grad_()
    w = torch.from_numpy(c["w"]).requires_grad_()
    out, ovf = ws.windowed_conv_diff(t(c["src"]), f, t(c["tgt"]), w,
                                     c["deltas"], block=BLOCK, window=1536,
                                     sentinel_start=c["sent"])
    assert not ovf.requires_grad and int(ovf[0]) == int(ovf_j) == 0
    v = (out[0] * torch.from_numpy(cosw)).sum()
    v.backward()
    np.testing.assert_allclose(float(v), float(v_j), rtol=1e-4)
    np.testing.assert_allclose(f.grad[0].numpy(), np.asarray(gf_j),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(gw_j),
                               rtol=2e-3, atol=2e-3)
    assert np.abs(np.asarray(gf_j)).max() > 0.1

    # an input that needs no gradient (the 4->16 input conv) gets none
    f2 = t(c["feats"])
    w2 = torch.from_numpy(c["w"]).requires_grad_()
    out2, _ = ws.windowed_conv_diff(t(c["src"]), f2, t(c["tgt"]), w2,
                                    c["deltas"], block=BLOCK, window=1536)
    (out2[0] * torch.from_numpy(cosw)).sum().backward()
    np.testing.assert_allclose(w2.grad.numpy(), w.grad.numpy(), rtol=1e-6)


def test_wrappers_refuse_what_the_kernels_cannot_take():
    c = make_case()
    with pytest.raises(ValueError, match="multiple"):
        ws.windowed_conv(t(c["src"]), t(c["feats"]), t(c["tgt"])[:, :1000],
                         torch.from_numpy(c["w"]), c["deltas"], block=BLOCK)
    with pytest.raises(ValueError, match="block multiple"):
        ws.windowed_conv_diff(t(c["src"])[:, :1500], t(c["feats"])[:, :1500],
                              t(c["tgt"]), torch.from_numpy(c["w"]),
                              c["deltas"], block=BLOCK)
    assert ws.LAUNCHES == {"windowed_conv": 0, "windowed_dw": 0}


def _transposed(c):
    """The case's transposed conv (d_feats of the backward): lists swapped,
    the taps reversed and negated so that they group, zero features."""
    return dict(c, src=c["tgt"], tgt=c["src"],
                feats=np.zeros((c["tgt"].shape[0], 1), np.float32),
                deltas=np.ascontiguousarray(-c["deltas"][::-1]))


def _probe_case(name):
    """(case, window): submanifold, strided, and a window too small for the
    scene, where neighbours at the window's edges are dropped; with
    "-transposed", the case's transposed conv."""
    base = name.split("-")[0]
    if base == "overflow":
        c, window = make_case(seed=4, n_active=2000, shape=(9, 24, 24)), 512
    else:
        c, window = (make_case(seed=3, n_active=900) if base == "subm"
                     else strided_case()), 1536
    return (_transposed(c) if name.endswith("-transposed") else c), window


def _prepared(c, window):
    return ws._prepare(t(c["src"]), t(c["feats"]), t(c["tgt"]), c["deltas"],
                       BLOCK, window)


@pytest.mark.parametrize("name", [
    "subm", "strided", "overflow", "subm-transposed", "strided-transposed",
    "overflow-transposed"])
def test_group_probe_rows_match_neighbour_rows(name):
    """One search per (target, tap group) and three probes from its rank —
    the K3 and K4 kernels' route — find exactly the rows that one search
    per tap finds, window edges included, in both directions of the conv
    (the transposed one with its taps reversed and negated)."""
    from findnpropagate_torch.ops.posgather import group_center_deltas

    c, window = _probe_case(name)
    src, feats, tgt, deltas, lo, window = _prepared(c, window)
    centres = torch.from_numpy(group_center_deltas(c["deltas"]))
    rows_k, found_k = ws.neighbour_rows(src, tgt, lo, deltas, BLOCK, window)
    rows_g, found_g = ws.group_probe_rows(src, tgt, lo, centres, BLOCK,
                                          window)
    assert found_k.shape == found_g.shape == (1, 27, tgt.shape[1])
    assert torch.equal(found_g, found_k) and int(found_k.sum()) > 1000
    assert torch.equal(rows_g[found_k], rows_k[found_k])
    if name == "overflow":
        src, _, tgt, deltas, lo, window = _prepared(c, 4096)
        full = ws.neighbour_rows(src, tgt, lo, deltas, BLOCK, window)[1]
        assert int(full.sum()) > int(found_k.sum())    # some were dropped


@pytest.mark.parametrize("name", ["subm", "strided", "overflow"])
def test_dw_through_group_probes_matches_pallas(name):
    """dW summed over the rows that the group probes find, in the
    (K, Cin, Cout) tap order, against the plain version (same products,
    another gather route: 1e-5) and the Pallas kernel in interpret mode at
    f32 (the JAX package's gradient tolerance, 2e-3)."""
    from findnpropagate_torch.ops.posgather import group_center_deltas

    c, window = _probe_case(name)
    g = np.random.RandomState(1).standard_normal(
        (c["tgt"].shape[0], 16)).astype(np.float32)
    src, feats, tgt, deltas, lo, win = _prepared(c, window)
    centres = torch.from_numpy(group_center_deltas(c["deltas"]))
    gat = ws._gather_rows(feats, *ws.group_probe_rows(src, tgt, lo, centres,
                                                      BLOCK, win))
    got = torch.einsum("bktc,bto->kco", gat, t(g)).numpy()
    plain = ws.windowed_dw_plain(src, feats, tgt, t(g), lo, deltas, BLOCK,
                                 win).numpy()
    want = np.asarray(windowed_dw_pallas(
        j(c["src"]), j(c["feats"]), j(c["tgt"]), j(g), j(c["deltas"]),
        block=BLOCK, window=window, compute_dtype=jnp.float32,
        interpret=True))
    assert got.shape == (27, 8, 16) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("n_tiles,g_n,batch,want", [
    (1888, 9, 4, 7), (2048, 9, 1, 29), (768, 9, 4, 7), (16, 9, 1, 16),
    (2048, 1, 1, 264), (64, 9, 64, 1)])
def test_dw_chunks(n_tiles, g_n, batch, want):
    assert ws.dw_chunks(n_tiles, g_n, batch) == want


class _FakeLib:
    """Stands in for the CUDA library: keeps each C call's arguments."""

    def __init__(self):
        self.calls = []

    def fp_windowed_dw(self, *args):
        self.calls.append(args)
        return 0

    fp_windowed_conv = fp_windowed_dw


def test_dw_cuda_wrapper_groups_pads_and_sizes_the_scratch(monkeypatch):
    """The CUDA branch of the K4 wrapper on CPU tensors, with tensors in
    place of pointers: bf16 copies padded to 16 channels, the nine group
    centres, a scratch of one partial per (sample, chunk), the result cut
    back to (27, Cin, Cout); taps that do not group are refused."""
    from findnpropagate_torch.ops.posgather import group_center_deltas

    fake = _FakeLib()
    monkeypatch.setattr(ws, "_check_device", lambda *a: True)
    monkeypatch.setattr(ws, "_lib", lambda: fake)
    monkeypatch.setattr(ws, "_stream", lambda: None)
    monkeypatch.setattr(ws, "_ptr", lambda x: x)
    ws.reset_launches()
    c = make_case(seed=3, n_active=900)
    g = torch.zeros(2, c["tgt"].shape[0], 10)
    src, feats, tgt, deltas, lo, window = ws._prepare(
        torch.cat([t(c["src"])] * 2), torch.cat([t(c["feats"])] * 2),
        torch.cat([t(c["tgt"])] * 2), c["deltas"], BLOCK, 1536)
    dw = ws.dw_kernel(src, feats, tgt, g, lo, deltas, BLOCK, window,
                      compute_dtype=torch.bfloat16)
    a, = fake.calls
    k_feats, k_g, k_centres, partial, k_dw = a[1], a[3], a[5], a[6], a[7]
    assert k_feats.dtype == k_g.dtype == torch.bfloat16
    assert k_feats.shape == (2, 1024, 16) and k_g.shape == (2, 1024, 16)
    assert torch.equal(k_feats[..., :8], feats.to(torch.bfloat16))
    assert not k_feats[..., 8:].any()
    np.testing.assert_array_equal(k_centres.numpy(),
                                  group_center_deltas(c["deltas"]))
    n_chunks = ws.dw_chunks(1024 // ws.DW_TILE, 9, 2)
    assert partial.shape == (2 * n_chunks, 9, 48, 16)
    assert k_dw.shape == (27, 16, 16) and dw.shape == (27, 8, 10)
    # (..., B, Vs, Vt, nb, G, block, window, cin, cout, n_chunks, taps,
    #  stream)
    assert a[8:19] == (2, 1024, 1024, 2, 9, BLOCK, window, 16, 16, n_chunks,
                       3)
    assert ws.LAUNCHES["windowed_dw"] == 1
    # 33 taps: no groups of 5 or 3 consecutive ids, too many groups of one
    with pytest.raises(ValueError, match="consecutive"):
        ws.dw_kernel(src, feats, tgt, g, lo,
                     torch.cat([deltas.flip(0), deltas[:6]]).contiguous(),
                     BLOCK, window, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported"):    # Cin 264
        ws.dw_kernel(src, feats.repeat(1, 1, 33), tgt, g, lo, deltas, BLOCK,
                     window, compute_dtype=torch.bfloat16)
    ws.reset_launches()


def test_transposed_call_in_group_order_matches_pallas_gradient():
    """The backward's d_feats as WindowedConv computes it: the transposed
    call with the taps reversed and negated and W[26-k]^T (the same
    (delta, weight) pairs, in group order) equals the call in the forward's
    tap order to f32 rounding, and the reference's d_feats of
    `windowed_conv_pallas_diff` in interpret mode (2e-3, its gradient
    tolerance)."""
    from findnpropagate_torch.ops.posgather import (
        flip_transpose_weights, group_center_deltas)

    c = strided_case()
    g = np.random.RandomState(1).standard_normal(
        (c["tgt"].shape[0], 16)).astype(np.float32)
    w = torch.from_numpy(c["w"])
    grouped = np.ascontiguousarray(-c["deltas"][::-1])
    group_center_deltas(grouped)                 # groups: no ValueError
    with pytest.raises(ValueError, match="consecutive"):
        group_center_deltas(-c["deltas"])
    got, ovf = ws.windowed_conv(t(c["tgt"]), t(g), t(c["src"]),
                                flip_transpose_weights(w), grouped,
                                block=BLOCK, window=1536)
    tap_order, _ = ws.windowed_conv(t(c["tgt"]), t(g), t(c["src"]),
                                    w.transpose(1, 2), -c["deltas"],
                                    block=BLOCK, window=1536)
    assert int(ovf[0]) == 0
    np.testing.assert_allclose(got.numpy(), tap_order.numpy(), rtol=1e-5,
                               atol=1e-5)

    def out_jax(f):
        return windowed_conv_pallas_diff(
            j(c["src"]), f, j(c["tgt"]), j(c["w"]), j(c["deltas"]),
            block=BLOCK, window=1536, compute_dtype=jnp.float32,
            interpret=True)[0]

    _, vjp = jax.vjp(out_jax, j(c["feats"]))
    want = np.asarray(vjp(j(g))[0])
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got[0].numpy(), want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("cin,cout,window,want", [
    (16, 16, 4096, (2, True, True)),        # L0 subm: everything fits
    (32, 64, 7680, (2, True, True)),        # L1->L2 strided forward
    (64, 32, 7680, (2, True, False)),       # its transposed: no room left
    (64, 128, 6656, (2, False, False)),     # L2->L3: weights streamed
    (128, 64, 6656, (1, False, True)),      # its transposed: one stage
    (128, 128, 4096, (1, False, True))])
def test_conv_plan(cin, cout, window, want):
    """K3's ring and staging at the model's widths, inside one block's
    shared memory."""
    plan = ws.conv_plan(cin, cout, window)
    assert plan == want
    assert ws.conv_smem(cin, cout, window, 9, *plan) <= ws.SMEM_MAX


def test_conv_cuda_wrapper_groups_packs_and_pads(monkeypatch):
    """The CUDA branch of the K3 wrapper on CPU tensors, with tensors in
    place of pointers: one bf16 copy of the features padded to 16
    channels, the group centres as deltas[9:18], the weights in group
    order packed for the mma fragments, Cout padded to a power of two and
    cut back, the plan's ints; taps that do not group and widths the
    kernel does not take are refused."""
    from findnpropagate_torch.ops.posgather import (
        group_center_deltas, pack_weights_mma, reorder_weights_groups)

    fake = _FakeLib()
    monkeypatch.setattr(ws, "_check_device", lambda *a: True)
    monkeypatch.setattr(ws, "_lib", lambda: fake)
    monkeypatch.setattr(ws, "_stream", lambda: None)
    monkeypatch.setattr(ws, "_ptr", lambda x: x)
    ws.reset_launches()
    c = make_case(seed=3, n_active=900, c_in=4, c_out=10)
    src, feats, tgt, deltas, lo, window = _prepared(c, 1536)
    w_flat = torch.from_numpy(c["w"]).reshape(27 * 4, 10)
    scale, shift = torch.ones(10), torch.full((10,), 0.5)
    out = ws.conv_kernel(src, feats, tgt, lo, deltas, w_flat, BLOCK, window,
                         scale=scale, shift=shift, relu=True,
                         sentinel=c["sent"], compute_dtype=torch.bfloat16)
    a, = fake.calls
    k_feats, k_centres, k_w, k_scale, k_shift, k_out = (
        a[1], a[4], a[5], a[6], a[7], a[8])
    assert k_feats.dtype == torch.bfloat16 and k_feats.shape == (1, 1024, 16)
    assert torch.equal(k_feats[..., :4], feats.to(torch.bfloat16))
    assert not k_feats[..., 4:].any()
    np.testing.assert_array_equal(k_centres.numpy(),
                                  group_center_deltas(c["deltas"]))
    wg = torch.nn.functional.pad(reorder_weights_groups(
        torch.from_numpy(c["w"])), (0, 6, 0, 12))           # (9,3,16,16)
    assert torch.equal(k_w, pack_weights_mma(
        wg.reshape(27 * 16, 16).to(torch.bfloat16)))
    assert torch.equal(k_scale[:10], scale) and not k_scale[10:].any()
    assert torch.equal(k_shift[:10], shift) and not k_shift[10:].any()
    assert k_out.shape == (1, 1024, 16) and out.shape == (1, 1024, 10)
    # (..., B, Vs, Vt, nb, G, block, window, cin, cout, epilogue, relu,
    #  sentinel, stages, resident, stage_window, taps, accumulate, stream)
    assert a[9:26] == (1, 1024, 1024, 2, 9, BLOCK, window, 16, 16, 1, 1,
                       c["sent"], *map(int, ws.conv_plan(16, 16, window)),
                       3, 0)
    assert ws.LAUNCHES["windowed_conv"] == 1
    # 33 taps: no groups of 5 or 3 consecutive ids, too many groups of one
    with pytest.raises(ValueError, match="consecutive"):
        ws.conv_kernel(src, feats, tgt, lo,
                       torch.cat([deltas.flip(0), deltas[:6]]).contiguous(),
                       w_flat.repeat(2, 1)[:33 * 4], BLOCK, window,
                       compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported"):    # Cin 260
        ws.conv_kernel(src, feats.repeat(1, 1, 65), tgt, lo, deltas,
                       w_flat.repeat(65, 1), BLOCK, window,
                       compute_dtype=torch.bfloat16)
    assert ws.LAUNCHES["windowed_conv"] == 1
    ws.reset_launches()


# ------------------------------------------- tap groups of 5 and 1, 256 ch


def tap_case(kind, seed=6, c_in=8, c_out=16):
    """A conv of the VoxelNeXt / PillarNet paths on a small level: "k5" a
    5x5x5 stride-2 conv (25 tap groups of five), "2d" a (1, 3, 3)
    submanifold conv on a (1, ny, nx) level (9 groups of one), "2d-strided"
    its (1, 2, 2)-strided conv (padding (0, 1, 1))."""
    shape = (9, 40, 40) if kind == "k5" else (1, 48, 48)
    c = make_case(seed, 1200 if kind == "k5" else 900, shape=shape,
                  c_in=c_in, c_out=c_out)
    if kind == "2d":
        c.update(w=np.random.RandomState(seed).standard_normal(
            (9, c_in, c_out)).astype(np.float32) * 0.1,
            deltas=so.yxz_offset_deltas((1, 3, 3), shape))
        return c
    kernel, stride, pad = ((5, 5, 5), (2, 2, 2), (2, 2, 2)) if kind == "k5" \
        else ((1, 3, 3), (1, 2, 2), (0, 1, 1))
    out_shape = tuple((n + 2 * p - k) // s + 1 for n, k, s, p in zip(
        shape, kernel, stride, pad))
    coords = np.full((1, c["src"].shape[0], 3), -1, np.int32)
    coords[0, :c["n"]] = c["coords"]
    valid = torch.zeros(1, c["src"].shape[0], dtype=torch.bool)
    valid[0, :c["n"]] = True
    _, oc, ov = so.win_downsample(torch.from_numpy(coords), valid, shape,
                                  out_shape, 1024, kernel_size=kernel,
                                  stride=stride, padding=pad)
    base = so.strided_base_ids(oc, ov, stride, shape, out_shape)
    k = int(np.prod(kernel))
    c.update(tgt=base[0].numpy(), w=np.random.RandomState(seed)
             .standard_normal((k, c_in, c_out)).astype(np.float32) * 0.1,
             deltas=so.strided_deltas(kernel, stride, pad, shape),
             sent=so.strided_sentinel_start(shape))
    return c


def transposed(c, g):
    """The transposed call of a case: lists swapped, taps reversed and
    negated, weights flipped and transposed (the pairs in group order)."""
    from findnpropagate_torch.ops.posgather import flip_transpose_weights

    return dict(src=c["tgt"], tgt=c["src"], feats=g,
                w=flip_transpose_weights(torch.from_numpy(c["w"])).numpy(),
                deltas=np.ascontiguousarray(-c["deltas"][::-1]))


@pytest.mark.parametrize("kind,taps,groups", [
    ("k5", 5, 25), ("2d", 1, 9), ("2d-strided", 1, 9)])
def test_tap_groups_of_five_and_one(kind, taps, groups):
    """A 5x5x5 kernel's taps are 25 groups of five consecutive ids, a 2D
    (1, 3, 3) kernel's 9 groups of one (x-neighbours are nz + 2 = 3 ids
    apart, no runs of three); the transposed direction's reversed and
    negated taps group the same way with the middles reversed and
    negated, and the weights in group order pair each tap with its own
    kernel row in both directions."""
    from findnpropagate_torch.ops.posgather import (
        flip_transpose_weights, reorder_weights_groups, tap_groups)

    c = tap_case(kind)
    mids, size = tap_groups(c["deltas"])
    assert (size, mids.shape[0]) == (taps, groups)
    t_mids, t_size = tap_groups(-c["deltas"][::-1])
    assert t_size == taps
    np.testing.assert_array_equal(t_mids, -mids[::-1])
    h = taps // 2
    for d, w in ((c["deltas"], torch.from_numpy(c["w"])),
                 (-c["deltas"][::-1],
                  flip_transpose_weights(torch.from_numpy(c["w"])))):
        m, _ = tap_groups(d)
        grouped = reorder_weights_groups(w, taps)      # (G, S, Cin, Cout)
        for g in range(groups):
            for zi in range(taps):
                k = zi * groups + g
                assert d[k] == m[g] + zi - h
                assert torch.equal(grouped[g, zi], w[k])


@pytest.mark.parametrize("kind", ["k5", "2d", "2d-strided"])
@pytest.mark.parametrize("direction", ["forward", "transposed"])
def test_group_probe_rows_at_five_and_one_taps(kind, direction):
    """The kernels' route (one search per (target, group), the S taps from
    its rank) finds exactly the rows of one search per tap."""
    from findnpropagate_torch.ops.posgather import tap_groups

    c = tap_case(kind)
    if direction == "transposed":
        c = transposed(c, np.zeros((c["tgt"].shape[0], 16), np.float32))
    src, feats, tgt, deltas, lo, window = _prepared(c, 2048)
    mids, size = tap_groups(c["deltas"])
    rows_k, found_k = ws.neighbour_rows(src, tgt, lo, deltas, BLOCK, window)
    rows_g, found_g = ws.group_probe_rows(src, tgt, lo, torch.from_numpy(
        mids), BLOCK, window, taps=size)
    assert torch.equal(found_g, found_k) and int(found_k.sum()) > 1000
    assert torch.equal(rows_g[found_k], rows_k[found_k])


@pytest.mark.parametrize("kind", ["k5", "2d", "2d-strided"])
def test_five_and_one_tap_convs_match_pallas(kind):
    """K3 (forward and transposed) and K4 at these tap sets: the port's
    plain versions against the JAX package's Pallas kernels in interpret
    mode at float32 (1e-4 forward, 2e-3 weight gradient)."""
    c = tap_case(kind)
    want, ovf_j = jax_conv(c, 2048, sentinel_start=c["sent"])
    got, ovf = port_conv(c, 2048, sentinel_start=c["sent"])
    assert ovf == ovf_j == 0 and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    g = np.random.RandomState(1).standard_normal(
        (c["tgt"].shape[0], 16)).astype(np.float32)
    tc = transposed(c, g)
    want, _ = jax_conv(tc, 2048)
    got, _ = port_conv(tc, 2048)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    want = np.asarray(windowed_dw_pallas(
        j(c["src"]), j(c["feats"]), j(c["tgt"]), j(g), j(c["deltas"]),
        block=BLOCK, window=2048, compute_dtype=jnp.float32, interpret=True))
    got = ws.windowed_dw(t(c["src"]), t(c["feats"]), t(c["tgt"]), t(g),
                         c["deltas"], block=BLOCK, window=2048).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("cin,cout,g_n,taps,window,slices,launches", [
    (32, 64, 25, 5, 7680, (32, 64), 1),       # Waymo large L1->L2, k5
    (64, 32, 25, 5, 7680, (64, 32), 1),       # its transposed
    (64, 128, 25, 5, 6656, (64, 128), 1),     # L2->L3, k5
    (128, 64, 25, 5, 6656, (64, 64), 2),      # its transposed: Cin slices
    (128, 256, 9, 3, 4096, (128, 128), 2),    # L3->L4, 256 out
    (256, 256, 9, 3, 4096, (128, 128), 4),    # L4 submanifold
    (256, 128, 9, 3, 4096, (128, 128), 2),    # L3->L4 transposed
    (64, 128, 9, 1, 4096, (64, 128), 1),      # 2D strided
    (256, 256, 9, 1, 4096, (128, 128), 4)])   # 2D at 256
def test_conv_slices_fit_one_block(cin, cout, g_n, taps, window, slices,
                                   launches):
    """K3's channel slices at the new tap sets and widths: the fewest
    launches whose plan fits in one block's shared memory."""
    ci, co = ws.conv_slices(cin, cout, window, g_n, taps)
    assert (ci, co) == slices and (cin // ci) * (cout // co) == launches
    plan = ws.conv_plan(ci, co, window, g_n, taps)
    assert ws.conv_smem(ci, co, window, g_n, *plan, taps) <= ws.SMEM_MAX
    with pytest.raises(ValueError):
        ws.conv_plan(cin * 4, cout * 4, window, g_n, taps)


@pytest.mark.parametrize("cin,cout,taps,want", [
    (16, 16, 3, (16, 16)), (64, 128, 3, (64, 128)), (128, 64, 3, (128, 64)),
    (64, 128, 5, (64, 64)), (128, 64, 5, (128, 32)), (32, 64, 5, (32, 64)),
    (256, 256, 3, (128, 64)), (256, 256, 1, (128, 64)),
    (128, 256, 3, (128, 64))])
def test_dw_slices(cin, cout, taps, want):
    """K4's channel slices: Cin at most 128 (eight warps), Cin * Cout at
    most 8192 accumulators a block, 4096 at five taps."""
    ci, co = ws.dw_slices(cin, cout, taps)
    assert (ci, co) == want
    assert ci * co <= (ws.MAX_DW_ACC5 if taps == 5 else ws.MAX_DW_ACC)


def unpack_mma(packed):
    """The inverse of posgather.pack_weights_mma: (R/16, C/8, 32, 4) ->
    (R, C)."""
    ks, nt = packed.shape[:2]
    return packed.reshape(ks, nt, 8, 4, 2, 2).permute(
        0, 4, 3, 5, 1, 2).reshape(ks * 16, nt * 8)


class _EmuLib:
    """Stands in for the CUDA library and computes what the C entries
    compute from their arguments (tensors in place of pointers): K3 from
    the packed weights (rows g*S*Cin + zi*Cin + c) and the taps rebuilt
    from the group middles (tap zi*G + g is middle g + zi - S/2), adding
    to the buffer with `accumulate`, then the epilogue; K4 the (S*G, Cin,
    Cout) gradient into its buffer. Keeps each call's integers."""

    def __init__(self):
        self.calls = []
        self.plans = []

    @staticmethod
    def _deltas(mids, taps):
        return torch.cat([mids + zi - taps // 2 for zi in range(taps)])

    def fp_windowed_conv(self, src, feats, tgt, lo, mids, w, scale, shift,
                         out, b, vs, vt, nb, g_n, block, window, cin, cout,
                         epi, relu, sent, stages, resident, stage_window,
                         taps, acc, stream):
        self.calls.append(("conv", cin, cout, epi, acc, taps, g_n))
        self.plans.append((stages, resident, stage_window))
        wf = unpack_mma(w).float().reshape(g_n, taps, cin, cout)
        wf = wf.permute(1, 0, 2, 3).reshape(taps * g_n * cin, cout)
        res = ws.windowed_conv_plain(src, feats.float(), tgt, lo,
                                     self._deltas(mids, taps), wf, block,
                                     window)
        if acc:
            res = res + out
        if epi:
            res = res * scale + shift
            res = torch.relu(res) if relu else res
            res = res * (tgt < sent)[..., None]
        out.copy_(res)
        return 0

    def fp_windowed_dw(self, src, feats, tgt, g, lo, centres, partial, dw,
                       b, vs, vt, nb, g_n, block, window, cin, cout,
                       n_chunks, taps, stream):
        self.calls.append(("dw", cin, cout, taps, g_n))
        assert partial.shape == (b * n_chunks, g_n, taps * cin, cout)
        dw.copy_(ws.windowed_dw_plain(src, feats.float(), tgt, g.float(),
                                      lo, self._deltas(centres, taps),
                                      block, window))
        return 0


@pytest.mark.parametrize("kind,cin,cout,direction", [
    ("k5", 32, 64, "forward"), ("k5", 64, 128, "transposed"),
    ("2d-strided", 64, 128, "forward"), ("2d", 256, 256, "forward"),
    ("k5", 16, 256, "forward")])
def test_cuda_branch_slices_and_groups_match_plain(monkeypatch, kind, cin,
                                                   cout, direction):
    """The CUDA branches of the K3 and K4 wrappers on CPU tensors against
    a library that computes what the kernels compute: the group order of
    the weights and taps at five and one taps, the channel slices (Cin
    slices summed in the output buffer, the epilogue with the last), the
    launches counted one per slice, and the results equal to the plain
    versions at the same bf16 operands (f32 sums in another order: 1e-5
    of the output's scale)."""
    fake = _EmuLib()
    monkeypatch.setattr(ws, "_check_device", lambda *a: True)
    monkeypatch.setattr(ws, "_lib", lambda: fake)
    monkeypatch.setattr(ws, "_stream", lambda: None)
    monkeypatch.setattr(ws, "_ptr", lambda x: x)
    c = tap_case(kind, c_in=cin, c_out=cout)
    if direction == "transposed":
        g = np.random.RandomState(2).standard_normal(
            (c["tgt"].shape[0], cout)).astype(np.float32)
        c = transposed(c, g)
        c["sent"] = None
    src, feats, tgt, deltas, lo, window = _prepared(c, 2048)
    k, ci, co = c["w"].shape
    w_flat = torch.from_numpy(c["w"]).reshape(k * ci, co)
    rng = np.random.RandomState(4)
    epi = {} if c["sent"] is None else dict(
        scale=torch.from_numpy(rng.uniform(0.5, 1.5, co).astype(np.float32)),
        shift=torch.from_numpy(rng.standard_normal(co).astype(np.float32)),
        relu=True, sentinel=c["sent"])
    ws.reset_launches()
    got = ws.conv_kernel(src, feats, tgt, lo, deltas, w_flat, BLOCK, window,
                         compute_dtype=torch.bfloat16, **epi)
    want = ws.windowed_conv_plain(src, feats, tgt, lo, deltas, w_flat, BLOCK,
                                  window, compute_dtype=torch.bfloat16,
                                  **epi)
    from findnpropagate_torch.ops.posgather import tap_groups

    mids, taps = tap_groups(c["deltas"])
    cin_p = -(-ci // 16) * 16
    cout_p = max(8, 1 << (co - 1).bit_length())
    ci_t, co_t = ws.conv_slices(cin_p, cout_p, window, len(mids), taps)
    n_in, n_out = cin_p // ci_t, cout_p // co_t
    convs = [x for x in fake.calls if x[0] == "conv"]
    assert ws.LAUNCHES["windowed_conv"] == len(convs) == n_in * n_out
    # (cin, cout, epilogue, accumulate, taps, groups) of each launch
    assert convs == [("conv", ci_t, co_t, int(bool(epi)) * (i == n_in - 1),
                      int(i > 0), taps, len(mids))
                     for _ in range(n_out) for i in range(n_in)]
    assert (n_in > 1 or n_out > 1) == (cin > 128 or cout > 128
                                       or direction == "transposed")
    scale = max(float(want.abs().max()), 1e-3)
    assert float((got - want).abs().max()) <= 1e-5 * scale
    g = torch.from_numpy(np.random.RandomState(5).standard_normal(
        (1, tgt.shape[1], co)).astype(np.float32))
    dw = ws.dw_kernel(src, feats, tgt, g, lo, deltas, BLOCK, window,
                      compute_dtype=torch.bfloat16)
    ref = ws.windowed_dw_plain(src, feats, tgt, g, lo, deltas, BLOCK, window,
                               compute_dtype=torch.bfloat16)
    assert dw.shape == ref.shape == (k, ci, co)
    np.testing.assert_allclose(dw.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert ws.LAUNCHES["windowed_dw"] == len(
        [x for x in fake.calls if x[0] == "dw"])
    ws.reset_launches()


@pytest.mark.parametrize("cin,cin_k3,resident,cin_k4", [
    (16, 16, True, 16), (19, 32, True, 32), (32, 32, True, 32),
    (35, 48, True, 64), (64, 64, True, 64), (67, 80, False, 128)])
def test_focal_importance_conv_widths(monkeypatch, cin, cin_k3, resident,
                                      cin_k4):
    """The focal backbone's importance conv (VoxelBackBone8xFocal: 16, 32
    and 64 channels, 3 more with USE_IMG, to 27) through the CUDA branches
    of the K3 and K4 wrappers against the emulating library: K3 forward
    in one launch at Cin padded to a multiple of 16 and Cout 27 padded to
    32 (the weights resident but at Cin 80), its transposed conv (27 ->
    Cin) at Cin 32, K4 at Cin padded to a power of two and Cout 32, all
    equal to the plain versions at the same bf16 operands (1e-5 of the
    output's scale)."""
    fake = _EmuLib()
    monkeypatch.setattr(ws, "_check_device", lambda *a: True)
    monkeypatch.setattr(ws, "_lib", lambda: fake)
    monkeypatch.setattr(ws, "_stream", lambda: None)
    monkeypatch.setattr(ws, "_ptr", lambda x: x)
    c = make_case(8, 1200, shape=(9, 40, 40), c_in=cin, c_out=27)
    window = 2048
    src, feats, tgt, deltas, lo, window = _prepared(c, window)
    w_flat = torch.from_numpy(c["w"]).reshape(27 * cin, 27)
    ws.reset_launches()
    got = ws.conv_kernel(src, feats, tgt, lo, deltas, w_flat, BLOCK, window,
                         compute_dtype=torch.bfloat16)
    want = ws.windowed_conv_plain(src, feats, tgt, lo, deltas, w_flat, BLOCK,
                                  window, compute_dtype=torch.bfloat16)
    assert fake.calls == [("conv", cin_k3, 32, 0, 0, 3, 9)]
    assert fake.plans[0][1] == resident
    assert ws.conv_plan(cin_k3, 32, window) == fake.plans[0]
    scale = max(float(want.abs().max()), 1e-3)
    assert float((got - want).abs().max()) <= 1e-5 * scale
    g = np.random.RandomState(9).standard_normal(
        (c["tgt"].shape[0], 27)).astype(np.float32)
    tc = transposed(c, g)
    tsrc, tfeats, ttgt, tdeltas, tlo, twin = _prepared(tc, window)
    tw = torch.from_numpy(tc["w"]).reshape(27 * 27, cin)
    got = ws.conv_kernel(tsrc, tfeats, ttgt, tlo, tdeltas, tw, BLOCK, twin,
                         compute_dtype=torch.bfloat16)
    want = ws.windowed_conv_plain(tsrc, tfeats, ttgt, tlo, tdeltas, tw,
                                  BLOCK, twin, compute_dtype=torch.bfloat16)
    cout_p = max(8, 1 << (cin - 1).bit_length())
    assert fake.calls[1] == ("conv", 32, cout_p, 0, 0, 3, 9)
    assert float((got - want).abs().max()) <= 1e-5 * max(
        float(want.abs().max()), 1e-3)
    gt = torch.from_numpy(g)[None]
    dw = ws.dw_kernel(src, feats, tgt, gt, lo, deltas, BLOCK, window,
                      compute_dtype=torch.bfloat16)
    ref = ws.windowed_dw_plain(src, feats, tgt, gt, lo, deltas, BLOCK,
                               window, compute_dtype=torch.bfloat16)
    assert fake.calls[2] == ("dw", cin_k4, 32, 3, 9)
    assert ws.dw_slices(cin_k4, 32) == (cin_k4, 32)
    np.testing.assert_allclose(dw.numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)
    assert ws.LAUNCHES == {"windowed_conv": 2, "windowed_dw": 1}
    ws.reset_launches()
