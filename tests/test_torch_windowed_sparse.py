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


def _probe_case(name):
    """(case, window): submanifold, strided, and a window too small for the
    scene, where neighbours at the window's edges are dropped."""
    if name == "overflow":
        return make_case(seed=4, n_active=2000, shape=(9, 24, 24)), 512
    return (make_case(seed=3, n_active=900) if name == "subm"
            else strided_case()), 1536


def _prepared(c, window):
    return ws._prepare(t(c["src"]), t(c["feats"]), t(c["tgt"]), c["deltas"],
                       BLOCK, window)


@pytest.mark.parametrize("name", ["subm", "strided", "overflow"])
def test_group_probe_rows_match_neighbour_rows(name):
    """One search per (target, tap group) and three probes from its rank —
    the K4 kernel's route — find exactly the rows that one search per tap
    finds, window edges included."""
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
    # (..., B, Vs, Vt, nb, G, block, window, cin, cout, n_chunks, stream)
    assert a[8:18] == (2, 1024, 1024, 2, 9, BLOCK, window, 16, 16, n_chunks)
    assert ws.LAUNCHES["windowed_dw"] == 1
    with pytest.raises(ValueError, match="consecutive"):
        ws.dw_kernel(src, feats, tgt, g, lo, deltas.flip(0)[:26].contiguous(),
                     BLOCK, window, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported"):
        ws.dw_kernel(src, feats.repeat(1, 1, 32), tgt, g, lo, deltas, BLOCK,
                     window, compute_dtype=torch.bfloat16)
    ws.reset_launches()
