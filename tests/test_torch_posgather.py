"""Position-gather sparse conv of the PyTorch port (ops/posgather.py, plain
versions on the CPU) against the JAX package's Pallas kernels run in
interpret mode.

  * compute_positions (on CPU tensors) and compute_positions_plain: the
    integer fields lo, base, pos[:9], has_real and overflow are bit-equal —
    subm and strided, tap_window set and unset.
  * posgather_conv at f32: rtol/atol 1e-5, the tolerance of the JAX
    package's own interpret tests (the two sum the 27*Cin products in
    different orders) — with and without the fused epilogue, strided, the
    band=1 scene where the reference's per-tile fallback fires, and a scene
    whose union-window overflow is nonzero, where both drop the same
    neighbours.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from findnpropagate_torch.ops import posgather as TP
from findnpropagate_tpu.ops import pallas_posgather as JP
from findnpropagate_tpu.ops import sparse_ops as JS

SUBM_CASES = {
    # name: (seed, density, v_cap, shape, window, tap_window)
    "subm": (3, 0.15, 1024, (9, 24, 24), 1024, None),
    "subm_tap": (3, 0.15, 1024, (9, 24, 24), 1024, 256),
    "dense_band1": (1, 0.4, 1024, (9, 24, 24), 1024, None),
    "overflow": (1, 0.15, 4096, (9, 40, 40), 512, None),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module's tests: tier-1 runs six workers
    on the machine's cores, where a pool per worker spends more time
    handing off the port's small operations than it gains."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_case(seed, density, v_cap, shape, c_in=5):
    rng = np.random.RandomState(seed)
    nz, ny, nx = shape
    n = min(int(nz * ny * nx * density), v_cap - 7)
    lin = rng.choice(nz * ny * nx, n, replace=False)
    coords = np.full((v_cap, 3), -1, np.int32)
    coords[:n] = np.stack([lin % nz, (lin // nz) % ny, lin // (nz * ny)], 1)
    valid = np.zeros(v_cap, bool)
    valid[:n] = True
    ids = np.asarray(JS.yxz_linear_ids(jnp.asarray(coords),
                                       jnp.asarray(valid), shape))
    order = np.argsort(ids, kind="stable")
    feats = (rng.standard_normal((v_cap, c_in)).astype(np.float32) * 0.3
             * valid[order][:, None])
    return ids[order], coords[order], valid[order], feats


def strided_case(tap_window):
    shape = (9, 24, 24)
    out_shape = tuple((n + 2 - 3) // 2 + 1 for n in shape)
    ids, coords, valid, feats = make_case(5, 0.15, 1024, shape)
    oi, oc, ov = JS.win_downsample(jnp.asarray(coords), jnp.asarray(valid),
                                   shape, out_shape, 1024)
    base = np.array(JS.strided_base_ids(oc, ov, (2, 2, 2), shape,
                                          out_shape))
    deltas = JS.strided_deltas((3, 3, 3), (2, 2, 2), (1, 1, 1), shape)
    return (ids, feats, base, np.asarray(ov), deltas,
            JS.strided_sentinel_start(shape), 1024, tap_window)


def subm_case(name):
    seed, density, v_cap, shape, window, tap = SUBM_CASES[name]
    ids, _, valid, feats = make_case(seed, density, v_cap, shape)
    return (ids, feats, ids, valid,
            np.asarray(JS.yxz_offset_deltas((3, 3, 3), shape)),
            JS.yxz_sentinel_start(shape), window, tap)


def both_positions(case, band=3, fn=TP.compute_positions):
    src, _, tgt, _, deltas, sent, window, tap = case
    lj = JP.compute_positions(jnp.asarray(src), jnp.asarray(tgt), deltas,
                              block=512, window=window, band=band,
                              tap_window=tap, sentinel_start=sent,
                              interpret=True)
    lt = fn(torch.from_numpy(src)[None], torch.from_numpy(tgt)[None],
            deltas, block=512, window=window, tap_window=tap,
            sentinel_start=sent)
    return lj, lt


def assert_positions_equal(lt, lj):
    for field in ("lo", "base", "has_real"):
        np.testing.assert_array_equal(getattr(lt, field)[0].numpy(),
                                      np.asarray(getattr(lj, field)))
    np.testing.assert_array_equal(lt.pos[0].numpy(), np.asarray(lj.pos)[:9])
    assert int(lt.overflow[0]) == int(lj.overflow)


@pytest.mark.parametrize("name", sorted(SUBM_CASES) + ["strided",
                                                       "strided_tap"])
def test_positions_bit_equal(name):
    """compute_positions_plain (what compute_positions runs on the CPU, and
    what the card's fused K1 is held against) on every scene: the SUBM_CASES
    (among them the band=1 scene and a union-window overflow) and the
    strided ones."""
    case = {"strided": lambda: strided_case(None),
            "strided_tap": lambda: strided_case(1024 - 512)}.get(
        name, lambda: subm_case(name))()
    lj, lt = both_positions(case, fn=TP.compute_positions_plain)
    assert_positions_equal(lt, lj)
    if name == "overflow":
        assert int(lt.overflow[0]) > 0 and int((lt.has_real == 0).sum()) > 0


def _weights(cin, cout, seed=11):
    rng = np.random.RandomState(seed)
    w = rng.standard_normal((27, cin, cout)).astype(np.float32) * 0.2
    scale = rng.uniform(0.5, 1.5, cout).astype(np.float32)
    shift = rng.standard_normal(cout).astype(np.float32)
    return w, scale, shift


@pytest.mark.parametrize("name,epilogue", [
    ("subm", False), ("subm", True), ("strided", True),
    ("dense_band1", False), ("overflow", True)])
def test_conv_matches_interpret(name, epilogue):
    case = strided_case(None) if name == "strided" else subm_case(name)
    src, feats, tgt, tgt_valid, _, sent, _, _ = case
    band = 1 if name == "dense_band1" else (6 if name == "strided" else 3)
    lj, lt = both_positions(case, band=band)
    if name == "dense_band1":
        assert int(np.sum(np.asarray(lj.flags))) > 0   # fallback fires
    if name == "overflow":
        assert int(lj.overflow) > 0 and int(lt.overflow[0]) == int(
            lj.overflow)
    else:
        assert int(lj.overflow) == 0
    w, scale, shift = _weights(feats.shape[1], 7)
    kj, kt = {}, {}
    if epilogue:
        kj = dict(scale=jnp.asarray(scale), shift=jnp.asarray(shift),
                  relu=True)
        kt = dict(scale=torch.from_numpy(scale),
                  shift=torch.from_numpy(shift), relu=True)
    ref = JP.posgather_conv(jnp.asarray(src), jnp.asarray(feats),
                            jnp.asarray(tgt), jnp.asarray(w), lj,
                            sentinel_start=sent, compute_dtype=jnp.float32,
                            interpret=True, **kj)
    got = TP.posgather_conv(torch.from_numpy(src)[None],
                            torch.from_numpy(feats)[None],
                            torch.from_numpy(tgt)[None], torch.from_numpy(w),
                            lt, sentinel_start=sent, **kt)[0].numpy()
    # rows of padding targets are don't-care without the epilogue's mask
    m = tgt_valid[:, None] if not epilogue else 1.0
    np.testing.assert_allclose(got * m, np.asarray(ref) * m,
                               rtol=1e-5, atol=1e-5)


class _FakeLib:
    """Stands in for the CUDA library: records each C call, returns 0."""

    def __init__(self):
        self.calls = []
        for name in ("fp_level_positions", "fp_positions",
                     "fp_posgather_conv"):
            setattr(self, name, self._recorder(name))

    def _recorder(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def test_cuda_wrappers_validate_and_pack_arguments(monkeypatch):
    """The CUDA branch of the K1 and K2 wrappers, run on CPU tensors against
    a fake library: shapes are checked, the C entries get the right sizes,
    and each launch counts once."""
    fake = _FakeLib()
    monkeypatch.setattr(TP, "_check_device", lambda *t: True)
    monkeypatch.setattr(TP, "_lib", lambda: fake)
    monkeypatch.setattr(TP, "_stream", lambda: None)
    TP.reset_launches()
    src, feats, tgt, _, deltas, sent, window, _ = subm_case("subm")
    src_t = torch.from_numpy(src)[None]
    lp = TP.compute_positions(src_t, src_t, deltas, block=512,
                              window=window, sentinel_start=sent)
    w = torch.zeros(27, 5, 7)
    TP.posgather_conv(src_t, torch.from_numpy(feats)[None], src_t, w, lp,
                      scale=torch.ones(7), shift=torch.zeros(7), relu=True,
                      sentinel_start=sent)
    tap_lo = torch.zeros(1, 2, 9, dtype=torch.int32)
    TP.positions(src_t, src_t, lp.lo, tap_lo, lp.has_real, lp.gdeltas, 512,
                 1024, False)
    assert TP.LAUNCHES == {"positions": 2, "posgather_conv": 1}
    (n1, a1), (n2, a2), (n3, a3) = fake.calls
    # fp_level_positions(src, tgt, lo, base, has_real, ovf, pos, deltas,
    #                    sentinel, has_sentinel, B, Vs, Vt, block, window,
    #                    tap_window, stage, stream)
    assert n1 == "fp_level_positions" and a1[8:17] == (
        sent, 1, 1, 1024, 1024, 512, 1024, 0, 1)
    assert a1[7].n == 9 and list(a1[7].d) == list(
        TP.group_center_deltas(deltas))
    assert lp.pos.shape == (1, 9, 1024) and lp.overflow.shape == (1,)
    assert lp.lo.shape == lp.base.shape == lp.has_real.shape == (1, 2)
    # fp_posgather_conv(..., B, Vs, Vt, nb, G, block, window, cin, cout,
    #                   epilogue, relu, sentinel, stream); Cin 5 -> 16,
    # Cout 7 -> 8
    assert n2 == "fp_posgather_conv" and a2[11:23] == (
        1, 1024, 1024, 2, 9, 512, 1024, 16, 8, 1, 1, sent)
    # fp_positions(..., B, Vs, Vt, nb, G, block, span, use_tap, stream)
    assert n3 == "fp_positions" and a3[7:15] == (1, 1024, 1024, 2, 9, 512,
                                                 1024, 0)
    with pytest.raises(ValueError):
        TP.gather_conv(src_t, torch.zeros(1, 1024, 16), src_t, lp.pos, lp.lo,
                       lp.has_real, lp.gdeltas, torch.zeros(27 * 16 - 1, 8),
                       512, window, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        TP.positions(src_t, src_t, lp.lo, lp.lo, lp.has_real, lp.gdeltas,
                     512, 1024, True)
    with pytest.raises(ValueError):                     # Vt % block
        TP.compute_positions(src_t, src_t[:, :1000], deltas, block=512,
                             window=window)


@pytest.mark.parametrize("tap,window,want", [
    (None, 1024, (0, 1024)), (256, 1024, (256, 1024)),
    (1024, 1024, (0, 1024)), (None, 4096, (0, 1024))])
def test_cuda_level_positions_passes_deltas_by_value_and_caches(
        monkeypatch, tap, window, want):
    """The CUDA branch of compute_positions on CPU tensors against a fake
    library: the tap groups' centres reach the kernel by value, the (G,)
    gdeltas tensor K2 reads is made once per (deltas, device) and reused,
    the source list is padded to ALIGN, and the tap window is passed only
    below the union window (which is rounded up and capped at Vs)."""
    fake = _FakeLib()
    monkeypatch.setattr(TP, "_check_device", lambda *t: True)
    monkeypatch.setattr(TP, "_lib", lambda: fake)
    monkeypatch.setattr(TP, "_stream", lambda: None)
    monkeypatch.setattr(TP, "_ptr", lambda t: t)
    monkeypatch.setattr(TP, "_DELTAS", {})
    made = []
    as_tensor = torch.as_tensor
    monkeypatch.setattr(torch, "as_tensor",
                        lambda *a, **k: made.append(1) or as_tensor(*a, **k))
    src, _, _, _, deltas, sent, _, _ = subm_case("subm")
    src_t = torch.from_numpy(src)[None]
    l1 = TP.compute_positions(src_t[:, :1000], src_t, deltas, block=512,
                              window=window, tap_window=tap,
                              sentinel_start=sent)
    l2 = TP.compute_positions(src_t, src_t, deltas.copy(), block=512,
                              window=window, tap_window=tap)
    assert len(made) == 1 and l1.gdeltas is l2.gdeltas
    np.testing.assert_array_equal(l1.gdeltas.numpy(),
                                  TP.group_center_deltas(deltas))
    (_, a1), (_, a2) = fake.calls
    assert a1[7] is a2[7] and a1[7].n == 9
    assert list(a1[7].d) == l1.gdeltas.tolist()
    k_src = a1[0]
    assert k_src.shape == (1, 1024) and torch.equal(k_src[:, :1000],
                                                    src_t[:, :1000])
    assert bool((k_src[0, 1000:] > k_src[0, 999]).all())
    assert (a1[15], a1[14]) == want and (a2[15], a2[14]) == want
    assert a1[8:10] == (sent, 1) and a2[8:10] == (0, 0)
    assert l1.window == want[1]
    # lo, base and has_real: one int32 buffer; the kernel counts the
    # overflow conditions into the (B,) int64 result itself
    assert a1[2].dtype == torch.int32 and a1[2].shape == (1, 2)
    assert a1[3].data_ptr() == a1[2].data_ptr() + 2 * 4
    assert a1[5] is l1.overflow and l1.overflow.dtype == torch.int64
    centres = np.arange(10) * 50 - 250              # 10 groups of three
    with pytest.raises(ValueError, match="at most 9"):
        TP.compute_positions(src_t, src_t, np.concatenate(
            [centres - 1, centres, centres + 1]), block=512, window=window)


@pytest.mark.parametrize("name", ["subm", "dense_band1"])
def test_subm_diff_matches_interpret(name):
    """posgather_subm_diff (forward K2, d_feats K2 with flipped-transposed
    weights over the same positions, dW by the windowed weight-gradient
    kernel) against the JAX function of the same name, interpret mode at
    f32. Output rtol/atol 1e-5 as the forward test above; gradients 2e-3,
    the JAX package's own gradient tolerance (tests/test_pallas_sparse.py)."""
    import jax

    case = subm_case(name)
    src, feats, _, valid, deltas, sent, window, _ = case
    lj, lt = both_positions(case)
    w = _weights(5, 8)[0]
    cosw = np.cos(np.arange(src.shape[0] * 8).reshape(-1, 8) * 0.01).astype(
        np.float32) * valid[:, None]

    def loss_jax(f, ww):
        out = JP.posgather_subm_diff(
            jnp.asarray(src), f, ww, jnp.asarray(deltas), lj, dw_block=512,
            dw_window=window, sentinel_start=sent,
            compute_dtype=jnp.float32, interpret=True)
        return jnp.sum(out * cosw), out

    (_, out_j), (gf_j, gw_j) = jax.value_and_grad(
        loss_jax, (0, 1), has_aux=True)(jnp.asarray(feats), jnp.asarray(w))

    f = torch.from_numpy(feats)[None].requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = TP.posgather_subm_diff(torch.from_numpy(src)[None], f, wt, deltas,
                                 lt, dw_block=512, dw_window=window)
    (out[0] * torch.from_numpy(cosw)).sum().backward()
    np.testing.assert_allclose(out[0].detach().numpy(), np.asarray(out_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(f.grad[0].numpy(), np.asarray(gf_j),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(gw_j),
                               rtol=2e-3, atol=2e-3)
    assert np.abs(np.asarray(gf_j)).max() > 0.05
    assert np.abs(np.asarray(gw_j)).max() > 0.05

    # an input that needs no gradient gets none; dW is unchanged
    w2 = torch.from_numpy(w).requires_grad_()
    out2 = TP.posgather_subm_diff(torch.from_numpy(src)[None],
                                  torch.from_numpy(feats)[None], w2, deltas,
                                  lt, dw_block=512, dw_window=window)
    (out2[0] * torch.from_numpy(cosw)).sum().backward()
    np.testing.assert_array_equal(w2.grad.numpy(), wt.grad.numpy())


def test_flip_transpose_weights_matches_jax():
    w = _weights(5, 8)[0]
    np.testing.assert_array_equal(
        TP.flip_transpose_weights(torch.from_numpy(w)).numpy(),
        np.asarray(JP.flip_transpose_weights(jnp.asarray(w))))


def _unpack_fragments(packed):
    """Undo pack_weights_mma with the mma.sync m16n8k16 B-fragment rule
    written out: lane l of (slab ks, tile nt) holds rows 2(l%4), 2(l%4)+1,
    2(l%4)+8, 2(l%4)+9 of column l//4."""
    ks_n, nt_n = packed.shape[:2]
    w = np.zeros((ks_n * 16, nt_n * 8), packed.dtype)
    for ks in range(ks_n):
        for nt in range(nt_n):
            for lane in range(32):
                for e, k in enumerate((0, 1, 8, 9)):
                    w[ks * 16 + 2 * (lane % 4) + k, nt * 8 + lane // 4] = \
                        packed[ks, nt, lane, e]
    return w


@pytest.mark.parametrize("rows,cout", [(16, 8), (9 * 48, 16), (96, 128)])
def test_pack_weights_mma_is_the_fragment_order(rows, cout):
    w = np.random.RandomState(rows + cout).standard_normal(
        (rows, cout)).astype(np.float32)
    packed = TP.pack_weights_mma(torch.from_numpy(w))
    assert packed.shape == (rows // 16, cout // 8, 32, 4)
    assert packed.is_contiguous()
    np.testing.assert_array_equal(_unpack_fragments(packed.numpy()), w)
    with pytest.raises(ValueError):
        TP.pack_weights_mma(torch.zeros(rows + 8, cout))
    with pytest.raises(ValueError):
        TP.pack_weights_mma(torch.zeros(rows, cout + 4))


@pytest.mark.parametrize("name", ["subm", "strided", "column"])
def test_group_center_deltas_split_and_back(name):
    """A K-tap delta list splits into K/3 centre groups; tap zi*G + g is
    centre g plus zi - 1, the order reorder_weights_groups and the JAX
    package's function of the same name use."""
    shape = (9, 24, 24)
    deltas = {
        "subm": lambda: JS.yxz_offset_deltas((3, 3, 3), shape),
        "strided": lambda: JS.strided_deltas((3, 3, 3), (2, 2, 2), (1, 1, 1),
                                             shape),
        "column": lambda: JS.yxz_offset_deltas((3, 1, 1), shape),
    }[name]()
    deltas = np.asarray(deltas)
    centres = TP.group_center_deltas(deltas)
    g_n = deltas.shape[0] // 3
    np.testing.assert_array_equal(centres,
                                  np.asarray(JP.group_center_deltas(deltas)))
    back = np.concatenate([centres + zi - 1 for zi in range(3)])
    np.testing.assert_array_equal(back, deltas)
    w = torch.from_numpy(_weights(5, 7)[0][:3 * g_n])
    grouped = TP.reorder_weights_groups(w)
    assert grouped.shape == (g_n, 3, 5, 7)
    for g in range(g_n):
        for zi in range(3):
            assert torch.equal(grouped[g, zi], w[zi * g_n + g])


@pytest.mark.parametrize("bad", ["shuffled", "short", "flat_z", "empty"])
def test_group_center_deltas_refuses_what_does_not_group(bad):
    shape = (9, 24, 24)
    d = np.asarray(JS.yxz_offset_deltas((3, 3, 3), shape))
    deltas = {
        "shuffled": d[np.random.RandomState(0).permutation(27)],
        "short": d[:26],
        "flat_z": np.asarray(JS.yxz_offset_deltas((1, 3, 3), shape)),
        "empty": d[:0],
    }[bad]
    with pytest.raises(ValueError, match="consecutive"):
        TP.group_center_deltas(deltas)


def test_cuda_wrapper_hands_the_kernel_bf16_rows_and_packed_weights(
        monkeypatch):
    """The CUDA branch of the K2 wrapper on CPU tensors, with tensors in
    place of pointers: the kernel gets one bf16 copy of the features, the
    weights padded to Cout 8 and packed per group in fragment order, and a
    block that is not a multiple of the kernel's tile is refused."""
    fake = _FakeLib()
    monkeypatch.setattr(TP, "_check_device", lambda *t: True)
    monkeypatch.setattr(TP, "_lib", lambda: fake)
    monkeypatch.setattr(TP, "_stream", lambda: None)
    monkeypatch.setattr(TP, "_ptr", lambda t: t)
    src, feats, _, _, deltas, sent, window, _ = subm_case("subm")
    src_t = torch.from_numpy(src)[None]
    lp = TP.compute_positions(src_t, src_t, deltas, block=512,
                              window=window, sentinel_start=sent)
    w = torch.from_numpy(_weights(5, 7)[0])
    TP.reset_launches()
    TP.posgather_conv(src_t, torch.from_numpy(feats)[None], src_t, w, lp)
    (_, a), = [c for c in fake.calls if c[0] == "fp_posgather_conv"]
    k_feats, k_w, k_out = a[1], a[7], a[10]
    assert k_feats.dtype == torch.bfloat16 and k_feats.is_contiguous()
    want = torch.nn.functional.pad(torch.from_numpy(feats)[None], (0, 11))
    assert torch.equal(k_feats, want.to(torch.bfloat16))
    assert k_w.dtype == torch.bfloat16
    assert k_w.shape == (9 * 3, 1, 32, 4)         # 9 groups x 48 rows / 16
    w_flat = torch.nn.functional.pad(
        TP.reorder_weights_groups(w), (0, 1, 0, 11)).reshape(9 * 48, 8)
    np.testing.assert_array_equal(
        _unpack_fragments(k_w.float().numpy()),
        w_flat.to(torch.bfloat16).float().numpy())
    assert k_out.shape == (1, 1024, 8) and k_out.dtype == torch.float32
    assert TP.LAUNCHES["posgather_conv"] == 1
    with pytest.raises(ValueError, match="unsupported"):
        TP.gather_conv(src_t.repeat(1, 1)[:, :960], torch.zeros(1, 960, 16),
                       src_t[:, :960], lp.pos[:, :, :960], lp.lo,
                       lp.has_real, lp.gdeltas, torch.zeros(27 * 16, 8),
                       96, 960, compute_dtype=torch.bfloat16)


@pytest.mark.parametrize("cin,cout", [(128, 256), (256, 256), (256, 10)])
def test_cuda_branch_channel_slices_match_plain(monkeypatch, cin, cout):
    """The CUDA branch of the K2 wrapper on CPU tensors against a library
    that computes what the kernel computes from its arguments (tensors in
    place of pointers): convs wider than 128 channels in or out run as one
    launch per (Cout slice, Cin slice), each counted, the Cin slices summed
    in the slice's buffer (`accumulate`) and the epilogue with the last;
    the result equals the plain version at the same bf16 operands (f32
    sums in another order: 1e-5 of the output's scale)."""
    from test_torch_windowed_sparse import make_case, unpack_mma

    calls = []

    class Emu:
        def fp_posgather_conv(self, src, feats, tgt, pos, lo, has_real,
                              gdeltas, w, scale, shift, out, b, vs, vt, nb,
                              g_n, block, window, ci, co, epi, relu, sent,
                              acc, stream):
            calls.append((ci, co, epi, acc))
            res = TP.posgather_conv_plain(
                src, feats.float(), tgt, pos, lo, has_real, gdeltas,
                unpack_mma(w).float(), block, window)
            if acc:
                res = res + out
            if epi:
                res = torch.relu(res * scale + shift) if relu \
                    else res * scale + shift
                res = res * (tgt < sent)[..., None]
            out.copy_(res * has_real.bool().repeat_interleave(
                block, dim=1)[..., None])
            return 0

    monkeypatch.setattr(TP, "_check_device", lambda *t: True)
    monkeypatch.setattr(TP, "_lib", lambda: Emu())
    monkeypatch.setattr(TP, "_stream", lambda: None)
    monkeypatch.setattr(TP, "_ptr", lambda t: t)
    c = make_case(seed=8, n_active=700, shape=(9, 24, 24), c_in=cin,
                  c_out=cout)
    src = torch.from_numpy(c["src"])[None]
    lp = TP.compute_positions_plain(src, src, c["deltas"], block=512,
                                    window=1024, sentinel_start=c["sent"])
    rng = np.random.RandomState(3)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, cout).astype(np.float32))
    shift = torch.from_numpy(rng.standard_normal(cout).astype(np.float32))
    w_flat = TP.reorder_weights_groups(torch.from_numpy(c["w"])).reshape(
        27 * cin, cout)
    args = (src, torch.from_numpy(c["feats"])[None], src, lp.pos, lp.lo,
            lp.has_real, lp.gdeltas, w_flat, 512, lp.window)
    epi = dict(scale=scale, shift=shift, relu=True, sentinel=c["sent"],
               compute_dtype=torch.bfloat16)
    TP.reset_launches()
    got = TP.gather_conv(*args, **epi)
    want = TP.posgather_conv_plain(*args, **epi)
    n_in, n_out = -(-cin // 128), -(-max(8, cout) // 128)
    assert TP.LAUNCHES["posgather_conv"] == len(calls) == n_in * n_out
    cout_p = max(8, 1 << (cout - 1).bit_length())
    assert calls == [(min(cin, 128), min(cout_p, 128), int(i == n_in - 1),
                      int(i > 0)) for _ in range(n_out) for i in range(n_in)]
    assert got.shape == want.shape == (1, 1024, cout)
    assert float((got - want).abs().max()) <= 1e-5 * float(
        want.abs().max())
    TP.reset_launches()
