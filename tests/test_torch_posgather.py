"""Position-gather sparse conv of the PyTorch port (ops/posgather.py, plain
versions on the CPU) against the JAX package's Pallas kernels run in
interpret mode.

  * compute_positions: the integer fields lo, base, pos[:9], has_real and
    overflow are bit-equal — subm and strided, tap_window set and unset.
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


def both_positions(case, band=3):
    src, _, tgt, _, deltas, sent, window, tap = case
    lj = JP.compute_positions(jnp.asarray(src), jnp.asarray(tgt), deltas,
                              block=512, window=window, band=band,
                              tap_window=tap, sentinel_start=sent,
                              interpret=True)
    lt = TP.compute_positions(torch.from_numpy(src)[None],
                              torch.from_numpy(tgt)[None], deltas,
                              block=512, window=window, tap_window=tap,
                              sentinel_start=sent)
    return lj, lt


@pytest.mark.parametrize("name", ["subm", "subm_tap", "strided",
                                  "strided_tap"])
def test_positions_bit_equal(name):
    case = {"strided": lambda: strided_case(None),
            "strided_tap": lambda: strided_case(1024 - 512)}.get(
        name, lambda: subm_case(name))()
    lj, lt = both_positions(case)
    for field in ("lo", "base", "has_real"):
        np.testing.assert_array_equal(getattr(lt, field)[0].numpy(),
                                      np.asarray(getattr(lj, field)))
    np.testing.assert_array_equal(lt.pos[0].numpy(), np.asarray(lj.pos)[:9])
    assert int(lt.overflow[0]) == int(lj.overflow)


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
        for name in ("fp_positions", "fp_posgather_conv"):
            setattr(self, name, self._recorder(name))

    def _recorder(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def test_cuda_wrappers_validate_and_pack_arguments(monkeypatch):
    """The CUDA branch of both wrappers, run on CPU tensors against a fake
    library: shapes are checked, the C entries get the right sizes, and
    each launch counts once."""
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
    assert TP.LAUNCHES == {"positions": 1, "posgather_conv": 1}
    (n1, a1), (n2, a2) = fake.calls
    # fp_positions(..., B, Vs, Vt, nb, G, block, span, use_tap, stream)
    assert n1 == "fp_positions" and a1[7:15] == (1, 1024, 1024, 2, 9, 512,
                                                 1024, 0)
    # fp_posgather_conv(..., B, Vs, Vt, nb, G, block, window, cin, cout,
    #                   epilogue, relu, sentinel, stream); Cin 5 -> 16,
    # Cout 7 -> 8
    assert n2 == "fp_posgather_conv" and a2[11:23] == (
        1, 1024, 1024, 2, 9, 512, 1024, 16, 8, 1, 1, sent)
    with pytest.raises(ValueError):
        TP.gather_conv(src_t, torch.zeros(1, 1024, 16), src_t, lp.pos, lp.lo,
                       lp.has_real, lp.gdeltas, torch.zeros(27 * 16 - 1, 8),
                       512, window, compute_dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        TP.positions(src_t, src_t, lp.lo, lp.lo, lp.has_real, lp.gdeltas,
                     512, 1024, True)
