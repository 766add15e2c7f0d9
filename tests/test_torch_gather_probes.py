"""The gather probes' kernels in the PyTorch port (ops/gather_probes.py,
plain versions on the CPU) against the probes' own Pallas kernels run in
interpret mode, and the ported probe entry points
(findnpropagate_torch/tools/) on the CPU.

The probes build their kernel bodies inside functions or at import time,
so this file carries a copy of each body with the probe's BlockSpecs
(shapes cut down where the probe names none of its own). Tolerances:
  * P1 (take_along) and P2 without its weight stage (onehot_gather)
    bit-equal, NaN compared equal: both only move values;
  * P2 with its weight stage and P3 (banded_gather_conv) within one bf16
    step of the output's scale (8e-3): their f32 sums run in another order
    before the bf16 rounding.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from findnpropagate_torch.ops import gather_probes as GP
from findnpropagate_torch.ops.posgather import pack_weights_mma

VMEM = functools.partial(pl.BlockSpec, memory_space=pltpu.VMEM)
BF16_RTOL = 8e-3


def call_vmem(body, out_shape, *args):
    """A probe's pallas_call: every operand whole in VMEM, interpret mode."""
    return pl.pallas_call(
        body, out_shape=jax.ShapeDtypeStruct(*out_shape),
        in_specs=[VMEM()] * len(args), out_specs=VMEM(),
        interpret=True)(*args)


def to_np(t):
    """A torch or jax array as float32 numpy (bf16 is exact in f32)."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def jax_to_torch(a):
    a = jnp.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.array(a.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def assert_bitequal(got, want):
    np.testing.assert_array_equal(to_np(got), to_np(want))


def assert_bf16_close(got, want):
    g, w = to_np(got), to_np(want)
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-3)
    assert float(np.abs(g - w).max()) <= BF16_RTOL * scale


# --------------------------------------------------- P1: probe_gather.py


C, S, W, TAPS = 16, 256, 128, 27


def gather_inputs(sublane=False):
    """probe_variant / probe_sublane's inputs at a cut-down window."""
    rng = np.random.RandomState(0)
    shape = (S, C) if sublane else (C, S)
    x = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(
        jnp.bfloat16)
    idx = jnp.asarray(rng.randint(0, S, (TAPS, W)).astype(np.int32))
    return x, idx


def body_take(x_ref, idx_ref, o_ref, taps):
    x = x_ref[:]
    for k in range(taps):
        o_ref[k * 16:(k + 1) * 16, :] = jnp.take(x, idx_ref[k, :], axis=1)


def body_taa(x_ref, idx_ref, o_ref, taps):
    x = x_ref[:]
    for k in range(taps):
        idx = idx_ref[k, :]
        o_ref[k * 16:(k + 1) * 16, :] = jnp.take_along_axis(
            x, jnp.broadcast_to(idx[None, :], (x.shape[0], idx.shape[0])),
            axis=1)


def body_take_flat(x_ref, idx_ref, o_ref, taps):
    x = x_ref[:]
    w = idx_ref.shape[1]                  # the probe's 1024, cut down
    g = jnp.take(x, idx_ref[:].reshape(-1), axis=1)
    for k in range(taps):
        o_ref[k * 16:(k + 1) * 16, :] = g[:, k * w:(k + 1) * w]


@pytest.mark.parametrize("body", [body_take, body_taa, body_take_flat],
                         ids=lambda b: b.__name__)
def test_take_stacked_taps_matches_probe(body):
    x, idx = gather_inputs()
    want = call_vmem(functools.partial(body, taps=TAPS),
                     ((TAPS * C, W), jnp.bfloat16), x, idx)
    got = GP.take_along(jax_to_torch(x), jax_to_torch(idx), 1, taps=True)
    assert got.dtype == torch.bfloat16
    assert_bitequal(got, want)


def test_take_sublane_taps_matches_probe():
    x, idx = gather_inputs(sublane=True)

    def body(x_ref, idx_ref, o_ref):
        x = x_ref[:]
        for k in range(TAPS):
            o_ref[:, k * 16:(k + 1) * 16] = jnp.take(
                x, idx_ref[k, :], axis=0)

    want = call_vmem(body, ((W, TAPS * C), jnp.bfloat16), x, idx)
    got = GP.take_along(jax_to_torch(x), jax_to_torch(idx), 0, taps=True)
    assert_bitequal(got, want)


# ------------------------------------------- P1: probe_gather2.py, a - g


S2, C2, W2 = 256, 16, 128


def try_kernel_inputs(shapes):
    """probe_gather2 / 3's `try_kernel` inputs: numpy seed 0, ints in
    [0, last dim), floats standard normal."""
    rng = np.random.RandomState(0)
    args = []
    for shp, dt in shapes:
        if dt == jnp.int32:
            args.append(jnp.asarray(
                rng.randint(0, shp[-1], shp).astype(np.int32)))
        else:
            args.append(jnp.asarray(
                rng.randn(*shp).astype(np.float32)).astype(dt))
    return args


def taa1_body(x_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=1)


def taa0_body(x_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:], axis=0)


def c_body(x_ref, i_ref, o_ref):
    i = jnp.minimum(i_ref[:], x_ref.shape[0] - 1)
    o_ref[:] = jnp.take_along_axis(x_ref[:], i, axis=0)


def f_body(x_ref, i_ref, o_ref):
    idx = jnp.broadcast_to(i_ref[0:1, :], x_ref.shape)
    o_ref[:] = jnp.take_along_axis(x_ref[:], idx, axis=1)


def g_body(x_ref, i_ref, o_ref):
    o_ref[:] = x_ref[:][i_ref[0, :], :]


def taa0_mod_body(x_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(x_ref[:], i_ref[:] % x_ref.shape[0],
                                   axis=0)


def port_c(x, i):
    return GP.take_along(x, torch.clamp(i, max=x.shape[0] - 1), 0)


def port_g(x, i):
    return GP.take_along(x, i.t(), 0)


def port_mod0(x, i):
    return GP.take_along(x, torch.remainder(i, x.shape[0]), 0)


GATHER2 = {
    # name: (body, port, input shapes, output shape)
    "a_taa1_f32": (taa1_body, lambda x, i: GP.take_along(x, i, 1),
                   [((C2, S2), jnp.float32), ((C2, S2), jnp.int32)],
                   ((C2, S2), jnp.float32)),
    "b_taa1_bf16": (taa1_body, lambda x, i: GP.take_along(x, i, 1),
                    [((C2, S2), jnp.bfloat16), ((C2, S2), jnp.int32)],
                    ((C2, S2), jnp.bfloat16)),
    "c_taa0_clamped": (c_body, port_c,
                       [((S2, C2), jnp.float32), ((S2, C2), jnp.int32)],
                       ((S2, C2), jnp.float32)),
    "d_taa1_grow": (taa1_body, lambda x, i: GP.take_along(x, i, 1),
                    [((C2, S2), jnp.float32), ((C2, 2 * S2), jnp.int32)],
                    ((C2, 2 * S2), jnp.float32)),
    "e_row": (taa1_body, lambda x, i: GP.take_along(x, i, 1),
              [((1, S2), jnp.float32), ((1, W2), jnp.int32)],
              ((1, W2), jnp.float32)),
    "f_bcast_row": (f_body, lambda x, i: GP.take_along(x, i, 1),
                    [((C2, S2), jnp.float32), ((1, S2), jnp.int32)],
                    ((C2, S2), jnp.float32)),
    "g_rows": (g_body, port_g,
               [((S2, C2), jnp.float32), ((1, W2), jnp.int32)],
               ((W2, C2), jnp.float32)),
}

GATHER3 = {
    # probe_gather3's own shapes
    "taa1_8x128": (taa1_body, lambda x, i: GP.take_along(x, i, 1),
                   [((8, 128), jnp.float32), ((8, 128), jnp.int32)],
                   ((8, 128), jnp.float32)),
    "taa0_8x128_out_of_range": (
        taa0_body, lambda x, i: GP.take_along(x, i, 0),
        [((8, 128), jnp.float32), ((8, 128), jnp.int32)],
        ((8, 128), jnp.float32)),
    "taa0v_8x128": (taa0_mod_body, port_mod0,
                    [((8, 128), jnp.float32), ((8, 128), jnp.int32)],
                    ((8, 128), jnp.float32)),
    "taa0b_512x128": (taa0_mod_body, port_mod0,
                      [((512, 128), jnp.float32), ((512, 128), jnp.int32)],
                      ((512, 128), jnp.float32)),
    "taa1_8x1024": (taa1_body, lambda x, i: GP.take_along(x, i, 1),
                    [((8, 1024), jnp.float32), ((8, 1024), jnp.int32)],
                    ((8, 1024), jnp.float32)),
    "taa1_1024x128": (taa1_body, lambda x, i: GP.take_along(x, i, 1),
                      [((1024, 128), jnp.float32), ((1024, 128), jnp.int32)],
                      ((1024, 128), jnp.float32)),
}


@pytest.mark.parametrize("name", sorted({**GATHER2, **GATHER3}))
def test_take_along_matches_probe_bodies(name):
    body, port, shapes, out_shape = {**GATHER2, **GATHER3}[name]
    x, i = try_kernel_inputs(shapes)
    want = call_vmem(body, out_shape, x, i)
    got = port(jax_to_torch(x), jax_to_torch(i))
    assert got.dtype == jax_to_torch(x).dtype
    assert_bitequal(got, want)
    if name in ("d_taa1_grow", "taa0_8x128_out_of_range"):
        assert 0.4 < float(np.isnan(to_np(got)).mean()) < 1.0


def test_take_along_negative_and_out_of_range_indices():
    """Negative indices count from the end; beyond either end NaN, in f32
    and bf16, as jnp.take_along_axis fills."""
    x = np.arange(32, dtype=np.float32).reshape(8, 4)
    i = np.array([[0, -1, -4, -5, 4, 9, 3, -9]] * 8, np.int32)
    for dt, tdt in ((jnp.float32, torch.float32),
                    (jnp.bfloat16, torch.bfloat16)):
        want = jnp.take_along_axis(jnp.asarray(x, dt), jnp.asarray(i),
                                   axis=1)
        got = GP.take_along(torch.from_numpy(x).to(tdt),
                            torch.from_numpy(i), 1)
        assert_bitequal(got, want)
        want0 = jnp.take_along_axis(jnp.asarray(x, dt),
                                    jnp.asarray(i[:, :4]), axis=0)
        got0 = GP.take_along(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(i[:, :4]), 0)
        assert_bitequal(got0, want0)


@pytest.mark.parametrize("axis,taps", [(1, False), (0, False), (1, True),
                                       (0, True)])
def test_index3_broadcasts_with_stride_zero(axis, taps):
    """The view the kernel reads: stride 0 on the broadcast axis, the
    index's own strides elsewhere, and the output extents of each form."""
    x = torch.zeros(6, 10)
    if taps:
        idx = torch.zeros(3, 5, dtype=torch.int32)
        i3 = GP.index3(x, idx, axis, True)
        want_shape = (3, 6, 5) if axis == 1 else (3, 5, 10)
        want_stride = (5, 0, 1) if axis == 1 else (5, 1, 0)
    elif axis == 1:
        i3 = GP.index3(x, torch.zeros(1, 7, dtype=torch.int32), 1)
        want_shape, want_stride = (1, 6, 7), (0, 1)
    else:
        i3 = GP.index3(x, torch.zeros(7, 1, dtype=torch.int32), 0)
        want_shape, want_stride = (1, 7, 10), (1, 0)
    # with one tap, the tap stride is never used
    assert tuple(i3.shape) == want_shape
    assert i3.stride()[3 - len(want_stride):] == want_stride
    with pytest.raises(ValueError):
        GP.index3(x, torch.zeros(3, dtype=torch.int32), axis, taps)


# ------------------------------------------------ P2: the one-hot gathers


def onehot_inputs(c, s_win, w, taps, nb=None):
    """probe_gather's / bench_onehot_ref's inputs: features, sorted unique
    ids from 10 * s_win, wanted ids from the same range (and weights)."""
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(c, s_win).astype(np.float32)).astype(
        jnp.bfloat16)
    ids = jnp.asarray(np.sort(rng.choice(10 * s_win, s_win, replace=False))
                      .astype(np.int32))[None, :]
    want = jnp.asarray(rng.randint(0, 10 * s_win, (taps, w))
                       .astype(np.int32))
    wt = None if nb is None else jnp.asarray(
        rng.randn(c, taps * c).astype(np.float32)).astype(jnp.bfloat16)
    return x, ids, want, wt


def test_onehot_gather_matches_probe():
    x, ids, want, _ = onehot_inputs(C, S, W, TAPS)

    def body_onehot(x_ref, ids_ref, want_ref, o_ref):
        x = x_ref[:]
        ids = ids_ref[0, :]
        for k in range(27):
            onehot = (ids[:, None] == want_ref[k, :][None, :]
                      ).astype(x.dtype)
            o_ref[k * 16:(k + 1) * 16, :] = jnp.dot(
                x, onehot, preferred_element_type=jnp.float32
            ).astype(x.dtype)

    ref = call_vmem(body_onehot, ((TAPS * C, W), jnp.bfloat16), x, ids, want)
    got = GP.onehot_gather(jax_to_torch(x), jax_to_torch(ids)[0],
                           jax_to_torch(want))
    assert_bitequal(got, ref)
    hit = np.isin(np.asarray(want), np.asarray(ids))
    assert 0.02 < hit.mean() < 0.3          # both hits and misses


def onehot_ref_call(c, w_blk, taps, s_win, tap_win, nb, feats, ids, want,
                    wt):
    """bench_onehot_ref's kernel and grid (probe_posgather.py :166-:203)."""

    def kernel(feats_ref, ids_ref, want_ref, w_ref, o_ref, gbuf):
        for k in range(taps):
            wi = ids_ref[0, pl.ds(0, tap_win)]
            wf = feats_ref[:, pl.ds(0, tap_win)]
            onehot = (wi[:, None] == want_ref[k, :][None, :]
                      ).astype(jnp.bfloat16)
            g = jnp.dot(wf, onehot, preferred_element_type=jnp.float32)
            gbuf[k * c:(k + 1) * c, :] = g.astype(jnp.bfloat16)
        o_ref[:] = jnp.dot(w_ref[:], gbuf[:],
                           preferred_element_type=jnp.float32
                           ).astype(o_ref.dtype)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=0, grid=(nb,),
        in_specs=[VMEM(), VMEM(), VMEM(), VMEM()],
        out_specs=pl.BlockSpec((c, w_blk), lambda i: (0, i),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((taps * c, w_blk), jnp.bfloat16)])
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((c, nb * w_blk),
                                               jnp.bfloat16),
        grid_spec=grid_spec, interpret=True)(feats, ids, want, wt)


def test_onehot_weighted_matches_probe():
    """P2b: only the first tap_win ids compared, the gathered tile rounded
    to bf16, then the weight product, for 2 identical blocks."""
    nb, tap_win = 2, 192
    x, ids, want, wt = onehot_inputs(C, S, W, TAPS, nb)
    ref = onehot_ref_call(C, W, TAPS, S, tap_win, nb, x, ids, want, wt)
    got = GP.onehot_gather(jax_to_torch(x), jax_to_torch(ids)[0],
                           jax_to_torch(want), tap_win=tap_win,
                           wt=jax_to_torch(wt), blocks=nb)
    assert got.shape == (C, nb * W) and got.dtype == torch.bfloat16
    assert_bf16_close(got, ref)
    # hits beyond the tap window are dropped
    assert not np.allclose(to_np(got), to_np(GP.onehot_gather_plain(
        jax_to_torch(x), jax_to_torch(ids)[0], jax_to_torch(want),
        wt=jax_to_torch(wt), blocks=nb)))


def test_onehot_plain_sums_duplicate_ids():
    """The one-hot matmul adds the columns of equal ids (in f32, then one
    bf16 rounding); the kernel refuses such ids on the card (it traps:
    chip_smoke.unsorted_ids_refused), and its source tests every adjacent
    pair of the ids it stages."""
    x = torch.tensor([[1.0, 2.0, 4.0, 8.0]]).to(torch.bfloat16)
    ids = torch.tensor([3, 5, 5, 7], dtype=torch.int32)
    want = torch.tensor([[5, 7, 4]], dtype=torch.int32)
    got = GP.onehot_gather_plain(x, ids, want)
    assert got.float().tolist() == [[6.0, 8.0, 0.0]]
    from findnpropagate_torch.ops import _build

    src = (_build.CSRC / "gather_probes.cu").read_text()
    copy = src[src.index("void copy_ids("):src.index("IdIndex index_ids(")]
    assert copy.count("__trap()") == 2      # 16-byte pieces and the rest


# ------------------------------------------------- P3: the banded gather


def banded_call(c, w_blk, band_tiles, taps, s_win, nb, starts, feats, rel,
                wt):
    """bench_banded_taa's kernel and grid (probe_posgather.py :82-:139)."""
    ot_n = w_blk // 128

    def kernel(starts_ref, feats_ref, rel_ref, w_ref, o_ref, gbuf):
        i = pl.program_id(0)
        for k in range(taps):
            for ot in range(ot_n):
                off = pl.multiple_of(starts_ref[i, k, ot], 128)
                band = feats_ref[:, pl.ds(off, band_tiles * 128)]
                idx = rel_ref[k, pl.ds(ot * 128, 128)]
                idxb = jnp.broadcast_to(idx[None, :], (c, 128))
                acc = jnp.zeros((c, 128), jnp.bfloat16)
                for bt in range(band_tiles):
                    tile = band[:, bt * 128:(bt + 1) * 128]
                    g = jnp.take_along_axis(
                        tile, jnp.clip(idxb - bt * 128, 0, 127), axis=1)
                    acc = jnp.where(
                        (idxb >= bt * 128) & (idxb < (bt + 1) * 128),
                        g, acc)
                gbuf[k * c:(k + 1) * c, ot * 128:(ot + 1) * 128] = acc
        o_ref[:] = jnp.dot(w_ref[:], gbuf[:],
                           preferred_element_type=jnp.float32
                           ).astype(o_ref.dtype)

    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(nb,),
        in_specs=[VMEM(), VMEM(), VMEM()],
        out_specs=pl.BlockSpec((c, w_blk), lambda i, *_: (0, i),
                               memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((taps * c, w_blk), jnp.bfloat16)])
    return pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct((c, nb * w_blk),
                                               jnp.bfloat16),
        grid_spec=grid_spec, interpret=True)(starts, feats, rel, wt)


def banded_inputs(c, w_blk, band_tiles, taps, s_win, nb):
    """bench_banded_taa's inputs (numpy seed 0)."""
    rng = np.random.RandomState(0)
    feats = jnp.asarray(rng.randn(c, s_win).astype(np.float32)).astype(
        jnp.bfloat16)
    rel = jnp.asarray(rng.randint(0, band_tiles * 128, (taps, w_blk))
                      .astype(np.int32))
    starts = jnp.asarray((rng.randint(
        0, (s_win - band_tiles * 128) // 128,
        (nb, taps, w_blk // 128)) * 128).astype(np.int32))
    wt = jnp.asarray(rng.randn(c, taps * c).astype(np.float32)).astype(
        jnp.bfloat16)
    return starts, feats, rel, wt


@pytest.mark.parametrize("band", [2, 3, 4])
def test_banded_gather_conv_matches_probe(band):
    shape = (C, 128, band, TAPS, 1024, 2)     # c, w_blk, band, taps, S, nb
    starts, feats, rel, wt = banded_inputs(*shape)
    ref = banded_call(*shape, starts, feats, rel, wt)
    got = GP.banded_gather_conv(*map(jax_to_torch, (starts, feats, rel, wt)),
                                band)
    assert got.shape == (C, 2 * 128) and got.dtype == torch.bfloat16
    assert_bf16_close(got, ref)


def test_band_positions_expand_per_tile_starts():
    """Per (block, tap, 128-target tile) starts become per-target columns;
    rel outside the band or a column outside the input gathers nothing."""
    starts = torch.tensor([[[0, 256]], [[128, 900]]], dtype=torch.int32)
    starts = starts.expand(2, 1, 2).contiguous()
    starts[1, 0, 1] = 900
    rel = torch.zeros(1, 256, dtype=torch.int32)
    rel[0, :4] = torch.tensor([5, -1, 256, 255], dtype=torch.int32)
    rel[0, 128:131] = torch.tensor([0, 99, 100], dtype=torch.int32)
    pos = GP.band_positions(starts, rel, 2, 1000)
    assert pos.shape == (2, 1, 256)
    assert pos[0, 0, :4].tolist() == [5, -1, -1, 255]
    assert pos[0, 0, 128:131].tolist() == [256, 355, 356]
    assert pos[1, 0, :4].tolist() == [133, -1, -1, 383]
    assert pos[1, 0, 128:131].tolist() == [900, 999, -1]


def ldmatrix_b_fragments(wt):
    """What the P2 / P3 kernels' ldmatrix.x4 reads from the plain (Cout,
    T*C) bf16 weights staged row-major, per 16-channel k-slab (a tap) and
    n-tile of 8 output channels: lane l gives the address of row l%8 of
    block l/8 (output channel (l%8) + 8(l/16), input channels 8((l/8)%2)..
    of the slab) and receives, of each block, row l/4, columns 2(l%4) and
    2(l%4)+1. Returns (slabs, n-tiles, 32 lanes, 4): b0 then b1 of each
    n-tile, two values each."""
    cout, k = wt.shape
    out = torch.empty(k // 16, cout // 8, 32, 4, dtype=wt.dtype)
    for ks in range(k // 16):
        blocks = []
        for j in range(4):                    # the x4 blocks, in order
            rows = [(r + 8 * (j >> 1), ks * 16 + 8 * (j & 1))
                    for r in range(8)]        # the addresses lanes 8j.. give
            blocks.append(torch.stack([wt[n, c0:c0 + 8] for n, c0 in rows]))
        for lane in range(32):
            got = [blocks[j][lane // 4, 2 * (lane % 4) + e]
                   for j in range(4) for e in range(2)]
            out[ks, 0, lane] = torch.stack(got[0:4])
            out[ks, 1, lane] = torch.stack(got[4:8])
    return out


def test_weights_packed_as_the_transposed_matrix():
    """P2's weight stage and P3 stage the plain (Cout, T*C) weights: read
    by ldmatrix they give the B fragments of the (T*C, Cout) matrix (row
    k*C + c) in exactly the order that K2's tile body takes packed
    (`pack_weights_mma`), so no per-call packing is needed."""
    rng = np.random.RandomState(1)
    wt = torch.from_numpy(rng.randn(16, 48).astype(np.float32)).to(
        torch.bfloat16)
    got = ldmatrix_b_fragments(wt)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 2, 32, 4)
    assert torch.equal(got, pack_weights_mma(wt.t().contiguous()))
    # slab 0, n-tile 0: lane 0 holds rows 0, 1, 8, 9 of column 0
    assert got[0, 0, 0].tolist() == wt[0, [0, 1, 8, 9]].tolist()


# ------------------------------------------ the CUDA branch, faked library


class _FakeLib:
    """Stands in for the CUDA library: records each C call, returns 0."""

    def __init__(self):
        self.calls = []
        for name in ("fp_take_along", "fp_onehot_gather",
                     "fp_banded_gather_conv"):
            setattr(self, name, self._recorder(name))

    def _recorder(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_lib(monkeypatch):
    fake = _FakeLib()
    monkeypatch.setattr(GP, "_check_device", lambda *t: True)
    monkeypatch.setattr(GP, "_lib", lambda: fake)
    monkeypatch.setattr(GP, "_stream", lambda: None)
    monkeypatch.setattr(GP, "_ptr", lambda t: t)
    GP.reset_launches()
    return fake


def test_cuda_wrappers_pass_sizes_and_strides(fake_lib):
    """The CUDA branch of the three wrappers on CPU tensors: each C entry
    gets the sizes and index strides it reads, each launch counts once,
    and what the kernels do not take raises."""
    x = torch.zeros(16, 256, dtype=torch.bfloat16)
    idx = torch.zeros(27, 128, dtype=torch.int32)
    out = GP.take_along(x, idx, 1, taps=True)
    assert out.shape == (27 * 16, 128)
    out = GP.take_along(x.t().contiguous(), idx, 0, taps=True)
    assert out.shape == (128, 27 * 16)
    GP.take_along(x.float(), idx[:1], 1)                 # (1, W) broadcast
    (_, a), (_, b), (_, c) = fake_lib.calls
    # fp_take_along(x, idx, out, elem, axis, rows, cols, T, M, N, strides)
    assert a[3:13] == (2, 1, 16, 256, 27, 16, 128, 128, 0, 1)
    assert b[3:13] == (2, 0, 256, 16, 27, 128, 16, 128, 1, 0)
    assert c[3:13] == (4, 1, 16, 256, 1, 16, 128, 0, 0, 1)

    ids = torch.arange(256, dtype=torch.int32) * 3
    wt = torch.zeros(16, 27 * 16, dtype=torch.bfloat16)
    out = GP.onehot_gather(x, ids, idx, tap_win=192, wt=wt, blocks=3)
    assert out.shape == (16, 3 * 128)
    _, d = fake_lib.calls[-1]
    # fp_onehot_gather(x, ids, want, wt, out, c, s, n_ids, taps, w, cout,
    #                  blocks, weighted, stream): the caller's x and wt
    assert d[0] is x and d[3] is wt
    assert d[5:13] == (16, 256, 192, 27, 128, 16, 3, 1)
    out = GP.onehot_gather(x, ids, idx)
    _, d = fake_lib.calls[-1]
    assert out.shape == (27 * 16, 128) and d[3] is None and d[12] == 0
    # the kernel tests the ids' order on the device (it traps on a
    # violation): the wrapper reads nothing back and passes them as given
    flipped = ids.flip(0)
    GP.onehot_gather(x, flipped, idx)
    assert fake_lib.calls[-1][1][1] is flipped
    with pytest.raises(ValueError):
        GP.onehot_gather(x, ids, idx[:, :100])            # W % 128
    with pytest.raises(ValueError):
        GP.onehot_gather(x, ids, idx, blocks=3)           # blocks need wt
    with pytest.raises(ValueError):
        GP.onehot_gather(x, ids, idx, tap_win=192)        # so does tap_win
    with pytest.raises(ValueError):                       # C 32
        GP.onehot_gather(torch.zeros(32, 256, dtype=torch.bfloat16), ids,
                         idx, wt=torch.zeros(16, 27 * 32,
                                             dtype=torch.bfloat16))
    with pytest.raises(ValueError):                       # C 32, no wt
        GP.onehot_gather(torch.zeros(32, 256, dtype=torch.bfloat16), ids,
                         idx)

    starts = torch.zeros(5, 27, 1, dtype=torch.int32)
    out = GP.banded_gather_conv(starts, x, idx, wt, 3)
    assert out.shape == (16, 5 * 128)
    _, e = fake_lib.calls[-1]
    assert e[5:12] == (16, 256, 27, 128, 16, 5, 3)
    with pytest.raises(ValueError):
        GP.banded_gather_conv(starts, x, idx, wt[:10], 3)  # Cout 10
    with pytest.raises(ValueError):
        GP.take_along(x, idx.long(), 1, taps=True)
    assert GP.LAUNCHES == {"take_along": 3, "onehot_gather": 3,
                           "banded_gather_conv": 1}


def window_call(name, rows, taps=27):
    """A P2 / P3 wrapper call with a window of `rows` rows (ids for P2,
    input columns for P3) at `taps` taps: (fn, the caller's tensors in the
    order of the C entry's first four pointers, None for no weights)."""
    x = torch.zeros(16, rows, dtype=torch.bfloat16)
    ids = torch.arange(rows, dtype=torch.int32)
    want = torch.zeros(taps, 128, dtype=torch.int32)
    wt = torch.zeros(16, taps * 16, dtype=torch.bfloat16)
    if name == "P2 without weights":
        return lambda: GP.onehot_gather(x, ids, want), (x, ids, want, None)
    if name == "P2 with weights":
        return (lambda: GP.onehot_gather(x, ids, want, tap_win=rows, wt=wt,
                                         blocks=2), (x, ids, want, wt))
    starts = torch.zeros(2, taps, 1, dtype=torch.int32)
    return (lambda: GP.banded_gather_conv(starts, x, want, wt, 3),
            (starts, x, want, wt))


WINDOWS = {
    # name: (its limit at `taps` taps, the shared memory a window takes)
    "P2 without weights": (lambda taps: GP.max_ids(), lambda n: 4 * n),
    "P2 with weights": (lambda taps: GP.max_window(taps, True),
                        lambda n, taps: GP.window_smem(n, n, taps)),
    "P3": (lambda taps: GP.max_window(taps, False),
           lambda n, taps: GP.window_smem(n, 0, taps)),
}


@pytest.mark.parametrize("name", sorted(WINDOWS))
@pytest.mark.parametrize("taps", [27, 9])
def test_wrappers_refuse_windows_beyond_shared_memory(fake_lib, name, taps):
    """A window that fits in a block's dynamic shared memory launches, one
    row more raises ValueError before any launch; the limits are
    window_smem's and, for P2 without weights, the ids' (at 27 taps 58112
    ids for P2 without weights, 5609 with them, 6567 columns for P3)."""
    limit_of, smem = WINDOWS[name]
    limit = limit_of(taps)
    args = (limit,) if name == "P2 without weights" else (limit, taps)
    assert smem(*args) <= GP.SMEM_MAX
    if taps == 27:
        assert limit == {"P2 without weights": 58112,
                         "P2 with weights": 5609, "P3": 6567}[name]
    window_call(name, limit, taps)[0]()
    assert len(fake_lib.calls) == 1
    with pytest.raises(ValueError, match="shared memory"):
        window_call(name, limit + 1, taps)[0]()
    assert len(fake_lib.calls) == 1


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_wrappers_hand_the_kernel_the_callers_tensors(fake_lib, name):
    """No transposed, packed or contiguous copy per call: the C entry gets
    the caller's own tensors (features (C, S) as given, plain weights), and
    one output."""
    fn, given = window_call(name, 2048)
    out = fn()
    (_, args), = fake_lib.calls
    assert all(a is g for a, g in zip(args[:4], given)) and args[4] is out


TAKE_CASES = {
    # name: (x shape, dtype, idx, axis, taps, the expand view it stands for)
    "taps axis 1, vectors": (
        (16, 256), torch.bfloat16, lambda: torch.zeros(27, 128), 1, True,
        lambda i: i[:, None, :].expand(27, 16, 128)),
    "taps axis 0, row copies": (
        (256, 16), torch.float32, lambda: torch.zeros(27, 128), 0, True,
        lambda i: i[:, :, None].expand(27, 128, 16)),
    "taps axis 1, tail n = 13": (
        (16, 64), torch.bfloat16, lambda: torch.zeros(5, 13), 1, True,
        lambda i: i[:, None, :].expand(5, 16, 13)),
    "taps axis 0, tail cols = 13": (
        (64, 13), torch.bfloat16, lambda: torch.zeros(5, 7), 0, True,
        lambda i: i[:, :, None].expand(5, 7, 13)),
    "axis 1, a row broadcast": (
        (16, 64), torch.float32, lambda: torch.zeros(1, 20), 1, False,
        lambda i: i.expand(16, 20)[None]),
    "axis 1, full": (
        (16, 64), torch.float32, lambda: torch.zeros(16, 21), 1, False,
        lambda i: i[None]),
    "axis 0, a column broadcast": (
        (64, 16), torch.float32, lambda: torch.zeros(30, 1), 0, False,
        lambda i: i.expand(30, 16)[None]),
    "axis 0, a transposed row": (
        (64, 16), torch.float32, lambda: torch.zeros(1, 30).t(), 0, False,
        lambda i: i.expand(30, 16)[None]),
    "taps axis 1, rows 2-6 of 8": (
        (16, 64), torch.bfloat16,
        lambda: torch.arange(8 * 40, dtype=torch.int32).reshape(8, 40)[2:7],
        1, True,
        lambda i: i[:, None, :].expand(5, 16, 40)),
}


@pytest.mark.parametrize("name", sorted(TAKE_CASES))
def test_take_along_wrapper_sizes_and_strides(fake_lib, name):
    """P1's CUDA branch on CPU tensors: the sizes and index strides the
    kernel gets are those of the expand view each form stands for (stride 0
    where an index is broadcast, the index's own strides and offset
    otherwise), the kernel reads the index in place, and the output has the
    stacked shape."""
    shape, dtype, make, axis, taps, view = TAKE_CASES[name]
    x = torch.zeros(shape, dtype=dtype)
    idx = make().to(torch.int32)            # keeps the view's strides
    out = GP.take_along(x, idx, axis, taps=taps)
    (_, a), = fake_lib.calls
    want = view(idx)
    t, m, n = want.shape
    assert a[1] is idx and a[3:10] == (x.element_size(), axis, *shape, t, m,
                                       n)
    assert all(got == st for got, st, e in zip(a[10:13], want.stride(),
                                                want.shape) if e > 1)
    assert torch.equal(GP.index3(x, idx, axis, taps), want)
    assert GP.index3(x, idx, axis, taps).data_ptr() == idx.data_ptr()
    if name.endswith("of 8"):
        assert idx.storage_offset() == 80
    assert out.dtype == dtype and out.shape == (
        (t * m, n) if axis == 1 else (m, t * n))
    assert GP.LAUNCHES["take_along"] == 1


def test_take_along_refuses_what_does_not_broadcast(fake_lib):
    x = torch.zeros(16, 64)
    with pytest.raises(ValueError, match="broadcast"):
        GP.take_along(x, torch.zeros(4, 20, dtype=torch.int32), 1)
    with pytest.raises(ValueError, match="broadcast"):
        GP.take_along(x.t().contiguous(),
                      torch.zeros(30, 4, dtype=torch.int32), 0)
    with pytest.raises(ValueError, match="2-D"):
        GP.take_along(x, torch.zeros(20, dtype=torch.int32), 1)
    assert not fake_lib.calls


# ------------------------------------------------ the ported entry points


ENTRY_POINTS = {
    "probe_gather": ["--device", "cpu", "--s", "256", "--w", "128"],
    "probe_gather2": ["--device", "cpu", "--s", "256", "--w", "128"],
    "probe_gather3": ["--device", "cpu"],
    "probe_posgather": ["--device", "cpu", "--v", "4096", "--nb", "2",
                        "--s", "1024", "--w", "256", "--tap-win", "384"],
    "probe_posgather2": ["--device", "cpu", "--mode", "cpu"],
    "probe_posgather3": ["--device", "cpu", "--max-v", "2048"],
}


def entry(name):
    import importlib

    return importlib.import_module(f"findnpropagate_torch.tools.{name}")


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_cpu(name, capsys):
    """Each ported probe at small sizes on the CPU (plain versions): exit
    0, a line per variant, nothing timed."""
    assert entry(name).main(ENTRY_POINTS[name]) == 0
    out = capsys.readouterr().out
    assert "FAIL" not in out and "WRONG" not in out
    if name != "probe_posgather2":
        assert "correct=True" in out and "not measured" in out
        assert " ms " not in out


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_needs_cuda_unless_told(name, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert entry(name).main([]) == 2
    assert "--device cpu" in capsys.readouterr().out


def test_entry_point_fails_on_a_wrong_or_failed_variant(monkeypatch,
                                                        capsys):
    """A variant whose output differs, or whose launch raises, makes the
    probe exit non-zero after it has run the others."""
    plain = GP.take_along

    def wrong(x, idx, axis, taps=False):
        out = plain(x, idx, axis, taps)
        return out + 1 if x.shape == (8, 1024) else out
    monkeypatch.setattr(GP, "take_along", wrong)
    assert entry("probe_gather3").main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "(8,1024)" in out and "correct=False" in out
    assert out.count("correct=True") == 5

    def boom(*a, **k):
        raise RuntimeError("fp_banded_gather_conv: CUDA error 700")
    monkeypatch.setattr(GP, "banded_gather_conv", boom)
    assert entry("probe_posgather").main(
        ENTRY_POINTS["probe_posgather"]) == 1
    out = capsys.readouterr().out
    assert out.count("FAILED RuntimeError") == 3
    assert "onehot 27taps tapwin384 2blk" in out


def test_probe_kernels_build_from_the_shared_header():
    """gather_probes.cu runs K2's tile body: its library is rebuilt when
    gather_mma.cuh changes."""
    from findnpropagate_torch.ops import _build

    assert [f.name for f in _build.source_files(
        _build.CSRC / "gather_probes.cu")] == ["gather_probes.cu",
                                               "gather_mma.cuh"]


@pytest.mark.parametrize("name", sorted(
    __import__("findnpropagate_torch.tools.probe_window_parts",
               fromlist=["CUTS"]).CUTS))
def test_window_parts_cuts_apply_to_the_source(name):
    """Each cut of probe_window_parts replaces text that the probe kernels'
    source holds exactly once, so the probe times what it names."""
    from findnpropagate_torch.ops import _build
    from findnpropagate_torch.tools import probe_window_parts as pw

    src = (_build.CSRC / "gather_probes.cu").read_text()
    cut = pw.cut_source(src, name)
    assert cut != src


def test_window_parts_needs_cuda(monkeypatch, capsys):
    from findnpropagate_torch.tools import probe_window_parts as pw

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert pw.main([]) == 2
    assert "card" in capsys.readouterr().out
