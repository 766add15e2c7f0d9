"""In-kernel gathers at sparse-conv shapes — port of the Pallas kernels of
the gather probes, tools/probe_gather.py (:52, :127, :175),
tools/probe_gather2.py (:29), tools/probe_gather3.py (:29) and
tools/probe_posgather.py (:139, :203).

Three kernels carry them (ops/csrc/gather_probes.cu):
  * P1 `take_along` — ``jnp.take_along_axis`` on a 2-D array along axis 0
    or 1, f32 or bf16: an index whose extent on the gather axis differs
    from the input's, an index broadcast along the other axis (any stride,
    0 included: pass ``idx.expand(...)``), and a stacked-tap form
    (``taps=True``) that gives T gathers in one launch — along axis 1 the
    T results stacked on rows (probe_gather.py's ``take`` variants), along
    axis 0 side by side on columns (its sublane variant). Indices count
    from the end when negative; out of range they give NaN, as
    ``jnp.take_along_axis`` does;
  * P2 `onehot_gather` — the probes' one-hot compare+matmul gather: for
    each tap k and target w, the sum over the first `tap_win` ids s of
    ``x[:, s] * [ids[s] == want[k, w]]`` in f32, rounded to x's type
    (bf16); 0 on a miss. With `wt` the (Cout, T*C) weights multiply the
    rounded (T*C, W) tile in one more stage (f32 sums, bf16 result), once
    for each of `blocks` output blocks, as the probe's grid does; the
    kernel takes `tap_win` and `blocks` only with the weight stage.
    The kernel searches each target's id among the ids staged in shared
    memory instead of building one-hot tiles, so it needs the ids sorted
    and unique: it tests them while it stages them and traps otherwise (the
    launch fails, and the next synchronisation raises). The plain version
    sums duplicates, as the matmul does;
  * P3 `banded_gather_conv` — probe_posgather.py's banded gather: for block
    i, tap k and target t the source column ``starts[i, k, t // 128] +
    rel[k, t]`` (nothing where rel lies outside the band [0, band*128) or
    the column outside the input), then ``wt . gathered`` with f32 sums,
    rounded to bf16.

P2 and P3 take C = Cout = 16 only, the width the probes run. P2's weight
stage and P3 stage the window once in shared memory, as rows of 16
channels read from the (C, S) input as given, with the plain (Cout, T*C)
weights and P2's ids, and feed the tensor cores from it with ldmatrix; P2
without weights stages only its ids and gathers from the input
(csrc/gather_probes.cu). The wrappers hand the kernels the caller's
tensors, with no transposed or packed copy. What does not fit in a
block's shared memory raises ValueError (`window_smem`, `max_window`,
`max_ids`: at 27 taps 5609 ids for P2 with weights, 6567 columns for
P3, 58112 ids for P2 without weights); there is no unstaged path. Each
kernel has a plain PyTorch version beside it; a wrapper takes the plain
version only for a tensor on the CPU, for a CUDA tensor it launches the
kernel or raises. `LAUNCHES` counts kernel launches per wrapper.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .posgather import _check_device, _check_shape, _ptr, _stream

TILE = 128               # W % TILE == 0; P3's starts are per TILE targets
LAUNCHES = {"take_along": 0, "onehot_gather": 0, "banded_gather_conv": 0}
WIDTH = 16               # P2 and P3: C = Cout = 16
WARPS = 16               # warps of a P2 / P3 block, a store tile each
SMEM_MAX = 227 * 1024    # dynamic shared memory of an H100 block


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = _build.load("gather_probes")
    if lib.fp_take_along.argtypes is None:
        lib.fp_take_along.argtypes = [ctypes.c_void_p] * 3 \
            + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        lib.fp_take_along.restype = ctypes.c_int
        lib.fp_onehot_gather.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.fp_onehot_gather.restype = ctypes.c_int
        lib.fp_banded_gather_conv.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.fp_banded_gather_conv.restype = ctypes.c_int
    return lib


def _check_int32(name, t):
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32, got {t.dtype}")


def _check_widths(c, cout):
    if (c, cout) != (WIDTH, WIDTH):
        raise ValueError(f"{c} -> {cout} channels: the kernel takes the "
                         f"probes' {WIDTH} -> {WIDTH}")


def ids_smem(n_ids: int) -> int:
    """Bytes of shared memory the ids of P2 with weights take staged
    (csrc/gather_probes.cu ids_smem): n_ids int32 and their search index, a
    uint16 start per bucket (a power of two of buckets, at most n_ids) and
    one more."""
    if not n_ids:
        return 0
    return 4 * n_ids + 2 * ((1 << (n_ids.bit_length() - 1)) + 1)


def window_smem(rows: int, n_ids: int, taps: int) -> int:
    """Bytes of shared memory a block of P2 with weights or P3 stages
    (csrc/gather_probes.cu window_smem): `rows` window rows of 16 bf16
    channels and a zero row, the (16, taps*16) bf16 weights (rows padded by
    16 bytes), a 16 x 16 bf16 store tile per warp, and P2's ids
    (`ids_smem`)."""
    return ((rows + 1) * 2 * WIDTH + WIDTH * (taps * WIDTH * 2 + 16)
            + WARPS * WIDTH * WIDTH * 2 + ids_smem(n_ids))


def _largest(fits, hi):
    """The largest n in [0, hi] with fits(n), for fits monotone."""
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def max_window(taps: int, ids: bool) -> int:
    """The most window rows that fit in SMEM_MAX (`window_smem`), with an
    id staged beside each row (P2 with weights) or none (P3)."""
    return _largest(lambda n: window_smem(n, n if ids else 0, taps)
                    <= SMEM_MAX, SMEM_MAX // (2 * WIDTH))


def max_ids() -> int:
    """The most ids P2 without weights stages (int32, nothing else)."""
    return SMEM_MAX // 4


def _check_fits(name, need, rows, limit, taps):
    """Raise unless `need` bytes fit in a block; limit() gives the most
    rows that do (computed only then)."""
    if need > SMEM_MAX:
        raise ValueError(
            f"{name}: a window of {rows} rows needs {need} bytes of shared "
            f"memory, more than the {SMEM_MAX} of a block: at most {limit()}"
            f" at {taps} taps")


# ----------------------------------------------------------------- P1


def index_strides(x, idx, axis: int, taps: bool = False):
    """((T, M, N), strides): the (T, M, N) index view the kernel reads, with
    stride 0 where it is broadcast: the gather of output element (t, i, j)
    reads x[i, idx3[t, i, j]] (axis 1) or x[idx3[t, i, j], j] (axis 0).

    Without taps idx is 2-D and broadcasts (extent 1) on the axis other
    than `axis`; its extent on `axis` is the output's. With taps idx is
    (T, N): along axis 1 gather t of x's rows takes idx[t] (M = x's rows);
    along axis 0 it takes rows idx[t] of x (M = N, N = x's columns)."""
    if x.dim() != 2 or idx.dim() != 2 or axis not in (0, 1):
        raise ValueError(f"take_along wants 2-D x and idx and axis 0 or 1, "
                         f"got {tuple(x.shape)}, {tuple(idx.shape)}, {axis}")
    rows, cols = x.shape
    (a, b), (sa, sb) = idx.shape, idx.stride()
    if taps:
        if axis == 1:
            return (a, rows, b), (sa, 0, sb)
        return (a, b, cols), (sa, sb, 0)
    other = rows if axis == 1 else cols
    if (b if axis == 0 else a) not in (1, other):
        raise ValueError(f"take_along: index {tuple(idx.shape)} does not "
                         f"broadcast against x {tuple(x.shape)} on axis "
                         f"{1 - axis}")
    if axis == 1:
        return (1, rows, b), (0, sa if a != 1 else 0, sb)
    return (1, a, cols), (0, sa, sb if b != 1 else 0)


def index3(x, idx, axis: int, taps: bool = False):
    """idx as the (T, M, N) view the kernel reads (`index_strides`)."""
    return idx.as_strided(*index_strides(x, idx, axis, taps))


def _stacked(g, axis):
    """(T, M, N) gathers -> the output layout: along axis 1 the T results
    stacked on rows (T*M, N), along axis 0 side by side (M, T*N)."""
    t, m, n = g.shape
    if axis == 1:
        return g.reshape(t * m, n)
    return g.permute(1, 0, 2).reshape(m, t * n)


def take_along_plain(x, idx, axis: int, taps: bool = False):
    """Plain version of P1 (see `take_along`)."""
    i3 = index3(x, idx, axis, taps).long()
    t, m, n = i3.shape
    length = x.shape[axis]
    i3 = torch.where(i3 < 0, i3 + length, i3)
    ok = (i3 >= 0) & (i3 < length)
    g = torch.gather(x[None].expand(t, *x.shape), axis + 1,
                     torch.clamp(i3, 0, length - 1))
    g = torch.where(ok, g, torch.full_like(g, float("nan")))
    return _stacked(g, axis)


def take_along(x, idx, axis: int, taps: bool = False):
    """P1 wrapper: ``jnp.take_along_axis(x, idx, axis)`` for 2-D x (f32 or
    bf16) with idx broadcast on the other axis, or with ``taps=True`` T such
    gathers of one (T, N) index in one launch (`index_strides`, `_stacked`).
    Negative indices count from the end; out of range they give NaN."""
    if not _check_device(x, idx):
        return take_along_plain(x, idx, axis, taps)
    if x.dtype not in (torch.float32, torch.bfloat16) \
            or not x.is_contiguous():
        raise ValueError("take_along wants contiguous float32 or bfloat16 x")
    _check_int32("idx", idx)
    (t, m, n), strides = index_strides(x, idx, axis, taps)
    if t * m * n >= 2 ** 31 - 16 or x.numel() >= 2 ** 31:
        raise ValueError("take_along: more than 2^31 elements")
    out = torch.empty((t * m, n) if axis == 1 else (m, t * n),
                      dtype=x.dtype, device=x.device)
    _build.check(_lib().fp_take_along(
        _ptr(x), _ptr(idx), _ptr(out), x.element_size(), axis, *x.shape, t,
        m, n, *strides, _stream()), "fp_take_along")
    LAUNCHES["take_along"] += 1
    return out


# ----------------------------------------------------------------- P2


def onehot_gather_plain(x, ids, want, tap_win=None, wt=None, blocks=1):
    """Plain version of P2: the probe's one-hot matmul, tap by tap."""
    n = x.shape[1] if tap_win is None else tap_win
    xf = x[:, :n].float()
    g = torch.cat([xf @ (ids[:n, None] == want[k][None, :]).float()
                   for k in range(want.shape[0])]).to(x.dtype)
    if wt is not None:
        g = (wt.float() @ g.float()).to(x.dtype)
    return g.repeat(1, blocks)


def onehot_gather(x, ids, want, tap_win=None, wt=None, blocks=1):
    """P2 wrapper. x (C, S) bf16, ids (S,) int32, want (T, W) int32;
    tap_win (default S): only ids[:tap_win] are compared. Returns (T*C,
    blocks*W) bf16, or with wt (Cout, T*C) the weight product (Cout,
    blocks*W) bf16, one block per `blocks`. On the card: C = Cout = 16,
    W % 128 == 0, tap_win and blocks > 1 only with wt, ids[:tap_win] sorted
    unique (the kernel traps otherwise), and a window that fits
    (`max_window`, `max_ids`)."""
    if not _check_device(x, ids, want, *(() if wt is None else (wt,))):
        return onehot_gather_plain(x, ids, want, tap_win, wt, blocks)
    c, s = x.shape
    t, w = want.shape
    n = s if tap_win is None else int(tap_win)
    if x.dtype != torch.bfloat16 or ids.shape != (s,) or not 0 < n <= s \
            or t < 1 or w % TILE or blocks < 1 \
            or (wt is None and (n != s or blocks != 1)):
        raise ValueError(f"unsupported onehot_gather: x {tuple(x.shape)} "
                         f"{x.dtype}, ids {tuple(ids.shape)}, want "
                         f"{tuple(want.shape)}, tap_win {n}")
    _check_int32("ids", ids)
    _check_int32("want", want)
    cout = WIDTH if wt is None else wt.shape[0]
    _check_widths(c, cout)
    if wt is None:
        _check_fits("onehot_gather", 4 * n, n, max_ids, t)
    else:
        _check_shape("wt", wt, (cout, t * c))
        _check_fits("onehot_gather", window_smem(n, n, t), n,
                    lambda: max_window(t, True), t)
    # bound to names: a temporary freed inside the argument list could
    # hand its memory to the next one before the launch; none is made for
    # contiguous bf16 operands
    x, ids, want = x.contiguous(), ids.contiguous(), want.contiguous()
    if wt is not None:
        wt = wt.to(torch.bfloat16).contiguous()
    out = torch.empty(t * c if wt is None else cout, blocks * w,
                      dtype=x.dtype, device=x.device)
    _build.check(_lib().fp_onehot_gather(
        _ptr(x), _ptr(ids), _ptr(want), None if wt is None else _ptr(wt),
        _ptr(out), c, s, n, t, w, cout, blocks, int(wt is not None),
        _stream()), "fp_onehot_gather")
    LAUNCHES["onehot_gather"] += 1
    return out


# ----------------------------------------------------------------- P3


def band_positions(starts, rel, band: int, s: int):
    """(nb, T, W) source columns of P3, -1 where nothing is gathered: rel
    outside [0, band*128) or the column outside [0, s)."""
    pos = starts.long().repeat_interleave(TILE, dim=2) + rel.long()[None]
    ok = (rel >= 0)[None] & (rel < band * TILE)[None] & (pos >= 0) \
        & (pos < s)
    return torch.where(ok, pos, torch.full_like(pos, -1))


def banded_gather_conv_plain(starts, feats, rel, wt, band: int):
    """Plain version of P3: explicit positions, gather, one matmul."""
    c, s = feats.shape
    nb, t, _ = starts.shape
    w = rel.shape[1]
    pos = band_positions(starts, rel, band, s)               # (nb, T, W)
    g = feats[:, torch.clamp(pos, min=0)] * (pos >= 0)       # (C,nb,T,W)
    g = g.permute(1, 2, 0, 3).reshape(nb, t * c, w)
    out = (wt.float() @ g.float()).to(feats.dtype)           # (nb,Cout,W)
    return out.permute(1, 0, 2).reshape(wt.shape[0], nb * w)


def banded_gather_conv(starts, feats, rel, wt, band: int):
    """P3 wrapper. starts (nb, T, W/128) int32, feats (C, S) bf16, rel (T,
    W) int32, wt (Cout, T*C) -> (Cout, nb*W) bf16: for block i
    ``out[:, i*W + t] = sum_k wt[:, kC:(k+1)C] . feats[:, starts[i, k,
    t // 128] + rel[k, t]]``, nothing gathered where rel lies outside the
    band [0, band*128) or the column outside the input. On the card C =
    Cout = 16 and S at most `max_window` (6567 at 27 taps)."""
    if not _check_device(starts, feats, rel, wt):
        return banded_gather_conv_plain(starts, feats, rel, wt, band)
    c, s = feats.shape
    nb, t, tiles = starts.shape
    cout = wt.shape[0]
    _check_widths(c, cout)
    if feats.dtype != torch.bfloat16 or min(nb, t, tiles, band) < 1:
        raise ValueError(f"unsupported banded_gather_conv: feats "
                         f"{tuple(feats.shape)} {feats.dtype}, starts "
                         f"{tuple(starts.shape)}, band {band}")
    _check_int32("starts", starts)
    _check_int32("rel", rel)
    _check_shape("rel", rel, (t, tiles * TILE))
    _check_shape("wt", wt, (cout, t * c))
    _check_fits("banded_gather_conv", window_smem(s, 0, t), s,
                lambda: max_window(t, False), t)
    starts, feats, rel = starts.contiguous(), feats.contiguous(), \
        rel.contiguous()
    wt = wt.to(torch.bfloat16).contiguous()
    out = torch.empty(cout, nb * tiles * TILE, dtype=feats.dtype,
                      device=feats.device)
    _build.check(_lib().fp_banded_gather_conv(
        _ptr(starts), _ptr(feats), _ptr(rel), _ptr(wt), _ptr(out), c, s, t,
        tiles * TILE, cout, nb, band, _stream()), "fp_banded_gather_conv")
    LAUNCHES["banded_gather_conv"] += 1
    return out
