"""Union-window sparse convolution and its weight gradient — port of
findnpropagate_tpu/ops/pallas_sparse.py (`windowed_conv_pallas` :532,
`windowed_overflow` :240, `windowed_dw_pallas` :389,
`windowed_conv_pallas_diff` :471).

Two kernels carry it (ops/csrc/windowed_sparse.cu), both on the tensor
cores, and both search once per (target, (dy, dx) tap group) and take the
group's S z-taps from that one rank (`group_probe_rows` is the same route
in plain PyTorch), so the taps must be G <= 32 groups of S consecutive ids,
S the kernel's z size in {5, 3, 1} (`posgather.tap_groups`: 25 groups of
five for 5x5x5, 9 of three for 3x3x3, 9 of one for the (1, 3, 3) kernels
of a 2D level); the wrappers raise where they are not:
  * K3 `windowed_conv` — for each target and tap k, the source row whose id
    equals ``tgt + delta_k`` inside the target block's window
    ``src_ids[lo_b : lo_b + window)``, times ``W[k]``, summed over the taps,
    with the optional scale/shift(+ReLU) epilogue that also zeroes rows whose
    target id is >= ``sentinel``. The wrapper hands the kernel one bf16 copy
    of the features and the weights in group order packed for the mma
    fragments (`posgather.pack_weights_mma`), and picks its channel slices
    (`conv_slices`), ring and window staging (`conv_plan`);
  * K4 `windowed_dw` — ``dW[k] = sum_targets gathered_k^T . g`` over the
    whole batch, (K, Cin, Cout) float32, in channel slices (`dw_slices`).

Up to 256 channels in and out: a conv whose widths do not fit one block's
shared memory (or K4's accumulators) runs as one launch per channel slice,
each counted; K3 sums the Cin slices of a Cout slice in its output buffer.

Each has a plain PyTorch version beside it (`windowed_conv_plain`,
`windowed_dw_plain`). A wrapper takes the plain version only for a tensor
on the CPU; for a CUDA tensor it launches the kernel or raises. `LAUNCHES`
counts kernel launches per wrapper; under a profiler every K3 call (the
forward and transposed convs alike) records the span `windowed_conv` and
every `windowed_dw` the span `windowed_dw` (utils/trace.py).

The window starts ``lo`` are computed exactly as the reference computes
them, so a scene whose neighbour span overflows the window drops the same
neighbours in both packages; `windowed_overflow` counts such blocks. The
reference's per-tap sub-windows, sub-blocks, tap unrolling, 8-row channel
padding and one-hot compare are knobs of its TPU kernel with no effect on
the result while the overflow count is 0, and are not carried over —
`windowed_overflow` alone still takes ``tap_window`` so the reference's tap
term can be reproduced. All functions take a leading batch axis (the
reference vmaps single-sample functions); the weight gradient is summed
over the batch, as the vmapped reference's is.

`WindowedConv` is the differentiable form: forward K3, backward K3 on the
swapped id lists with the taps reversed and negated and the weights
flipped and transposed (`posgather.flip_transpose_weights`: the same
(delta, weight) pairs, in group order) for ``d_feats``, plus K4 for ``dW``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import trace
from . import _build
from .posgather import (
    CONV_SLICE,
    _check_device,
    _check_ids,
    _check_shape,
    _ptr,
    _stream,
    channel_slices,
    flip_transpose_weights,
    pack_weights_mma,
    reorder_weights_groups,
    tap_groups,
)

ALIGN = 512
LAUNCHES = {"windowed_conv": 0, "windowed_dw": 0}
DW_TILE = 64             # targets per tile of the K4 kernel
DW_BLOCKS = 2 * 132      # blocks its grid aims at: two per SM of an H100
MAX_DW_ACC = 8192        # Cin * Cout of a K4 launch (S * that f32 sums
MAX_DW_ACC5 = 4096       # in registers); at S = 5
CONV_TILE = 128          # targets per K3 tile
RESIDENT_MAX = 112 * 1024   # K3 keeps all groups' weights up to this
SMEM_MAX = 227 * 1024       # shared memory of one block on an H100


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = _build.load("windowed_sparse")
    if lib.fp_windowed_conv.argtypes is None:
        lib.fp_windowed_conv.argtypes = [ctypes.c_void_p] * 9 \
            + [ctypes.c_int] * 17 + [ctypes.c_void_p]
        lib.fp_windowed_conv.restype = ctypes.c_int
        lib.fp_windowed_dw.argtypes = [ctypes.c_void_p] * 8 \
            + [ctypes.c_int] * 11 + [ctypes.c_void_p]
        lib.fp_windowed_dw.restype = ctypes.c_int
    return lib


def _pad_src(src_ids, feats, multiple=ALIGN):
    """Pad the source list to an ALIGN multiple with ascending ids above
    the last (and zero features), as the reference does."""
    pad = (-src_ids.shape[1]) % multiple
    if not pad:
        return src_ids, feats
    ext = src_ids[:, -1:] + 1 + torch.arange(
        pad, dtype=src_ids.dtype, device=src_ids.device)
    src_ids = torch.cat([src_ids, ext], dim=1)
    feats = torch.cat(
        [feats, feats.new_zeros(feats.shape[0], pad, feats.shape[2])], dim=1)
    return src_ids, feats


def _round_window(window, vs):
    window = -(-(min(window, vs) + ALIGN) // ALIGN) * ALIGN
    return min(window, vs)


def window_starts(src_ids, tgt_ids, deltas, block: int, window: int):
    """(B, nb) int32 ALIGN-aligned window starts: the left insertion point
    of (first target of the block + smallest delta), floored to ALIGN and
    clamped so the window stays inside the list. Deltas kept on the host
    give their minimum without waiting for the stream."""
    vs = src_ids.shape[1]
    first = tgt_ids[:, ::block].long() + int(deltas.min())
    lo = torch.searchsorted(src_ids.long(), first.contiguous())
    lo_max = max(((vs - window) // ALIGN) * ALIGN, 0)
    lo = torch.clamp(torch.div(lo, ALIGN, rounding_mode="floor") * ALIGN,
                     max=lo_max)
    return lo.to(torch.int32).contiguous()


def _union_overflow(src_ids, tgt_ids, deltas, lo, block, window,
                    sentinel_start, tap_window=None):
    """The overflow rule, given the window starts `lo` (B, nb) of a
    `window`-wide window: (B,) int64 blocks with a real target whose
    neighbour span ends beyond the window, plus the tap term. `deltas` is
    a long tensor, best on the host (see `window_starts`)."""
    b, vt = tgt_ids.shape
    lo = lo.long()
    src_l = src_ids.long()
    tgt_b = tgt_ids.reshape(b, vt // block, block).long()
    if sentinel_start is not None:
        real_b = tgt_b < sentinel_start
        block_last = torch.where(
            real_b, tgt_b, torch.full_like(tgt_b, -2 ** 31)).amax(dim=2)
        has_real = real_b.any(dim=2)
    else:
        block_last = tgt_b[:, :, -1]
        has_real = torch.ones_like(block_last, dtype=torch.bool)
    hi = torch.searchsorted(
        src_l, (block_last + int(deltas.max())).contiguous(), right=True)
    total = (((hi - lo) > window) & has_real).sum(dim=1)
    if tap_window is not None and tap_window < window:
        deltas = deltas.to(src_l.device)
        nb = lo.shape[1]
        first = tgt_b[:, :, 0]
        lo_tap = torch.searchsorted(
            src_l, (first[..., None] + deltas).reshape(b, -1)
        ).reshape(b, nb, -1)
        rel = torch.clamp(
            torch.div(lo_tap - lo[..., None], 128, rounding_mode="floor")
            * 128, 0, window - tap_window)
        hi_tap = torch.searchsorted(
            src_l, (block_last[..., None] + deltas).reshape(b, -1),
            right=True).reshape(b, nb, -1)
        total = total + (((hi_tap - (lo[..., None] + rel)) > tap_window)
                         & has_real[..., None]).sum(dim=(1, 2))
    return total


def windowed_overflow(src_ids, tgt_ids, deltas, block: int, window: int,
                      sentinel_start=None, tap_window=None):
    """(B,) int64: target blocks whose true neighbour span exceeds
    `window`, plus — when `tap_window` is given and smaller — (block, tap)
    pairs whose span exceeds the reference's per-tap sub-window. src_ids
    (B, Vs) / tgt_ids (B, Vt) ascending int32; deltas (K,) int."""
    deltas = torch.as_tensor(deltas).long()
    window = min(window, src_ids.shape[1])
    lo = window_starts(src_ids, tgt_ids, deltas, block, window)
    return _union_overflow(src_ids, tgt_ids, deltas, lo, block, window,
                           sentinel_start, tap_window)


# ----------------------------------------------------------------- K3


def neighbour_rows(src_ids, tgt_ids, lo, deltas, block: int, window: int):
    """For every (tap, target): (rows (B, K, Vt) into the source list,
    found (B, K, Vt) bool) — the row whose id is ``tgt + delta_k`` inside
    the block's window, by torch.searchsorted over the window slice."""
    b, vt = tgt_ids.shape
    nb = vt // block
    k = deltas.shape[0]
    idx = lo.long()[..., None] + torch.arange(window, device=tgt_ids.device)
    win = torch.gather(src_ids.long()[:, None, :].expand(
        b, nb, src_ids.shape[1]), 2, idx).contiguous()          # (B,nb,S)
    want = (tgt_ids.long().reshape(b, nb, 1, block)
            + deltas.long()[None, None, :, None])               # (B,nb,K,W)
    r = torch.searchsorted(win, want.reshape(b, nb, k * block))
    found = torch.gather(win, 2, torch.clamp(r, max=window - 1)) \
        == want.reshape(b, nb, k * block)
    found = found & (r < window)
    rows = torch.clamp(r, max=window - 1) + lo.long()[..., None]
    shape = (b, nb, k, block)
    rows = rows.reshape(shape).permute(0, 2, 1, 3).reshape(b, k, vt)
    found = found.reshape(shape).permute(0, 2, 1, 3).reshape(b, k, vt)
    return rows, found


def group_probe_rows(src_ids, tgt_ids, lo, centres, block: int, window: int,
                     taps: int = 3):
    """`neighbour_rows` for taps that are G groups of `taps` consecutive
    ids, by the kernels' route: one search per (target, group) for the
    middle id ``tgt + centres[g]``, then the middle at that rank (on a
    hit), ``middle - k`` among the taps // 2 places below the rank and
    ``middle + k`` among the taps // 2 places from rank + hit up (for three
    taps: z-1 at rank-1, z at rank, z+1 at rank+hit), each kept only where
    the id there is exactly the one wanted and the probe lies inside the
    window. Returns (rows, found), each (B, taps*G, Vt) with tap
    ``zi * G + g``; found is the same as `neighbour_rows` gives for those
    taps, and rows agree where found."""
    b, vt = tgt_ids.shape
    nb = vt // block
    g_n = centres.shape[0]
    h = taps // 2
    lo_l = lo.long()[..., None]
    idx = lo_l + torch.arange(window, device=tgt_ids.device)
    win = torch.gather(src_ids.long()[:, None, :].expand(
        b, nb, src_ids.shape[1]), 2, idx).contiguous()          # (B,nb,S)
    want = (tgt_ids.long().reshape(b, nb, 1, block)
            + centres.long()[None, None, :, None]).reshape(b, nb, -1)
    r = torch.searchsorted(win, want)
    hit = (r < window) & (
        torch.gather(win, 2, torch.clamp(r, max=window - 1)) == want)
    rows, found = [], []
    for zi in range(taps):
        dz = zi - h
        if dz == 0:
            places = [r]
        elif dz < 0:
            places = [r - 1 - k for k in range(h)]
        else:
            places = [r + hit.long() + k for k in range(h)]
        row = torch.zeros_like(r)
        ok_any = torch.zeros_like(hit)
        for j in places:
            jc = torch.clamp(j, 0, window - 1)
            ok = (j >= 0) & (j < window) \
                & (torch.gather(win, 2, jc) == want + dz)
            row = torch.where(ok, jc, row)
            ok_any = ok_any | ok
        rows.append(torch.where(ok_any, row,
                                torch.clamp(places[0], 0, window - 1)) + lo_l)
        found.append(ok_any & hit if dz == 0 else ok_any)

    def by_tap(parts):
        x = torch.stack(parts, dim=1).reshape(b, taps, nb, g_n, block)
        return x.permute(0, 1, 3, 2, 4).reshape(b, taps * g_n, vt)

    return by_tap(rows), by_tap(found)


def _gather_rows(feats, rows, found):
    """(B, K, Vt, Cin): each tap's neighbour features, zeros on a miss."""
    b, k, vt = rows.shape
    cin = feats.shape[2]
    gat = torch.gather(feats, 1, rows.reshape(b, k * vt)[..., None].expand(
        -1, -1, cin)).reshape(b, k, vt, cin)
    return gat * found[..., None]


def _gathered(src_ids, feats, tgt_ids, lo, deltas, block, window):
    return _gather_rows(feats, *neighbour_rows(src_ids, tgt_ids, lo, deltas,
                                               block, window))


def windowed_conv_plain(src_ids, feats, tgt_ids, lo, deltas, w_flat,
                        block: int, window: int, scale=None, shift=None,
                        relu=False, sentinel=None,
                        compute_dtype=torch.float32):
    """Plain version of K3: searchsorted + gather + matmul. feats
    (B, Vs, Cin) f32; w_flat (K*Cin, Cout), row k*Cin + c. Operands are
    rounded to compute_dtype, products summed in f32. (B, Vt, Cout) f32."""
    b, vt = tgt_ids.shape
    k, cin = deltas.shape[0], feats.shape[2]
    gat = _gathered(src_ids, feats, tgt_ids, lo, deltas, block, window)
    gat = gat.permute(0, 2, 1, 3).reshape(b, vt, k * cin)
    out = gat.to(compute_dtype).float() @ w_flat.to(compute_dtype).float()
    if scale is not None:
        out = out * scale.float() + shift.float()
        if relu:
            out = torch.relu(out)
        out = out * (tgt_ids < sentinel)[..., None]
    return out


def conv_smem(cin, cout, window, g_n, stages, resident, stage_window,
              taps=3):
    """Shared-memory bytes of one K3 block (the kernel's own layout)."""
    return ((g_n if resident else stages) * 2 * taps * cin * cout
            + stages * CONV_TILE * (2 * taps * cin + 16)
            + g_n * taps * CONV_TILE * 4 + 16
            + (4 * window if stage_window else 0))


def _plan(cin, cout, window, g_n, taps):
    """K3's plan for one launch's widths, or None where nothing fits."""
    resident = g_n * 2 * taps * cin * cout <= RESIDENT_MAX
    for stages in (2, 1):
        if conv_smem(cin, cout, window, g_n, stages, resident, False,
                     taps) <= SMEM_MAX:
            return stages, resident, conv_smem(
                cin, cout, window, g_n, stages, resident, True,
                taps) <= SMEM_MAX
    return None


def conv_plan(cin, cout, window, g_n=9, taps=3):
    """K3's plan for padded widths: (stages, resident, stage_window). All
    groups' weights resident up to RESIDENT_MAX; a two-stage ring where it
    fits (not at Cin 128 with streamed weights); the window slice in shared
    memory where the rest leaves room for it."""
    plan = _plan(cin, cout, window, g_n, taps)
    if plan is None:
        raise ValueError(f"no K3 plan fits cin={cin} cout={cout} "
                         f"taps={taps} groups={g_n}")
    return plan


def conv_slices(cin, cout, window, g_n=9, taps=3):
    """(Cin slice, Cout slice) of K3's launches for padded widths: the
    fewest launches whose plan fits, Cout slices at most CONV_SLICE and a
    power of two, Cin slices a multiple of 16 at most CONV_SLICE that
    divides Cin; among equals the wider Cout slice."""
    best = None
    for co in (128, 64, 32, 16, 8):
        if co > cout or cout % co:
            continue
        for n_in in (1, 2, 4, 8, 16):
            ci = cin // n_in
            if cin % n_in or ci % 16 or ci > CONV_SLICE:
                continue
            if _plan(ci, co, window, g_n, taps) is not None:
                launches = n_in * (cout // co)
                if best is None or launches < best[0]:
                    best = (launches, ci, co)
                break
    if best is None:
        raise ValueError(f"no K3 slices fit cin={cin} cout={cout} "
                         f"taps={taps} groups={g_n}")
    return best[1], best[2]


def conv_kernel(src_ids, feats, tgt_ids, lo, deltas, w_flat, block: int,
                window: int, scale=None, shift=None, relu=False,
                sentinel=None, compute_dtype=torch.float32, centres=None):
    """K3 wrapper: the CUDA kernel (bf16 operands, f32 sums on the tensor
    cores) for CUDA tensors, the plain version for CPU tensors. The kernel
    wants taps in groups of consecutive ids (it reads the middles as
    ``deltas[h*G:(h+1)*G]`` on the device); the wrapper raises where they
    are not, checked on `centres` (``tap_groups(deltas)``) where the caller
    has them on the host, else on a copy of the deltas, which waits for the
    stream. It pads Cin to a multiple of 16 and Cout to a power of two from
    8 (at most 256 each), and takes the kernel's channel slices from
    `conv_slices` and its ring and window staging from `conv_plan`."""
    if not _check_device(src_ids, feats, tgt_ids, lo, deltas, w_flat):
        return windowed_conv_plain(src_ids, feats, tgt_ids, lo, deltas,
                                   w_flat, block, window, scale, shift, relu,
                                   sentinel, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA windowed conv computes in bfloat16")
    b, vt = tgt_ids.shape
    k, cin, vs = deltas.shape[0], feats.shape[2], src_ids.shape[1]
    cout = w_flat.shape[1]
    cin_p = -(-cin // 16) * 16
    cout_p = max(8, 1 << (cout - 1).bit_length())
    if cin_p > 256 or cout_p > 256 or block % CONV_TILE or vt % block \
            or window > vs or window % 4 or vs % 4:
        raise ValueError(f"unsupported windowed conv shape cin={cin} "
                         f"cout={cout} taps={k} block={block} vt={vt} "
                         f"window={window}")
    _check_ids(src_ids=src_ids, tgt_ids=tgt_ids, lo=lo, deltas=deltas)
    for name, t, shape in (("src_ids", src_ids, (b, vs)),
                           ("lo", lo, (b, vt // block)),
                           ("w_flat", w_flat, (k * cin, cout))):
        _check_shape(name, t, shape)
    if centres is None:
        centres = tap_groups(deltas.cpu().numpy())
    centres, taps = centres
    g_n = len(centres)
    if taps * g_n != k:
        raise ValueError(f"{g_n} tap groups of {taps} for {k} taps")
    cin_t, cout_t = conv_slices(cin_p, cout_p, window, g_n, taps)
    stages, resident, stage_window = conv_plan(cin_t, cout_t, window, g_n,
                                               taps)
    epilogue = scale is not None
    if epilogue:
        _check_shape("scale", scale, (cout,))
        _check_shape("shift", shift, (cout,))
        scale, shift = scale.float(), shift.float()
    else:
        scale = shift = torch.zeros(cout, device=feats.device)
    pad_c = (0, cout_p - cout)
    feats = feats.to(torch.bfloat16)
    if cin_p != cin:
        feats = torch.nn.functional.pad(feats, (0, cin_p - cin))
    w = reorder_weights_groups(w_flat.to(torch.bfloat16).reshape(
        k, cin, cout), taps)                             # (G,S,Cin,Cout)
    w = torch.nn.functional.pad(w, pad_c + (0, cin_p - cin))
    scale = torch.nn.functional.pad(scale, pad_c).contiguous()
    shift = torch.nn.functional.pad(shift, pad_c).contiguous()
    feats = feats.contiguous()
    mids = deltas[(taps // 2) * g_n:(taps // 2 + 1) * g_n]
    out = torch.empty(b, vt, cout_p, dtype=torch.float32, device=feats.device)
    for o0, o1 in channel_slices(cout_p, cout_t):
        dst = out if cout_t == cout_p else torch.empty(
            b, vt, cout_t, dtype=torch.float32, device=feats.device)
        sc, sh = scale[o0:o1].contiguous(), shift[o0:o1].contiguous()
        for i0, i1 in channel_slices(cin_p, cin_t):
            f = feats if cin_t == cin_p else feats[..., i0:i1].contiguous()
            wt = pack_weights_mma(w[:, :, i0:i1, o0:o1].reshape(
                k * cin_t, cout_t))
            last = i1 == cin_p
            _build.check(_lib().fp_windowed_conv(
                _ptr(src_ids), _ptr(f), _ptr(tgt_ids), _ptr(lo), _ptr(mids),
                _ptr(wt), _ptr(sc), _ptr(sh), _ptr(dst), b, vs, vt,
                vt // block, g_n, block, window, cin_t, cout_t,
                int(epilogue and last), int(relu),
                int(sentinel) if epilogue and last else 0, stages,
                int(resident), int(stage_window), taps, int(i0 > 0),
                _stream()), "fp_windowed_conv")
            LAUNCHES["windowed_conv"] += 1
        if dst is not out:
            out[..., o0:o1] = dst
    return out[..., :cout] if cout_p != cout else out


def _compute_dtype(t):
    return torch.bfloat16 if t.device.type == "cuda" else torch.float32


def _prepare(src_ids, feats, tgt_ids, deltas, block, window):
    """Shared entry of both kernels: pad the source list, round the window
    and compute the window starts, as the reference's wrappers do."""
    b, vt = tgt_ids.shape
    if vt % block or block % ALIGN:
        raise ValueError(f"Vt={vt} must be a multiple of block={block}, and "
                         f"block a multiple of {ALIGN}")
    host = torch.as_tensor(deltas)
    deltas = host.to(device=tgt_ids.device, dtype=torch.int32)
    src_ids, feats = _pad_src(src_ids, feats.float())
    window = _round_window(window, src_ids.shape[1])
    src_ids = src_ids.contiguous()
    tgt_ids = tgt_ids.contiguous()
    lo = window_starts(src_ids, tgt_ids, host, block, window)
    return src_ids, feats.contiguous(), tgt_ids, deltas.contiguous(), lo, \
        window


def _host_centres(deltas, feats):
    """The tap groups (middles, size), taken on the host where the deltas
    are there and the kernels will run (else None: the wrappers take
    them)."""
    if feats.is_cuda and not (isinstance(deltas, torch.Tensor)
                              and deltas.is_cuda):
        return tap_groups(np.asarray(deltas))
    return None


@trace.spanned("windowed_conv")
def _conv(src_ids, src_feats, tgt_ids, weights, deltas, block, window,
          compute_dtype=None, **epilogue):
    """K3 on unprepared lists; returns (out, (src_ids, tgt_ids, lo, window)
    as the kernel saw them)."""
    k, cin, cout = weights.shape
    centres = _host_centres(deltas, src_feats)
    src_ids, feats, tgt_ids, deltas, lo, window = _prepare(
        src_ids, src_feats, tgt_ids, deltas, block, window)
    out = conv_kernel(
        src_ids, feats, tgt_ids, lo, deltas,
        weights.float().reshape(k * cin, cout), block, window,
        compute_dtype=compute_dtype or _compute_dtype(feats),
        centres=centres, **epilogue)
    return out, (src_ids, tgt_ids, lo, window)


def windowed_conv(src_ids, src_feats, tgt_ids, weights, deltas,
                  block: int = 512, window: int = 1536, sentinel_start=None,
                  scale=None, shift=None, relu=False, compute_dtype=None):
    """Fused union-window sparse conv, same contract as the reference's
    `windowed_conv_pallas`: src_ids (B, Vs) / tgt_ids (B, Vt) ascending
    int32, src_feats (B, Vs, Cin), weights (K, Cin, Cout), deltas (K,).
    scale/shift (Cout,) turn on the epilogue and need an int
    `sentinel_start`. Operands are bf16 on CUDA, f32 on the CPU unless
    `compute_dtype` says otherwise. Returns (out (B, Vt, Cout) f32,
    overflow (B,) int64 against the window the kernel used)."""
    if scale is not None and sentinel_start is None:
        raise ValueError("the epilogue needs sentinel_start")
    out, (src_ids, tgt_ids, lo, window) = _conv(
        src_ids, src_feats, tgt_ids, weights, deltas, block, window,
        compute_dtype, scale=scale, shift=shift, relu=relu,
        sentinel=sentinel_start if scale is not None else None)
    return out, _union_overflow(src_ids, tgt_ids,
                                torch.as_tensor(deltas).long(), lo, block,
                                window, sentinel_start)


# ----------------------------------------------------------------- K4


def windowed_dw_plain(src_ids, feats, tgt_ids, g, lo, deltas, block: int,
                      window: int, compute_dtype=torch.float32):
    """Plain version of K4: gather per tap, then (Cin, B*Vt) x (B*Vt, Cout).
    Returns (K, Cin, Cout) f32, summed over the batch."""
    gat = _gathered(src_ids, feats, tgt_ids, lo, deltas, block, window)
    gat = gat.to(compute_dtype).float()                     # (B,K,Vt,Cin)
    gc = g.to(compute_dtype).float()                        # (B,Vt,Cout)
    return torch.einsum("bktc,bto->kco", gat, gc)


def dw_chunks(n_tiles: int, g_n: int, batch: int):
    """Target chunks (partial sums) per sample and group: as many as make
    the K4 grid about DW_BLOCKS blocks, at least 1, at most one per tile."""
    return max(1, min(n_tiles, DW_BLOCKS // (g_n * batch)))


def dw_slices(cin, cout, taps=3):
    """(Cin slice, Cout slice) of K4's launches for widths padded to powers
    of two from 16: Cin slices of at most 128 (eight warps of 16 channels),
    Cout slices as wide as the accumulators allow (Cin * Cout at most
    MAX_DW_ACC, MAX_DW_ACC5 at five taps, Cout at most 256)."""
    ci = min(cin, 128)
    limit = MAX_DW_ACC5 if taps == 5 else MAX_DW_ACC
    co = min(cout, 256, max(16, limit // ci))
    return ci, co


def dw_kernel(src_ids, feats, tgt_ids, g, lo, deltas, block: int,
              window: int, compute_dtype=torch.float32, centres=None):
    """K4 wrapper: the CUDA kernel (bf16 operands, f32 sums on the tensor
    cores; per-chunk partial sums combined in a fixed order, so the result
    is the same from run to run) for CUDA tensors, the plain version for CPU
    tensors. The kernel wants taps in groups of consecutive ids and channel
    counts that are powers of two from 16 on: the wrapper pads the channels
    with zeros (at most 256 each), runs one launch per (Cin, Cout) slice of
    `dw_slices`, and raises where the taps do not group. `centres` are
    `tap_groups(deltas)` where the caller has them (it has the deltas on
    the host); without them the deltas are copied back from the device,
    which waits for the stream."""
    if not _check_device(src_ids, feats, tgt_ids, g, lo, deltas):
        return windowed_dw_plain(src_ids, feats, tgt_ids, g, lo, deltas,
                                 block, window, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA windowed dW computes in bfloat16")
    b, vt = tgt_ids.shape
    k, cin, cout = deltas.shape[0], feats.shape[2], g.shape[2]
    cin_p = max(16, 1 << (cin - 1).bit_length())
    cout_p = max(16, 1 << (cout - 1).bit_length())
    if cin_p > 256 or cout_p > 256 or block % DW_TILE or vt % block \
            or window > src_ids.shape[1]:
        raise ValueError(f"unsupported windowed dW shape cin={cin} "
                         f"cout={cout} block={block} vt={vt} window={window}")
    _check_ids(src_ids=src_ids, tgt_ids=tgt_ids, lo=lo, deltas=deltas)
    for name, t, shape in (("src_ids", src_ids, (b, feats.shape[1])),
                           ("lo", lo, (b, vt // block)),
                           ("g", g, (b, vt, cout))):
        _check_shape(name, t, shape)
    if centres is None:
        centres = tap_groups(deltas.cpu().numpy())
    centres, taps = centres
    centres = torch.as_tensor(centres, dtype=torch.int32,
                              device=feats.device)
    g_n = centres.shape[0]
    if taps * g_n != k:
        raise ValueError(f"{g_n} tap groups of {taps} for {k} taps")
    feats = torch.nn.functional.pad(feats.to(torch.bfloat16),
                                    (0, cin_p - cin)).contiguous()
    g = torch.nn.functional.pad(g.to(torch.bfloat16),
                                (0, cout_p - cout)).contiguous()
    cin_t, cout_t = dw_slices(cin_p, cout_p, taps)
    n_chunks = dw_chunks(vt // DW_TILE, g_n, b)
    partial = torch.empty(b * n_chunks, g_n, taps * cin_t, cout_t,
                          dtype=torch.float32, device=feats.device)
    dw = torch.empty(k, cin_p, cout_p, dtype=torch.float32,
                     device=feats.device)
    for i0, i1 in channel_slices(cin_p, cin_t):
        f = feats if cin_t == cin_p else feats[..., i0:i1].contiguous()
        for o0, o1 in channel_slices(cout_p, cout_t):
            gt = g if cout_t == cout_p else g[..., o0:o1].contiguous()
            dst = dw if (cin_t, cout_t) == (cin_p, cout_p) else torch.empty(
                k, cin_t, cout_t, dtype=torch.float32, device=feats.device)
            _build.check(_lib().fp_windowed_dw(
                _ptr(src_ids), _ptr(f), _ptr(tgt_ids), _ptr(gt), _ptr(lo),
                _ptr(centres), _ptr(partial), _ptr(dst), b,
                src_ids.shape[1], vt, vt // block, g_n, block, window,
                cin_t, cout_t, n_chunks, taps, _stream()), "fp_windowed_dw")
            LAUNCHES["windowed_dw"] += 1
            if dst is not dw:
                dw[:, i0:i1, o0:o1] = dst
    return dw[:, :cin, :cout]


@trace.spanned("windowed_dw")
def windowed_dw(src_ids, src_feats, tgt_ids, g, deltas, block: int = 512,
                window: int = 1536, compute_dtype=None):
    """dW[k] = gathered_k(src -> tgt)^T @ g, same contract as the
    reference's `windowed_dw_pallas` with a batch axis summed out: g
    (B, Vt, Cout); returns (K, Cin, Cout) f32."""
    centres = _host_centres(deltas, src_feats)
    src_ids, feats, tgt_ids, deltas, lo, window = _prepare(
        src_ids, src_feats, tgt_ids, deltas, block, window)
    return dw_kernel(src_ids, feats, tgt_ids, g, lo, deltas, block, window,
                     compute_dtype=compute_dtype or _compute_dtype(feats),
                     centres=centres)


# ----------------------------------------------------------------- grads


class WindowedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, weights, src_ids, tgt_ids, deltas, block,
                window, compute_dtype):
        out, _ = _conv(src_ids, feats, tgt_ids, weights, deltas, block,
                       window, compute_dtype)
        ctx.save_for_backward(feats, weights, src_ids, tgt_ids)
        ctx.cfg = (deltas, block, window, compute_dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        feats, weights, src_ids, tgt_ids = ctx.saved_tensors
        deltas, block, window, cd = ctx.cfg
        g = g.contiguous()
        d_feats = d_w = None
        if ctx.needs_input_grad[0]:
            # tap k of the transposed conv is -delta_{K-1-k} with
            # W[K-1-k]^T: the pairs of (-deltas, W^T), in group order
            d_feats, _ = _conv(tgt_ids, g, src_ids,
                               flip_transpose_weights(weights),
                               np.ascontiguousarray(-deltas[::-1]), block,
                               window, cd)
        if ctx.needs_input_grad[1]:
            d_w = windowed_dw(src_ids, feats, tgt_ids, g, deltas,
                              block=block, window=window, compute_dtype=cd)
        return d_feats, d_w, None, None, None, None, None, None


def windowed_conv_diff(src_ids, src_feats, tgt_ids, weights, deltas,
                       block: int = 512, window: int = 1536,
                       sentinel_start=None, compute_dtype=None):
    """Differentiable windowed conv, the reference's
    `windowed_conv_pallas_diff`: K3 forward, K3 transposed for d_feats
    (skipped when src_feats needs no gradient), K4 for dW. Both id lists
    must be block multiples. Returns (out, overflow (B,) int64) with the
    overflow of both directions, outside the graph."""
    if src_ids.shape[1] % block or tgt_ids.shape[1] % block:
        raise ValueError("pad Vs and Vt to a block multiple")
    # kept on the host: the kernels' wrappers group the taps there
    deltas = np.asarray(deltas.cpu() if isinstance(deltas, torch.Tensor)
                        else deltas).astype(np.int32)
    out = WindowedConv.apply(src_feats, weights, src_ids, tgt_ids, deltas,
                                block, window, compute_dtype)
    with torch.no_grad():
        ovf = windowed_overflow(src_ids, tgt_ids, deltas, block, window,
                                sentinel_start=sentinel_start) \
            + windowed_overflow(tgt_ids, src_ids, -deltas, block, window,
                                sentinel_start=sentinel_start)
    return out, ovf
