"""Position-gather sparse convolution — port of
findnpropagate_tpu/ops/pallas_posgather.py (`group_center_deltas` :50,
`reorder_weights_groups` :67, `LevelPositions` :503, `compute_positions`
:523, `posgather_conv` :635, `flip_transpose_weights` :697,
`posgather_subm_diff` :706).

Two kernels carry it (ops/csrc/posgather.cu):
  * K1 `positions` — per target and tap group (dy, dx), the left-insertion
    rank of ``tgt + D_g`` in the block's sorted source-id (sub-)window and
    a hit flag, as ``hit ? rank : ~rank``; -1 for dead blocks;
  * K2 `gather_conv` — the 27 neighbours fetched through those ranks (z-1
    at rank-1, z at rank, z+1 at rank+hit, each checked against the exact
    id) times the weights on the tensor cores, with the optional fused
    bias+BN(+ReLU) epilogue. The wrapper hands the kernel one bf16 copy of
    the features and the weights packed in mma fragment order
    (`pack_weights_mma`).

Each has a plain PyTorch version beside it (`positions_plain`,
`posgather_conv_plain`). A wrapper takes the plain version only for a
tensor on the CPU; for a CUDA tensor it launches the kernel or raises.
`LAUNCHES` counts kernel launches per wrapper.

The torch prelude keeps the reference's window starts ``lo``, ``base``,
``has_real`` and the exact overflow count (a) union-window span > window
and (b) tap sub-window span > tap_window. The reference's band starts and
fallback flags (``starts``/``flags``, and overflow term (c)) exist only for
the TPU kernel's 128-lane bands: the CUDA kernel probes global memory
directly, so they are left out and ``band`` is not a knob here. All
functions take a leading batch axis (the reference vmaps them).

`posgather_subm_diff` is the differentiable submanifold conv of the
training step: forward K2, backward K2 again with the flipped-transposed
weights over the same LevelPositions for ``d_feats``, and the windowed
weight-gradient kernel (ops/windowed_sparse.py) for ``dW``.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _build

ALIGN = 512
CONV_TILE = 128          # targets per tile of the K2 kernel
LAUNCHES = {"positions": 0, "posgather_conv": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def group_center_deltas(deltas27):
    """K zyx-C-order tap deltas -> the K/3 group-centre (dz=0) deltas: tap
    zi * K/3 + g is the centre of group g plus zi - 1. Raises ValueError
    where the taps are not such groups of three consecutive ids."""
    d = np.asarray(deltas27)
    g = d.shape[0] // 3
    centers = d[g:2 * g]
    if d.ndim != 1 or d.shape[0] != 3 * g or g == 0 \
            or not (np.all(d[0:g] == centers - 1)
                    and np.all(d[2 * g:] == centers + 1)):
        raise ValueError("tap deltas are not groups of three consecutive "
                         "ids (z-1, z, z+1): a kernel size of 3 along z, "
                         "taps in zyx C-order, is needed")
    return centers.astype(np.int32)


def reorder_weights_groups(weights27):
    """(K, Cin, Cout) zyx-C-order -> (K/3, 3, Cin, Cout) grouped [g, zi]."""
    k, cin, cout = weights27.shape
    return weights27.reshape(3, k // 3, cin, cout).permute(1, 0, 2, 3)


@dataclass(frozen=True)
class LevelPositions:
    """Alignment shared by every conv over one (source, target) id pair."""

    lo: torch.Tensor          # (B, nb) int32 window starts, ALIGN-aligned
    base: torch.Tensor        # (B, nb) int32 first window id
    pos: torch.Tensor         # (B, G, Vt) int32 hit ? rank : ~rank
    gdeltas: torch.Tensor     # (G,) int32
    has_real: torch.Tensor    # (B, nb) int32, 0 = all-sentinel block
    overflow: torch.Tensor    # (B,) int64 dropped-neighbour conditions
    block: int
    window: int


def _pad_src(src_ids, feats=None):
    """Pad the source list to an ALIGN multiple with ascending ids above
    the last (and zero features), as the reference does."""
    vs = src_ids.shape[1]
    pad = (-vs) % ALIGN
    if not pad:
        return src_ids, feats
    ext = src_ids[:, -1:] + 2 + torch.arange(
        pad, dtype=src_ids.dtype, device=src_ids.device)
    src_ids = torch.cat([src_ids, ext], dim=1)
    if feats is not None:
        feats = torch.cat(
            [feats, feats.new_zeros(feats.shape[0], pad, feats.shape[2])],
            dim=1)
    return src_ids, feats


def _check_device(*tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError("all tensors must be on one device")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cuda"


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream():
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def _lib():
    """The kernels' library with its C signatures declared (built at first
    use). Launches go on PyTorch's current stream, so temporaries freed
    after a launch are reused only by work ordered after it."""
    lib = _build.load("posgather")
    if lib.fp_positions.argtypes is None:
        lib.fp_positions.argtypes = [ctypes.c_void_p] * 7 \
            + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.fp_positions.restype = ctypes.c_int
        lib.fp_posgather_conv.argtypes = [ctypes.c_void_p] * 11 \
            + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        lib.fp_posgather_conv.restype = ctypes.c_int
    return lib


def _check_ids(**tensors):
    for name, t in tensors.items():
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor")


def _check_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


# ----------------------------------------------------------------- K1


def positions_plain(src_ids, tgt_ids, lo, tap_lo, has_real, gdeltas,
                    block: int, span: int, use_tap: bool):
    """Plain version of K1: torch.searchsorted inside each (block, group)
    window slice. Returns pos (B, G, Vt) int32."""
    b, vt = tgt_ids.shape
    nb = vt // block
    g_n = gdeltas.shape[0]
    off = tap_lo.long() if use_tap else torch.zeros(
        b, nb, g_n, dtype=torch.long, device=tgt_ids.device)
    start = lo.long()[..., None] + off                          # (B, nb, G)
    idx = start[..., None] + torch.arange(span, device=tgt_ids.device)
    win = torch.gather(src_ids.long()[:, None, None, :].expand(
        b, nb, g_n, src_ids.shape[1]), 3, idx).contiguous()     # (B,nb,G,S)
    want = (tgt_ids.long().reshape(b, nb, 1, block)
            + gdeltas.long()[None, None, :, None])              # (B,nb,G,W)
    r = torch.searchsorted(win, want.contiguous())
    found = torch.gather(win, 3, torch.clamp(r, max=span - 1))
    hit = (r < span) & (found == want)
    rank = r + off[..., None]
    pos = torch.where(hit, rank, ~rank)
    pos = torch.where(has_real.bool()[..., None, None], pos,
                      torch.full_like(pos, -1))
    return pos.permute(0, 2, 1, 3).reshape(b, g_n, vt).to(torch.int32)


def positions(src_ids, tgt_ids, lo, tap_lo, has_real, gdeltas, block: int,
              span: int, use_tap: bool):
    """K1 wrapper: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if not _check_device(src_ids, tgt_ids, lo, tap_lo, has_real, gdeltas):
        return positions_plain(src_ids, tgt_ids, lo, tap_lo, has_real,
                               gdeltas, block, span, use_tap)
    _check_ids(src_ids=src_ids, tgt_ids=tgt_ids, lo=lo, tap_lo=tap_lo,
               has_real=has_real, gdeltas=gdeltas)
    b, vt = tgt_ids.shape
    nb, g_n = vt // block, gdeltas.shape[0]
    if vt % block or span > src_ids.shape[1] or src_ids.shape[0] != b:
        raise ValueError(f"positions: vt={vt} block={block} span={span} "
                         f"src {tuple(src_ids.shape)}")
    for name, t, shape in (("lo", lo, (b, nb)),
                           ("has_real", has_real, (b, nb)),
                           ("tap_lo", tap_lo, (b, nb, g_n))):
        _check_shape(name, t, shape)
    pos = torch.empty(b, g_n, vt, dtype=torch.int32, device=tgt_ids.device)
    _build.check(_lib().fp_positions(
        _ptr(src_ids), _ptr(tgt_ids), _ptr(lo), _ptr(tap_lo), _ptr(has_real),
        _ptr(gdeltas), _ptr(pos), b, src_ids.shape[1], vt, nb, g_n, block,
        span, int(use_tap), _stream()), "fp_positions")
    LAUNCHES["positions"] += 1
    return pos


# ----------------------------------------------------------------- K2


def neighbour_probes(src_ids, tgt_ids, pos, lo, has_real, gdeltas,
                     block: int, window: int):
    """The three z-probes of every (target, group): [(rows (B, G*Vt) into
    the source list, found (B, G, Vt) bool)] for z-1, z, z+1 — z-1 at
    rank-1, z at rank (on a hit), z+1 at rank+hit, each found only where
    the source id there is exactly the one wanted, inside the window, in a
    live block."""
    b, vt = tgt_ids.shape
    g_n = gdeltas.shape[0]
    hit = pos >= 0
    rank = torch.where(hit, pos, ~pos).long()                   # (B, G, Vt)
    lo_t = lo.long().repeat_interleave(block, dim=1)[:, None, :]
    live = has_real.bool().repeat_interleave(block, dim=1)[:, None, :]
    src = src_ids.long()
    want0 = tgt_ids.long()[:, None, :] + gdeltas.long()[None, :, None]
    probes = []
    for zi, j in ((0, rank - 1), (1, rank), (2, rank + hit.long())):
        ok = (j >= 0) & (j < window) & live
        rows = (lo_t + torch.clamp(j, 0, window - 1)).reshape(b, -1)
        ids_at = torch.gather(src, 1, rows).reshape(b, g_n, vt)
        found = ok & (ids_at == want0 + (zi - 1))
        if zi == 1:
            found = found & hit
        probes.append((rows, found))
    return probes


def posgather_conv_plain(src_ids, feats, tgt_ids, pos, lo, has_real,
                         gdeltas, w_flat, block: int, window: int,
                         scale=None, shift=None, relu=False, sentinel=None,
                         compute_dtype=torch.float32):
    """Plain version of K2: explicit probe + gather + matmul. feats
    (B, Vs, Cin) f32; w_flat (G*3*Cin, Cout), row g*3Cin + zi*Cin + c.
    Operands are rounded to compute_dtype, products summed in f32.
    Returns (B, Vt, Cout) f32."""
    b, vt = tgt_ids.shape
    g_n = gdeltas.shape[0]
    cin = feats.shape[2]
    parts = []
    for rows, found in neighbour_probes(src_ids, tgt_ids, pos, lo, has_real,
                                        gdeltas, block, window):
        f = torch.gather(feats, 1, rows[..., None].expand(-1, -1, cin))
        parts.append(f.reshape(b, g_n, vt, cin) * found[..., None])
    gat = torch.stack(parts, dim=2)                         # (B,G,3,Vt,C)
    gat = gat.permute(0, 3, 1, 2, 4).reshape(b, vt, g_n * 3 * cin)
    out = gat.to(compute_dtype).float() @ w_flat.to(compute_dtype).float()
    if scale is not None:
        out = out * scale.float() + shift.float()
        if relu:
            out = torch.relu(out)
        out = out * (tgt_ids < sentinel)[..., None]
    live = has_real.bool().repeat_interleave(block, dim=1)
    return out * live[..., None]


MMA_K, MMA_N = 16, 8     # depth and width of one mma.sync m16n8k16 B tile


def pack_weights_mma(w_flat):
    """(R, Cout) weights, R % 16 == 0 and Cout % 8 == 0 -> (R/16, Cout/8,
    32, 4) in the order the tensor-core kernel reads its B fragments: for
    each 16-row slab and 8-column tile, lane l holds rows 2(l%4), 2(l%4)+1,
    2(l%4)+8, 2(l%4)+9 of column l // 4."""
    r, cout = w_flat.shape
    if r % MMA_K or cout % MMA_N:
        raise ValueError(f"cannot pack a ({r}, {cout}) weight matrix")
    # row = 16 ks + 8 h + 2 t + p, column = 8 nt + n; lane = 4 n + t and
    # the lane's four values are (h, p) in C order
    w = w_flat.reshape(r // MMA_K, 2, 4, 2, cout // MMA_N, MMA_N)
    return w.permute(0, 4, 5, 2, 1, 3).reshape(
        r // MMA_K, cout // MMA_N, 32, 4).contiguous()


def gather_conv(src_ids, feats, tgt_ids, pos, lo, has_real, gdeltas,
                w_flat, block: int, window: int, scale=None, shift=None,
                relu=False, sentinel=None, compute_dtype=torch.float32):
    """K2 wrapper: the CUDA kernel (bf16 operands, f32 sums on the tensor
    cores) for CUDA tensors, the plain version for CPU tensors."""
    if not _check_device(src_ids, feats, tgt_ids, pos, lo, has_real,
                         gdeltas, w_flat):
        return posgather_conv_plain(
            src_ids, feats, tgt_ids, pos, lo, has_real, gdeltas, w_flat,
            block, window, scale, shift, relu, sentinel, compute_dtype)
    if compute_dtype != torch.bfloat16:
        raise ValueError("the CUDA posgather conv computes in bfloat16")
    b, vt = tgt_ids.shape
    g_n, cin = gdeltas.shape[0], feats.shape[2]
    cout = w_flat.shape[1]
    cout_p = max(8, 1 << (cout - 1).bit_length())
    if cin % 16 or cin > 128 or cout_p > 128 or block % CONV_TILE \
            or vt % block or window > src_ids.shape[1]:
        raise ValueError(f"unsupported posgather conv shape cin={cin} "
                         f"cout={cout} block={block} vt={vt} window={window}")
    _check_ids(src_ids=src_ids, tgt_ids=tgt_ids, pos=pos, lo=lo,
               has_real=has_real, gdeltas=gdeltas)
    nb = vt // block
    for name, t, shape in (
            ("src_ids", src_ids, (b, feats.shape[1])),
            ("pos", pos, (b, g_n, vt)),
            ("lo", lo, (b, nb)), ("has_real", has_real, (b, nb)),
            ("w_flat", w_flat, (g_n * 3 * cin, cout))):
        _check_shape(name, t, shape)
    if scale is not None:
        _check_shape("scale", scale, (cout,))
        _check_shape("shift", shift, (cout,))
    feats = feats.to(torch.bfloat16).contiguous()
    w = w_flat.to(torch.bfloat16)
    epilogue = scale is not None
    if epilogue:
        scale, shift = scale.float(), shift.float()
    else:
        scale = shift = torch.zeros(cout, device=feats.device)
    if cout_p != cout:
        w = torch.nn.functional.pad(w, (0, cout_p - cout))
        scale = torch.nn.functional.pad(scale, (0, cout_p - cout))
        shift = torch.nn.functional.pad(shift, (0, cout_p - cout))
    w = pack_weights_mma(w)
    scale, shift = scale.contiguous(), shift.contiguous()
    out = torch.empty(b, vt, cout_p, dtype=torch.float32, device=feats.device)
    _build.check(_lib().fp_posgather_conv(
        _ptr(src_ids), _ptr(feats), _ptr(tgt_ids), _ptr(pos), _ptr(lo),
        _ptr(has_real), _ptr(gdeltas), _ptr(w), _ptr(scale), _ptr(shift),
        _ptr(out), b, src_ids.shape[1], vt, nb, g_n, block, window,
        cin, cout_p, int(epilogue), int(relu),
        int(sentinel) if epilogue else 0, _stream()), "fp_posgather_conv")
    LAUNCHES["posgather_conv"] += 1
    return out[..., :cout] if cout_p != cout else out


# ----------------------------------------------------------------- prelude


def compute_positions(src_ids, tgt_ids, deltas27, block: int, window: int,
                      tap_window=None, sentinel_start=None) -> LevelPositions:
    """src_ids (B, Vs) / tgt_ids (B, Vt) sorted ascending int32,
    Vt % block == 0, block % ALIGN == 0.

    overflow counts, exactly as the reference's terms (a) and (b): target
    blocks whose union span (+-1 for the z taps) exceeds `window`, and
    (block, group) tap sub-window overflows when tap_window is set. Any
    nonzero count means a neighbour contribution was dropped."""
    dev = tgt_ids.device
    b, vt = tgt_ids.shape
    nb = vt // block
    assert nb * block == vt and block % ALIGN == 0
    g_np = group_center_deltas(deltas27)
    gdeltas = torch.as_tensor(g_np, dtype=torch.int32, device=dev)
    src_ids, _ = _pad_src(src_ids)
    vs = src_ids.shape[1]
    window = -(-(min(window, vs) + ALIGN) // ALIGN) * ALIGN
    window = min(window, vs)

    src = src_ids.contiguous()
    src_l = src.long()
    d_min = int(g_np.min()) - 1
    d_max = int(g_np.max()) + 1
    tgt_b = tgt_ids.reshape(b, nb, block)
    block_first = tgt_b[:, :, 0].long()
    lo = torch.searchsorted(src_l, (block_first + d_min).contiguous())
    lo_max = max(((vs - window) // ALIGN) * ALIGN, 0)
    lo = torch.clamp(torch.div(lo, ALIGN, rounding_mode="floor") * ALIGN,
                     max=lo_max)

    if sentinel_start is not None:
        real_b = tgt_b < sentinel_start
        block_last = torch.where(real_b, tgt_b.long(),
                                 torch.full_like(tgt_b, -2 ** 31).long()
                                 ).amax(dim=2)
        has_real = real_b.any(dim=2)
    else:
        block_last = tgt_b[:, :, -1].long()
        has_real = torch.ones(b, nb, dtype=torch.bool, device=dev)
    hi = torch.searchsorted(src_l, (block_last + d_max).contiguous(),
                            right=True)
    overflow = (((hi - lo) > window) & has_real).sum(dim=1)

    g_n = g_np.shape[0]
    use_tap = tap_window is not None and tap_window < window
    if use_tap:
        assert tap_window % 128 == 0
        lo_tap = torch.searchsorted(
            src_l,
            (block_first[..., None] + (gdeltas.long() - 1)).reshape(b, -1)
        ).reshape(b, nb, g_n)
        rel = torch.clamp(
            torch.div(lo_tap - lo[..., None], 128, rounding_mode="floor")
            * 128, 0, window - tap_window)
        hi_tap = torch.searchsorted(
            src_l,
            (block_last[..., None] + (gdeltas.long() + 1)).reshape(b, -1),
            right=True).reshape(b, nb, g_n)
        overflow = overflow + (
            ((hi_tap - (lo[..., None] + rel)) > tap_window)
            & has_real[..., None]).sum(dim=(1, 2))
        tap_lo = rel.to(torch.int32).contiguous()
        span = int(tap_window)
    else:
        tap_lo = torch.zeros(b, nb, g_n, dtype=torch.int32, device=dev)
        span = window

    lo = lo.to(torch.int32).contiguous()
    base = torch.gather(src, 1, lo.long())
    hr = has_real.to(torch.int32).contiguous()
    pos = positions(src, tgt_ids.contiguous(), lo, tap_lo, hr, gdeltas,
                    block, span, use_tap)
    return LevelPositions(lo=lo, base=base, pos=pos, gdeltas=gdeltas,
                          has_real=hr, overflow=overflow, block=block,
                          window=window)


def posgather_conv(src_ids, src_feats, tgt_ids, weights, lp: LevelPositions,
                   scale=None, shift=None, relu=False, sentinel_start=None):
    """One submanifold or strided conv over precomputed LevelPositions.

    src_feats (B, Vs, Cin); weights (27, Cin, Cout) zyx C-order; scale /
    shift (Cout,) turn on the fused epilogue (with relu and the sentinel
    mask). Operands are bf16 on CUDA (the kernel's type), f32 on the CPU.
    Returns (B, Vt, Cout) float32."""
    compute_dtype = torch.bfloat16 if _check_device(src_feats) \
        else torch.float32
    k, cin, cout = weights.shape
    g_n = k // 3
    src_ids, src_feats = _pad_src(src_ids, src_feats.float())
    cin_p = -(-cin // 16) * 16
    wg = reorder_weights_groups(weights.float())            # (G,3,Cin,Cout)
    if cin_p != cin:
        src_feats = torch.nn.functional.pad(src_feats, (0, cin_p - cin))
        wg = torch.nn.functional.pad(wg, (0, 0, 0, cin_p - cin))
    w_flat = wg.reshape(g_n * 3 * cin_p, cout)
    return gather_conv(
        src_ids.contiguous(), src_feats.contiguous(), tgt_ids.contiguous(),
        lp.pos, lp.lo, lp.has_real, lp.gdeltas, w_flat, lp.block, lp.window,
        scale=scale, shift=shift, relu=relu,
        sentinel=sentinel_start if scale is not None else None,
        compute_dtype=compute_dtype)


# ----------------------------------------------------------------- grads


def flip_transpose_weights(weights):
    """W (K, Cin, Cout) -> the transposed conv's kernel W~[k] = W[K-1-k]^T.
    Negating every tap offset reverses the C-ordered enumeration of the
    symmetric offset ranges, so the transposed submanifold conv has the
    forward's deltas and the same LevelPositions serve both directions."""
    return weights.flip(0).transpose(1, 2)


class PosgatherSubm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, weights, ids, lp, deltas27, dw_block, dw_window):
        ctx.save_for_backward(feats, weights, ids)
        ctx.cfg = (lp, deltas27, dw_block, dw_window)
        return posgather_conv(ids, feats, ids, weights, lp)

    @staticmethod
    def backward(ctx, g):
        from .windowed_sparse import windowed_dw

        feats, weights, ids = ctx.saved_tensors
        lp, deltas27, dw_block, dw_window = ctx.cfg
        g = g.contiguous()
        d_feats = d_w = None
        if ctx.needs_input_grad[0]:
            d_feats = posgather_conv(ids, g, ids,
                                     flip_transpose_weights(weights), lp)
        if ctx.needs_input_grad[1]:
            d_w = windowed_dw(ids, feats, ids, g, deltas27, block=dw_block,
                              window=dw_window)
        return d_feats, d_w, None, None, None, None, None


def posgather_subm_diff(src_ids, src_feats, weights, deltas27,
                        lp: LevelPositions, dw_block: int = 512,
                        dw_window: int = 1536):
    """Differentiable submanifold posgather conv (training path), the
    reference's function of the same name: src_ids (B, V) is source and
    target list at once. d_feats is skipped when src_feats needs no
    gradient. Exactness: callers gate on lp.overflow."""
    return PosgatherSubm.apply(src_feats, weights, src_ids, lp, deltas27,
                                  dw_block, dw_window)
