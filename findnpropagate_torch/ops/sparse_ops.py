"""Sparse-level bookkeeping for the windowed / position-gather backbone —
port of the parts of findnpropagate_tpu/ops/sparse_ops.py that the
TransFusion inference path runs:

  * guard-banded (y, x, z)-major ids: `yxz_linear_ids` (:262),
    `yxz_offset_deltas` (:279), `yxz_sentinel_start` (:286),
    `strided_sentinel_start` (:293);
  * strided-conv id mapping: `strided_deltas` (:401), `strided_base_ids`
    (:417);
  * the strided active-set build, emitted sorted by output id:
    `win_downsample` (sort + dedup, :439) and `win_downsample_dense`
    (occupancy max-pool + rank select, :559). Both give the same active
    set (the spconv receptive-field rule); the backbone picks dense at
    batch <= 2 and sort above, as the reference does;
  * `coords_to_dense` (:791).

Shape helpers are numpy; tensor functions take a leading batch axis
(the reference vmaps single-sample functions). Ids are int32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

INT32_MAX = 2 ** 31 - 1


def kernel_offsets(kernel_size):
    """(K, 3) zyx offsets, centred, C-order over (kz, ky, kx) — the weight
    layout (K, Cin, Cout) of every sparse conv."""
    kz, ky, kx = kernel_size
    oz, oy, ox = np.meshgrid(
        np.arange(kz) - (kz - 1) // 2,
        np.arange(ky) - (ky - 1) // 2,
        np.arange(kx) - (kx - 1) // 2,
        indexing="ij",
    )
    return np.stack([oz, oy, ox], axis=-1).reshape(-1, 3).astype(np.int32)


def yxz_strides(shape):
    """Guard-banded id strides: +-1 guard cells in z and x, so an id delta
    never aliases across a column or row boundary."""
    nz, ny, nx = (int(s) for s in shape)
    stride_x = nz + 2
    stride_y = (nx + 2) * stride_x
    return stride_x, stride_y


def yxz_sentinel_start(shape):
    """First id used for invalid-slot sentinels by yxz_linear_ids."""
    nz, ny, nx = (int(s) for s in shape)
    stride_x, stride_y = yxz_strides(shape)
    return (ny + 1) * stride_y + stride_x + 2


def strided_sentinel_start(in_shape):
    """First sentinel used by strided_base_ids (input id space)."""
    nz, ny, nx = (int(s) for s in in_shape)
    stride_x, stride_y = yxz_strides(in_shape)
    return (ny + 2) * stride_y + 2 * stride_x


def yxz_offset_deltas(kernel_size, shape):
    """Per kernel tap, the id delta (numpy int32, (K,))."""
    stride_x, stride_y = yxz_strides(shape)
    offs = kernel_offsets(kernel_size)
    return (offs[:, 1] * stride_y + offs[:, 2] * stride_x + offs[:, 0]
            ).astype(np.int32)


def strided_deltas(kernel_size, stride, padding, in_shape):
    """Per kernel tap, the input-id-space delta of a strided conv: input
    cell = stride*o + t - pad, i.e. id_in = base(o) + delta(t)."""
    stride_x, stride_y = yxz_strides(in_shape)
    offs = kernel_offsets(kernel_size)
    center = np.asarray([(k - 1) // 2 for k in kernel_size])
    t = offs + center[None, :] - np.asarray(padding)[None, :]
    return (t[:, 1] * stride_y + (t[:, 2] + 1) * stride_x + (t[:, 0] + 1)
            ).astype(np.int32)


def yxz_linear_ids(coords, valid, shape):
    """(B, V, 3) zyx coords -> (B, V) int32 ids; invalid rows get unique
    ascending sentinels ``yxz_sentinel_start + slot``."""
    stride_x, stride_y = yxz_strides(shape)
    c = coords.long()
    ids = c[..., 1] * stride_y + (c[..., 2] + 1) * stride_x + (c[..., 0] + 1)
    slot = torch.arange(coords.shape[1], device=coords.device)
    sent = yxz_sentinel_start(shape) + slot
    return torch.where(valid, ids, sent.expand_as(ids)).to(torch.int32)


def strided_base_ids(out_coords, out_valid, stride, in_shape, out_shape):
    """Output voxels (sorted by output id) -> ascending base ids in the
    input id space; invalid rows get ``strided_sentinel_start + slot``."""
    nz_o, ny_o, nx_o = (int(s) for s in out_shape)
    sz, sy, sx = (int(s) for s in stride)
    stride_x, stride_y = yxz_strides(in_shape)
    assert sx * stride_x * (nx_o - 1) + sz * (nz_o - 1) < sy * stride_y
    assert sz * (nz_o - 1) < sx * stride_x
    c = out_coords.long()
    base = c[..., 1] * (sy * stride_y) + c[..., 2] * (sx * stride_x) \
        + c[..., 0] * sz
    slot = torch.arange(out_coords.shape[1], device=out_coords.device)
    sent = strided_sentinel_start(in_shape) + slot
    return torch.where(out_valid, base, sent.expand_as(base)).to(torch.int32)


def _ids_to_output(out_ids, out_valid, out_shape):
    """Sorted output ids (garbage where invalid) -> (ids, coords, valid)
    with the standard ascending sentinels in the invalid slots."""
    stride_x, stride_y = yxz_strides(out_shape)
    oy = out_ids // stride_y
    rem = out_ids % stride_y
    ox = rem // stride_x - 1
    oz = rem % stride_x - 1
    coords = torch.where(out_valid[..., None],
                         torch.stack([oz, oy, ox], dim=-1),
                         torch.full_like(oz, -1)[..., None])
    slot = torch.arange(out_ids.shape[1], device=out_ids.device)
    sent = yxz_sentinel_start(out_shape) + slot
    ids = torch.where(out_valid, out_ids, sent.expand_as(out_ids))
    return ids.to(torch.int32), coords.to(torch.int32), out_valid


def win_downsample(coords, valid, in_shape, out_shape, max_out: int,
                   kernel_size=(3, 3, 3), stride=(2, 2, 2),
                   padding=(1, 1, 1)):
    """Strided active-set build by candidate expansion + sort + dedup.
    coords (B, V, 3) zyx, valid (B, V) -> (ids, coords, valid) of the
    output level, sorted ascending by output id, fixed size max_out."""
    nz_o, ny_o, nx_o = (int(s) for s in out_shape)
    b = coords.shape[0]
    c = coords.long()

    def axis_candidates(i, ks, s, p, n_out):
        lo = -torch.div(-(i + p - ks + 1), s, rounding_mode="floor")
        hi = torch.div(i + p, s, rounding_mode="floor")
        max_c = (ks + s - 1) // s + 1
        cand = lo[..., None] + torch.arange(max_c, device=i.device)
        ok = (cand <= hi[..., None]) & (cand >= 0) & (cand < n_out)
        return cand, ok

    (kz, ky, kx), (sz, sy, sx), (pz, py, px) = kernel_size, stride, padding
    cz, okz = axis_candidates(c[..., 0], kz, sz, pz, nz_o)
    cy, oky = axis_candidates(c[..., 1], ky, sy, py, ny_o)
    cx, okx = axis_candidates(c[..., 2], kx, sx, px, nx_o)
    stride_x, stride_y = yxz_strides(out_shape)
    cid = (cy[..., None, :, None] * stride_y
           + (cx[..., None, None, :] + 1) * stride_x
           + (cz[..., :, None, None] + 1))
    ok = (okz[..., :, None, None] & oky[..., None, :, None]
          & okx[..., None, None, :]) & valid[..., None, None, None]
    sentinel = yxz_sentinel_start(out_shape)
    cid = torch.where(ok, cid, torch.full_like(cid, sentinel)).reshape(b, -1)

    cid_sorted, _ = torch.sort(cid, dim=1)
    is_real = cid_sorted < sentinel
    newseg = torch.cat(
        [is_real[:, :1],
         (cid_sorted[:, 1:] != cid_sorted[:, :-1]) & is_real[:, 1:]], dim=1)
    uniq = torch.where(newseg, cid_sorted,
                       torch.full_like(cid_sorted, INT32_MAX))
    uniq, _ = torch.sort(uniq, dim=1)
    if uniq.shape[1] < max_out:
        uniq = F.pad(uniq, (0, max_out - uniq.shape[1]), value=INT32_MAX)
    out_ids = uniq[:, :max_out]
    num_out = torch.clamp(newseg.sum(dim=1), max=max_out)
    out_valid = (torch.arange(max_out, device=coords.device)[None, :]
                 < num_out[:, None])
    return _ids_to_output(out_ids, out_valid, out_shape)


def win_downsample_dense(coords, valid, in_shape, out_shape, max_out: int,
                         kernel_size=(3, 3, 3), stride=(2, 2, 2),
                         padding=(1, 1, 1)):
    """Same contract as win_downsample, by a dense (y, x, z) occupancy grid
    max-pooled over the kernel footprint, then the first max_out active
    cells in flat order (ascending flat (y, x, z) order == ascending id).
    Costs one dense grid per sample; the backbone uses it at batch <= 2."""
    nz_i, ny_i, nx_i = (int(s) for s in in_shape)
    nz_o, ny_o, nx_o = (int(s) for s in out_shape)
    b = coords.shape[0]
    dev = coords.device
    c = coords.long()
    occ = torch.zeros(b, ny_i * nx_i * nz_i + 1, device=dev)
    flat = (c[..., 1] * nx_i + c[..., 2]) * nz_i + c[..., 0]
    flat = torch.where(valid, flat, torch.full_like(flat, ny_i * nx_i * nz_i))
    occ.scatter_(1, flat, 1.0)
    occ = occ[:, :-1].reshape(b, 1, ny_i, nx_i, nz_i)
    (kz, ky, kx), (sz, sy, sx), (pz, py, px) = kernel_size, stride, padding
    pooled = F.max_pool3d(occ, (ky, kx, kz), (sy, sx, sz), (py, px, pz))
    assert pooled.shape[2:] == (ny_o, nx_o, nz_o), (pooled.shape, out_shape)
    active = pooled.reshape(b, -1) > 0

    # rank-select: the r-th active cell goes to output slot r
    rank = torch.cumsum(active.to(torch.int64), dim=1) - 1
    take = active & (rank < max_out)
    slot = torch.where(take, rank, torch.full_like(rank, max_out))
    pos = torch.arange(active.shape[1], device=dev).expand_as(rank)
    out_pos = torch.zeros(b, max_out + 1, dtype=torch.int64, device=dev)
    out_pos.scatter_(1, slot, pos)
    out_pos = out_pos[:, :max_out]
    num_out = torch.clamp(active.sum(dim=1), max=max_out)
    out_valid = (torch.arange(max_out, device=dev)[None, :]
                 < num_out[:, None])

    oy = out_pos // (nx_o * nz_o)
    rem = out_pos % (nx_o * nz_o)
    ox = rem // nz_o
    oz = rem % nz_o
    stride_x, stride_y = yxz_strides(out_shape)
    out_ids = oy * stride_y + (ox + 1) * stride_x + (oz + 1)
    return _ids_to_output(out_ids, out_valid, out_shape)


def coords_to_dense(coords, valid, feats, shape):
    """(B, V, C) active features + (B, V, 3) zyx coords -> dense
    (B, C, nz, ny, nx), channels first (the reference returns the
    channels-last (nz, ny, nx, C) per sample)."""
    nz, ny, nx = (int(s) for s in shape)
    b, v, ch = feats.shape
    n = nz * ny * nx
    c = coords.long()
    inside = ((c[..., 0] >= 0) & (c[..., 0] < nz) & (c[..., 1] >= 0)
              & (c[..., 1] < ny) & (c[..., 2] >= 0) & (c[..., 2] < nx))
    keep = valid & inside
    lin = (c[..., 0] * ny + c[..., 1]) * nx + c[..., 2]
    lin = torch.where(keep, lin, torch.full_like(lin, n))
    dense = feats.new_zeros(b, n + 1, ch)
    bidx = torch.arange(b, device=feats.device)[:, None].expand(b, v)
    dense[bidx, lin] = torch.where(keep[..., None], feats,
                                   torch.zeros_like(feats))
    return dense[:, :n].reshape(b, nz, ny, nx, ch).permute(
        0, 4, 1, 2, 3).contiguous()
