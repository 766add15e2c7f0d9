"""Sparse convolution primitives of the backbone — port of
findnpropagate_tpu/ops/sparse_ops.py.

Gather mode (the reference's default ``SUBM_MODE``): a level is a
`SparseGrid`, the active list in the voxelizer's order with a dense int32
table from each cell's zyx linear id to its slot, built once per level
(`build_grid` :59) and shared by the level's convs. `subm_conv` (:86) and
`strided_conv` (:182) look each kernel tap's neighbour up in that table and
multiply the gathered rows by the tap's weights; `downsample_active_set`
(:118) builds the next level's active set by the spconv receptive-field
rule, sorted by linear id; `sparse_to_dense` (:225), `masked_batch_stats`
(:236).

Windowed mode: guard-banded (y, x, z)-major ids, `yxz_linear_ids` (:262),
`yxz_offset_deltas` (:279), `yxz_sentinel_start` (:286),
`strided_sentinel_start` (:293); the strided id mapping `strided_deltas`
(:401), `strided_base_ids` (:417); the strided active-set build emitted
sorted by output id — `win_downsample` (sort + dedup, :439),
`win_downsample_dense` (occupancy max-pool + rank select, :559) and
`win_downsample_scatter` (candidate mask + rank select, :622), three routes
to one active set; `coords_to_dense` (:791); `bev_merge` (:727), the
multi-scale collapse of VoxelNeXt's levels onto one sorted (1, ny, nx)
list; `win_inverse_conv` (:690), UNetV2's transposed convs back onto a
finer level's list. `windowed_conv` (:300) and
`subm_conv_windowed` (:385) are the reference's XLA windowed conv
(``SUBM_IMPL: xla``): a target reads tap k's neighbour only inside its
block's window of the source list, and the blocks whose neighbour span
overflows the window are counted.

The per-tap products run in float32 with TF32 off, as the reference's
run at ``Precision.HIGHEST``. Shape helpers are numpy; tensor
functions take a leading batch axis (the reference vmaps single-sample
functions). Ids are int32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..parallel.mesh import all_sum

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


# ---- gather mode: one lookup table per level --------------------------


@dataclasses.dataclass(frozen=True)
class SparseGrid:
    """One level of the gather mode: the active list and its lookup table.

    coords (B, V, 3) int32 zyx, -1 rows padding; valid (B, V) bool (inside
    the grid); table (B, nz*ny*nx + 1) int32, the slot of each cell's
    linear id, -1 where empty, the last entry an always-empty sentinel;
    shape (nz, ny, nx)."""

    coords: torch.Tensor
    valid: torch.Tensor
    table: torch.Tensor
    shape: tuple


def linear_id(coords, shape):
    """(..., 3) zyx -> ((...) int64 linear id, inside); a cell outside the
    grid gets the sentinel nz*ny*nx."""
    nz, ny, nx = (int(s) for s in shape)
    c = coords.long()
    z, y, x = c[..., 0], c[..., 1], c[..., 2]
    inside = ((z >= 0) & (z < nz) & (y >= 0) & (y < ny) & (x >= 0)
              & (x < nx))
    lin = (z * ny + y) * nx + x
    return torch.where(inside, lin, torch.full_like(lin, nz * ny * nx)), \
        inside


def build_grid(coords, valid, shape) -> SparseGrid:
    """The lookup table of an active set (one int32 per cell and sample:
    build it once per level and share it between the level's convs)."""
    shape = tuple(int(s) for s in shape)
    n_cells = int(np.prod(shape))
    b, v = valid.shape
    lin, inside = linear_id(coords, shape)
    ok = valid & inside
    lin = torch.where(ok, lin, torch.full_like(lin, n_cells))
    slots = torch.arange(v, dtype=torch.int32, device=coords.device)
    table = torch.full((b, n_cells + 1), -1, dtype=torch.int32,
                       device=coords.device)
    table.scatter_(1, lin, torch.where(ok, slots, torch.full_like(slots, -1)))
    table[:, n_cells] = -1
    return SparseGrid(coords=coords, valid=ok, table=table, shape=shape)


def _lookup(grid: SparseGrid, cells):
    """(B, Vt, K, 3) zyx cells -> (B, Vt, K) int64 slot in `grid`, V where
    the cell is empty or outside the grid."""
    b, vt, k, _ = cells.shape
    lin, _ = linear_id(cells, grid.shape)
    slot = torch.gather(grid.table, 1, lin.reshape(b, -1)).reshape(b, vt, k)
    v = grid.coords.shape[1]
    return torch.where(slot >= 0, slot.long(), torch.full_like(
        slot, v, dtype=torch.long))


# zero rows that the taps without a neighbour read, spread over so many
# rows that the backward's per-row sums stay short (see _tap_products)
ZERO_ROWS = 1 << 16


def _tap_products(features, slot, weights):
    """sum_k features[slot[:, :, k]] @ weights[k]: (B, V, Cin) features,
    (B, Vt, K) int64 slots (V where the tap has no neighbour), (K, Cin,
    Cout) weights -> (B, Vt, Cout) float32.

    The rows are gathered by F.embedding from the features followed by
    ZERO_ROWS zero rows; a tap without a neighbour reads zero row (its
    position mod ZERO_ROWS). The backward sums each row's gradients as a
    segment of the sorted indices, one row at a time: with one shared zero
    row, the many taps of a sparse scene that have no neighbour
    would make one segment of millions of entries, summed in series (an
    indexing gather's backward, index_put_ with accumulate, adds them one
    after the other as well). chip_smoke.py's `paper_step_pair` times
    both against this one.

    The product is a plain matmul: the port leaves
    torch.backends.cuda.matmul.allow_tf32 at PyTorch's default, False,
    so on the card it runs in full float32 as the reference's
    Precision.HIGHEST; TF32 (10-bit mantissa) would put a ~1e-3 relative
    error into every sparse conv."""
    b, v, cin = features.shape
    k, _, cout = weights.shape
    vt = slot.shape[1]
    n = b * v
    table = torch.cat([features.float().reshape(n, cin),
                       features.new_zeros(ZERO_ROWS, cin,
                                          dtype=torch.float32)])
    base = torch.arange(b, device=slot.device)[:, None, None] * v
    spread = torch.arange(vt * k, device=slot.device).view(1, vt, k) \
        % ZERO_ROWS + n
    idx = torch.where(slot < v, slot + base, spread)
    rows = F.embedding(idx, table)                      # (B, Vt, K, Cin)
    return rows.reshape(b, vt, k * cin) @ weights.float().reshape(
        k * cin, cout)


def _finish(out, bias, valid, dtype):
    if bias is not None:
        out = out + bias.float()
    return torch.where(valid[..., None], out, torch.zeros_like(out)).to(dtype)


def subm_conv(grid: SparseGrid, features, weights, bias=None,
              kernel_size=(3, 3, 3)):
    """Submanifold sparse conv (output active set = input active set):
    features (B, V, Cin), weights (K, Cin, Cout) in zyx C-order ->
    (B, V, Cout), zero at invalid rows."""
    offs = torch.from_numpy(kernel_offsets(kernel_size)).to(
        grid.coords.device)
    cells = grid.coords.long()[:, :, None, :] + offs
    out = _tap_products(features, _lookup(grid, cells), weights)
    return _finish(out, bias, grid.valid, features.dtype)


def _axis_candidates(i, ks, s, p, n_out):
    """Per input coordinate, the output coordinates whose receptive field
    (stride s, kernel ks, padding p) covers it: (..., max_c) candidates and
    their validity."""
    lo = -torch.div(-(i + p - ks + 1), s, rounding_mode="floor")
    hi = torch.div(i + p, s, rounding_mode="floor")
    max_c = (ks + s - 1) // s + 1
    cand = lo[..., None] + torch.arange(max_c, device=i.device)
    ok = (cand <= hi[..., None]) & (cand >= 0) & (cand < n_out)
    return cand, ok


def _candidates(coords, valid, out_shape, kernel_size, stride, padding):
    """(cz, cy, cx) candidate outputs per axis, each (B, V, m), and `ok`
    (B, V, mz, my, mx): the output cells each active input reaches."""
    nz_o, ny_o, nx_o = (int(s) for s in out_shape)
    c = coords.long()
    (kz, ky, kx), (sz, sy, sx), (pz, py, px) = kernel_size, stride, padding
    cz, okz = _axis_candidates(c[..., 0], kz, sz, pz, nz_o)
    cy, oky = _axis_candidates(c[..., 1], ky, sy, py, ny_o)
    cx, okx = _axis_candidates(c[..., 2], kx, sx, px, nx_o)
    ok = (okz[..., :, None, None] & oky[..., None, :, None]
          & okx[..., None, None, :]) & valid[..., None, None, None]
    return cz, cy, cx, ok


def downsample_active_set(grid: SparseGrid, out_shape, max_out: int,
                          kernel_size=(3, 3, 3), stride=(2, 2, 2),
                          padding=(1, 1, 1)):
    """The spconv active set of a strided conv: output cell o is active iff
    an active input lies in its receptive field. Returns (coords (B,
    max_out, 3) int32, valid (B, max_out)), ascending by linear id, the
    first max_out cells."""
    nz_o, ny_o, nx_o = (int(s) for s in out_shape)
    n_cells = nz_o * ny_o * nx_o
    b = grid.coords.shape[0]
    cz, cy, cx, ok = _candidates(grid.coords, grid.valid, out_shape,
                                 kernel_size, stride, padding)
    lin = ((cz[..., :, None, None] * ny_o + cy[..., None, :, None]) * nx_o
           + cx[..., None, None, :])
    lin = torch.where(ok, lin, torch.full_like(lin, n_cells)).reshape(b, -1)
    lin_sorted, _ = torch.sort(lin, dim=1, stable=True)
    is_real = lin_sorted < n_cells
    newseg = torch.cat(
        [is_real[:, :1],
         (lin_sorted[:, 1:] != lin_sorted[:, :-1]) & is_real[:, 1:]], dim=1)
    slot = torch.cumsum(newseg.long(), dim=1) - 1
    keep = newseg & (slot < max_out)
    write = torch.where(keep, slot, torch.full_like(slot, max_out))
    out_lin = torch.zeros(b, max_out + 1, dtype=torch.long,
                          device=lin.device)
    out_lin.scatter_(1, write, torch.where(keep, lin_sorted,
                                           torch.zeros_like(lin_sorted)))
    out_lin = out_lin[:, :max_out]
    num_out = torch.clamp(newseg.sum(dim=1), max=max_out)
    out_valid = (torch.arange(max_out, device=lin.device)[None, :]
                 < num_out[:, None])
    z = out_lin // (ny_o * nx_o)
    rem = out_lin % (ny_o * nx_o)
    coords = torch.stack([z, rem // nx_o, rem % nx_o], dim=-1)
    coords = torch.where(out_valid[..., None], coords,
                         torch.full_like(coords, -1))
    return coords.to(torch.int32), out_valid


def strided_conv(grid_in: SparseGrid, features, grid_out: SparseGrid,
                 weights, bias=None, kernel_size=(3, 3, 3),
                 stride=(2, 2, 2), padding=(1, 1, 1)):
    """Strided sparse conv from grid_in onto grid_out's active set: tap t
    of output cell o reads input cell stride*o + t - pad. features (B, Vi,
    Cin) -> (B, Vo, Cout), zero at invalid output rows."""
    dev = grid_out.coords.device
    center = np.asarray([(k - 1) // 2 for k in kernel_size])
    taps = kernel_offsets(kernel_size) + center - np.asarray(padding)
    cells = (grid_out.coords.long()[:, :, None, :]
             * torch.as_tensor(stride, device=dev)
             + torch.from_numpy(taps).to(dev))
    out = _tap_products(features, _lookup(grid_in, cells), weights)
    return _finish(out, bias, grid_out.valid, features.dtype)


def sparse_to_dense(grid: SparseGrid, features):
    """(B, V, C) active features -> dense (B, C, nz, ny, nx)."""
    return coords_to_dense(grid.coords, grid.valid, features, grid.shape)


def masked_batch_stats(features, valid):
    """Mean and biased variance over the valid rows: features (..., C),
    valid (...) -> ((C,), (C,)); over the global batch inside a
    data-parallel training step (parallel/mesh.py::all_sum)."""
    m = valid[..., None].to(features.dtype)
    axes = tuple(range(features.ndim - 1))
    total, n = all_sum((features * m).sum(axes), m.sum())
    n = torch.clamp(n, min=1.0)
    mean = total / n
    var = all_sum((((features - mean) ** 2) * m).sum(axes)) / n
    return mean, var


# ---- windowed mode: guard-banded (y, x, z)-major ids -------------------


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


def _candidate_ids(coords, valid, out_shape, kernel_size, stride,
                   padding):
    """(B, V*m) guard-banded output ids of every output cell each active
    input reaches, yxz_sentinel_start(out_shape) where none."""
    b = coords.shape[0]
    cz, cy, cx, ok = _candidates(coords, valid, out_shape, kernel_size,
                                 stride, padding)
    stride_x, stride_y = yxz_strides(out_shape)
    cid = (cy[..., None, :, None] * stride_y
           + (cx[..., None, None, :] + 1) * stride_x
           + (cz[..., :, None, None] + 1))
    sentinel = yxz_sentinel_start(out_shape)
    return torch.where(ok, cid, torch.full_like(cid, sentinel)).reshape(b, -1)


def _rank_select(active, max_out: int):
    """The first max_out set positions of each row of a (B, N) bool mask,
    ascending: (positions (B, max_out) int64, garbage where invalid;
    valid (B, max_out))."""
    b, dev = active.shape[0], active.device
    rank = torch.cumsum(active.to(torch.int64), dim=1) - 1
    take = active & (rank < max_out)
    slot = torch.where(take, rank, torch.full_like(rank, max_out))
    pos = torch.arange(active.shape[1], device=dev).expand_as(rank)
    out_pos = torch.zeros(b, max_out + 1, dtype=torch.int64, device=dev)
    out_pos.scatter_(1, slot, pos)
    num_out = torch.clamp(active.sum(dim=1), max=max_out)
    out_valid = (torch.arange(max_out, device=dev)[None, :]
                 < num_out[:, None])
    return out_pos[:, :max_out], out_valid


def win_downsample(coords, valid, in_shape, out_shape, max_out: int,
                   kernel_size=(3, 3, 3), stride=(2, 2, 2),
                   padding=(1, 1, 1)):
    """Strided active-set build by candidate expansion + sort + dedup.
    coords (B, V, 3) zyx, valid (B, V) -> (ids, coords, valid) of the
    output level, sorted ascending by output id, fixed size max_out."""
    cid = _candidate_ids(coords, valid, out_shape, kernel_size, stride,
                         padding)
    sentinel = yxz_sentinel_start(out_shape)
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


def win_downsample_scatter(coords, valid, in_shape, out_shape, max_out: int,
                           kernel_size=(3, 3, 3), stride=(2, 2, 2),
                           padding=(1, 1, 1)):
    """Same contract as win_downsample, without a sort: the candidate ids
    set a mask over the guard-banded output id space (duplicates coalesce),
    and the first max_out set ids are ranked out of it."""
    cid = _candidate_ids(coords, valid, out_shape, kernel_size, stride,
                         padding)
    sentinel = yxz_sentinel_start(out_shape)
    mask = torch.zeros(cid.shape[0], sentinel + 1, dtype=torch.bool,
                       device=cid.device)
    mask.scatter_(1, cid, True)
    out_ids, out_valid = _rank_select(mask[:, :sentinel], max_out)
    return _ids_to_output(out_ids, out_valid, out_shape)


def win_downsample_dense(coords, valid, in_shape, out_shape, max_out: int,
                         kernel_size=(3, 3, 3), stride=(2, 2, 2),
                         padding=(1, 1, 1)):
    """Same contract as win_downsample, by a dense (y, x, z) occupancy grid
    max-pooled over the kernel footprint, then the first max_out active
    cells in flat order (ascending flat (y, x, z) order == ascending id).
    Costs one dense grid per sample."""
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
    out_pos, out_valid = _rank_select(pooled.reshape(b, -1) > 0, max_out)

    oy = out_pos // (nx_o * nz_o)
    rem = out_pos % (nx_o * nz_o)
    ox = rem // nz_o
    oz = rem % nz_o
    stride_x, stride_y = yxz_strides(out_shape)
    out_ids = oy * stride_y + (ox + 1) * stride_x + (oz + 1)
    return _ids_to_output(out_ids, out_valid, out_shape)


def windowed_conv(src_ids, src_feats, tgt_ids, weights, deltas,
                  block: int = 256, window: int = 512, sentinel_start=None):
    """The reference's XLA windowed conv: for every target t and tap k,
    ``src_feats[src_ids == tgt_ids[t] + deltas[k]] @ weights[k]`` summed
    over k, where the matching source row is read only inside the window
    ``[lo, lo + window)`` of t's block for tap k, lo being the block's first
    real target plus the delta, searched in the sources and clamped so the
    window stays inside the list.

    src_ids (B, Vs) ascending, src_feats (B, Vs, Cin) zero at invalid
    slots, tgt_ids (B, Vt) ascending with Vt % block == 0, weights (K, Cin,
    Cout), deltas (K,) source-space id deltas (numpy). Returns (out (B, Vt,
    Cout) in src_feats' dtype, overflow (B,) int64: the (block, tap) pairs
    with a real target whose neighbour span exceeds the window — any such
    pair loses neighbours, as the reference's does). The window is
    searched, not compared: the rows are found by one search over the whole
    list and kept when they fall inside it."""
    b, vs, cin = src_feats.shape
    vt = tgt_ids.shape[1]
    nb = vt // block
    assert nb * block == vt, "pad Vt to a multiple of block"
    window = min(window, vs)
    dev = src_ids.device
    d = torch.as_tensor(np.asarray(deltas, np.int64), device=dev)
    k = d.shape[0]
    src = src_ids.long().contiguous()
    tgt = tgt_ids.long()
    tgt_b = tgt.reshape(b, nb, block)
    if sentinel_start is not None:
        real = tgt_b < sentinel_start
        first = torch.where(real, tgt_b, torch.full_like(tgt_b, INT32_MAX)
                            ).amin(dim=2)
        last = torch.where(real, tgt_b, torch.full_like(tgt_b, -INT32_MAX - 1)
                           ).amax(dim=2)
        has_real = real.any(dim=2)
        first = torch.where(has_real, first, torch.zeros_like(first))
    else:
        first, last = tgt_b.amin(dim=2), tgt_b.amax(dim=2)
        has_real = torch.ones_like(first, dtype=torch.bool)
    lo = torch.searchsorted(src, (first[..., None] + d).reshape(b, -1)
                            ).reshape(b, nb, k)
    lo = torch.clamp(lo, max=vs - window)
    hi = torch.searchsorted(src, (last[..., None] + d).reshape(b, -1),
                            right=True).reshape(b, nb, k)
    overflow = (((hi - lo) > window) & has_real[..., None]).sum(dim=(1, 2))

    want = (tgt[..., None] + d).reshape(b, -1)
    pos = torch.searchsorted(src, want)
    pos_c = torch.clamp(pos, max=vs - 1)
    lo_t = lo.repeat_interleave(block, dim=1).reshape(b, -1)
    hit = ((torch.gather(src, 1, pos_c) == want) & (pos >= lo_t)
           & (pos < lo_t + window))
    slot = torch.where(hit, pos_c, torch.full_like(pos_c, vs)
                       ).reshape(b, vt, k)
    out = _tap_products(src_feats, slot, weights)
    return out.to(src_feats.dtype), overflow


def subm_conv_windowed(ids, feats, weights, deltas, block: int = 256,
                       window: int = 512):
    """Submanifold windowed conv over a (y, x, z)-sorted active list:
    windowed_conv with the list as source and target. Returns (out,
    overflow)."""
    return windowed_conv(ids, feats, ids, weights, deltas, block=block,
                         window=window)


def win_inverse_conv(coarse_coords, coarse_valid, coarse_feats, fine_ids,
                     fine_valid, fine_shape, coarse_shape, weights,
                     kernel_size=(3, 3, 3), stride=(2, 2, 2),
                     padding=(1, 1, 1), block: int = 256, window: int = 512):
    """Sparse inverse (transposed) conv back onto the stored fine active
    set (the reference's :690): out[f] = sum_t coarse_feats[c] @ W_t over
    the coarse cells c with stride * c + t - padding = f. One windowed_conv:
    the coarse list mapped into the fine id space by `strided_base_ids`
    (ascending, sentinels past the fine level's) as the sources, the fine
    ids as the targets, the forward strided conv's deltas negated. Tap t of
    `weights` (K, Cin, Cout) is the forward conv's kernel position t, so
    the reference's weights carry over as they are.

    coarse_coords (B, Vc, 3) sorted by their own ids, fine_ids (B, Vf)
    ascending with Vf % block == 0. Plain PyTorch in every kernel mode, as
    the reference calls its XLA windowed conv here. Returns (out (B, Vf,
    Cout) zero at invalid fine slots, overflow (B,))."""
    base = strided_base_ids(coarse_coords, coarse_valid, stride, fine_shape,
                            coarse_shape)
    deltas = strided_deltas(kernel_size, stride, padding, fine_shape)
    feats = torch.where(coarse_valid[..., None], coarse_feats,
                        torch.zeros_like(coarse_feats))
    out, ovf = windowed_conv(base, feats, fine_ids, weights, -deltas,
                             block=block, window=window,
                             sentinel_start=yxz_sentinel_start(fine_shape))
    return torch.where(fine_valid[..., None], out, torch.zeros_like(out)), \
        ovf


def bev_merge(coords_list, valid_list, feats_list, scales, bev_shape,
              max_out: int):
    """VoxelNeXt's multi-scale sparse BEV collapse: each level's (y, x)
    coords scaled by its entry of `scales` into the (ny, nx) grid, z
    dropped, and the features of coinciding cells summed. coords (B, V_i,
    3) zyx, valid (B, V_i), feats (B, V_i, C) per level. Returns (ids
    (B, max_out) int32, coords (B, max_out, 3) zyx with z = 0, valid,
    feats (B, max_out, C)) sorted by the (1, ny, nx) guard-banded id
    ``y * stride_y + (x + 1) * stride_x + 1`` — `yxz_linear_ids` at z = 0
    — the first max_out cells kept, sentinels after them.

    The candidates are concatenated in the levels' order and sorted
    stably, so a cell's contributions stand in that order and are summed
    left to right, as the reference's sequential scatter-add sums them;
    the sum is taken by shifted adds over the sorted list (a cell has at
    most as many contributions as the longest run of one id), the same
    bits on every device."""
    ny, nx = (int(s) for s in bev_shape)
    shape2d = (1, ny, nx)
    stride_x, stride_y = yxz_strides(shape2d)
    sentinel = yxz_sentinel_start(shape2d)
    all_ids, all_feats = [], []
    for coords, valid, feats, s in zip(coords_list, valid_list, feats_list,
                                       scales):
        y = coords[..., 1].long() * int(s)
        x = coords[..., 2].long() * int(s)
        inside = valid & (y >= 0) & (y < ny) & (x >= 0) & (x < nx)
        ids = y * stride_y + (x + 1) * stride_x + 1
        all_ids.append(torch.where(inside, ids, torch.full_like(ids,
                                                                sentinel)))
        all_feats.append(torch.where(inside[..., None], feats,
                                     torch.zeros_like(feats)))
    ids = torch.cat(all_ids, dim=1)
    feats = torch.cat(all_feats, dim=1)
    b, n, c = feats.shape
    ids_s, order = torch.sort(ids, dim=1, stable=True)
    feats_s = torch.gather(feats, 1, order[..., None].expand(-1, -1, c))
    is_real = ids_s < sentinel
    newseg = torch.cat([is_real[:, :1],
                        (ids_s[:, 1:] != ids_s[:, :-1]) & is_real[:, 1:]],
                       dim=1)
    seg = torch.cumsum(newseg.long(), dim=1)
    key = seg + (n + 1) * torch.arange(b, device=ids.device)[:, None]
    runs = torch.bincount(key[is_real])
    longest = int(runs.max()) if runs.numel() else 1
    total = feats_s
    for k in range(1, longest):
        same = torch.zeros_like(is_real)
        same[:, :n - k] = (ids_s[:, k:] == ids_s[:, :n - k]) \
            & is_real[:, :n - k]
        nxt = torch.zeros_like(feats_s)
        nxt[:, :n - k] = feats_s[:, k:]
        total = total + torch.where(same[..., None], nxt,
                                    torch.zeros_like(nxt))
    slot = seg - 1
    in_cap = is_real & (slot < max_out) & (slot >= 0) & newseg
    write = torch.where(in_cap, slot, torch.full_like(slot, max_out))
    out_feats = feats.new_zeros(b, max_out + 1, c)
    out_feats.scatter_(1, write[..., None].expand(-1, -1, c),
                       torch.where(in_cap[..., None], total,
                                   torch.zeros_like(total)))
    out_ids = torch.full((b, max_out + 1), INT32_MAX, dtype=torch.int64,
                         device=ids.device)
    out_ids.scatter_(1, write, torch.where(in_cap, ids_s,
                                           torch.full_like(ids_s, INT32_MAX)))
    out_feats, out_ids = out_feats[:, :max_out], out_ids[:, :max_out]
    num_out = torch.clamp(newseg.sum(dim=1), max=max_out)
    slots = torch.arange(max_out, device=ids.device)
    out_valid = slots[None, :] < num_out[:, None]
    oy = out_ids // stride_y
    ox = (out_ids % stride_y) // stride_x - 1
    out_coords = torch.where(
        out_valid[..., None], torch.stack([torch.zeros_like(oy), oy, ox],
                                          dim=-1),
        torch.full_like(oy, -1)[..., None]).to(torch.int32)
    out_ids = torch.where(out_valid, out_ids, sentinel + slots[None, :])
    return (out_ids.to(torch.int32), out_coords, out_valid,
            torch.where(out_valid[..., None], out_feats,
                        torch.zeros_like(out_feats)))


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
