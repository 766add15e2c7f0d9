"""ROI pooling: ROI-aware voxel pooling and ROI point pooling — port of
findnpropagate_tpu/ops/roi_pool.py (`_to_local` :24, `roiaware_pool3d`
:33, `roipoint_pool3d` :76).

Both take the batch axis first, the reference's per-sample arguments
stacked: rois (B, R, 7), points (B, P, 3), feats (B, P, C), points_mask
(B, P). The reference's conventions:
  * the local frame: rotate by -heading about the box centre;
  * a point is inside where |local| < dim / 2 + 1e-5 on each axis;
  * its cell: int((local + d / 2) / (d / out)) clamped into [0, out);
  * ROI-aware max pooling gives 0 for an empty cell, avg pooling the mean
    of the cell's points (0 when empty);
  * ROI point pooling keeps each ROI's first `num_sampled` inside points
    in index order (global xyz, then the features; zero slots past the
    count) and flags the ROIs with none.
The reference forms every (ROI, point) pair of a sample, with its cell
index: at Waymo Part-A2's test setting (300 ROIs, 150000 voxels) that is
45 M pairs a sample. Here the inside test runs over chunks of ROIs whose
(ROI, point) block holds at most `CHUNK_ELEMS` entries, and only the
inside pairs are gathered and scattered (`scatter_reduce` amax, whose
gradient splits evenly among equal maxima as the reference's scatter-max
does; `index_add` for the sums); the point pooling ranks the inside points
by a running count and finds the s-th by `torch.searchsorted`. The
results equal the unchunked ones.
"""

from __future__ import annotations

import torch

CHUNK_ELEMS = 1 << 26       # (ROI, point) entries of one chunk
MARGIN = 1e-5


def _local(points, boxes):
    """points (P, 3), boxes (R, 7) -> local x, y, z (R, P) each."""
    sx = points[None, :, 0] - boxes[:, None, 0]
    sy = points[None, :, 1] - boxes[:, None, 1]
    sz = points[None, :, 2] - boxes[:, None, 2]
    c = torch.cos(-boxes[:, 6])[:, None]
    s = torch.sin(-boxes[:, 6])[:, None]
    return sx * c - sy * s, sx * s + sy * c, sz


def _inside(lx, ly, lz, boxes, mask):
    return ((lx.abs() < boxes[:, None, 3] / 2 + MARGIN)
            & (ly.abs() < boxes[:, None, 4] / 2 + MARGIN)
            & (lz.abs() < boxes[:, None, 5] / 2 + MARGIN) & mask[None, :])


def _chunks(r, p, chunk_elems):
    step = max(1, int(chunk_elems or CHUNK_ELEMS) // max(int(p), 1))
    return [(s, min(s + step, r)) for s in range(0, r, step)]


def _cell(local, size, n):
    """The clamped cell index along one axis (truncation toward zero, as
    the reference's int cast)."""
    return torch.clamp(((local + size / 2) / (size / n)).to(torch.int64),
                       0, n - 1)


def roiaware_pool3d(rois, points, feats, points_mask, out_size=(6, 6, 6),
                    pool: str = "max", chunk_elems: int = None):
    """Returns (B, R, ox, oy, oz, C) pooled features, 0 in empty cells."""
    ox, oy, oz = (int(o) for o in out_size)
    n_cell = ox * oy * oz
    b, r = rois.shape[:2]
    p, c = points.shape[1], feats.shape[-1]
    flat_idx, flat_pts = [], []
    with torch.no_grad():
        for i in range(b):
            for s, e in _chunks(r, p, chunk_elems):
                box = rois[i, s:e]
                lx, ly, lz = _local(points[i], box)
                rr, pp = torch.nonzero(
                    _inside(lx, ly, lz, box, points_mask[i]), as_tuple=True)
                cell = (_cell(lx[rr, pp], box[rr, 3], ox) * oy
                        + _cell(ly[rr, pp], box[rr, 4], oy)) * oz \
                    + _cell(lz[rr, pp], box[rr, 5], oz)
                del lx, ly, lz
                flat_idx.append((i * r + s + rr) * n_cell + cell)
                flat_pts.append(i * p + pp)
        idx = torch.cat(flat_idx)
        src_rows = torch.cat(flat_pts)
    src = feats.reshape(b * p, c)[src_rows]
    if pool == "max":
        # from -inf, as the reference: a tie with the initial value would
        # take a share of the gradient
        out = feats.new_full((b * r * n_cell, c), -torch.inf).scatter_reduce(
            0, idx[:, None].expand(-1, c), src, "amax", include_self=False)
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    else:
        ssum = feats.new_zeros(b * r * n_cell, c).index_add(0, idx, src)
        cnt = torch.zeros(b * r * n_cell, dtype=feats.dtype,
                          device=feats.device).index_add_(
            0, idx, torch.ones_like(idx, dtype=feats.dtype))
        out = ssum / torch.clamp(cnt, min=1.0)[:, None]
    return out.reshape(b, r, ox, oy, oz, c)


def roipoint_pool3d(rois, points, feats, points_mask, num_sampled: int = 512,
                    chunk_elems: int = None):
    """Returns (pooled (B, R, S, 3 + C): global xyz and features of each
    ROI's first S inside points, zero past the count; empty (B, R) bool,
    the ROIs with no inside point)."""
    s_n = int(num_sampled)
    b, r = rois.shape[:2]
    p = points.shape[1]
    idx = torch.empty(b, r, s_n, dtype=torch.int64, device=points.device)
    cnt = torch.empty(b, r, dtype=torch.int64, device=points.device)
    slots = torch.arange(1, s_n + 1, dtype=torch.int32, device=points.device)
    with torch.no_grad():
        for i in range(b):
            for s, e in _chunks(r, p, chunk_elems):
                box = rois[i, s:e]
                inside = _inside(*_local(points[i], box), box,
                                 points_mask[i])
                rank = torch.cumsum(inside.to(torch.int32), dim=1,
                                    dtype=torch.int32)
                del inside
                cnt[i, s:e] = rank[:, -1]
                idx[i, s:e] = torch.searchsorted(
                    rank, slots.expand(e - s, s_n).contiguous())
                del rank
    cnt = torch.clamp(cnt, max=s_n)
    idx = torch.clamp(idx, max=p - 1)
    both = torch.cat([points, feats], dim=-1)
    pooled = torch.gather(
        both, 1, idx.reshape(b, r * s_n, 1).expand(-1, -1, both.shape[-1])
    ).reshape(b, r, s_n, both.shape[-1])
    ok = torch.arange(s_n, device=points.device) < cnt[..., None]
    pooled = torch.where(ok[..., None], pooled, torch.zeros_like(pooled))
    return pooled, cnt == 0
