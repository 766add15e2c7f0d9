"""PointNet++ primitives: farthest point sampling, ball query, grouping,
three-NN interpolation — port of findnpropagate_tpu/ops/pointnet2.py
(`farthest_point_sample` :36, `ball_query` :60, `group_points` :85,
`three_nn` :91, `three_interpolate` :100, `query_and_group` :107).

Every function takes a leading batch axis: (B, P, 3) points with a (B, P)
bool mask, the JAX functions' per-sample arguments stacked. The
semantics are the reference's to the index:
  * FPS starts at the first valid point and takes, k - 1 times, the point
    farthest from those taken (the first of equal maxima; invalid points
    at -INF, so fewer than k valid points repeat an index). The k steps
    run as one loop of device operations with no host sync;
  * ball query keeps, per center, the FIRST `nsample` in-radius point
    indices in point order, back-fills the empty slots with the first one,
    and gives index 0 and count 0 for an empty ball. The reference forms
    the whole (M, P) squared-distance matrix and takes a top_k of order
    keys; here the rank of each in-radius hit is a cumulative count along
    P, and the s-th hit is found by `torch.searchsorted` of s in that
    count (no sort). The centers run in chunks whose distance block holds
    at most `CHUNK_ELEMS` float32 entries (1 GiB), so Waymo's 4096
    keypoints over 200k raw points never form the 13 GB batch matrix; the
    result equals the unchunked one;
  * three_nn takes the 3 nearest valid known points (lower index first
    among equal distances, `lax.top_k`'s order).
Squared distances are summed x, y, z in that order in float32, as the
reference does.
"""

from __future__ import annotations

import torch

INF = 1e10
CHUNK_ELEMS = 1 << 28       # float32 entries of one ball-query block


def _sqdist(a, b):
    """(M, 3) x (P, 3) -> (M, P) squared distances."""
    d = (a[:, None, 0] - b[None, :, 0]) ** 2
    d += (a[:, None, 1] - b[None, :, 1]) ** 2
    d += (a[:, None, 2] - b[None, :, 2]) ** 2
    return d


def farthest_point_sample(points, mask, k: int):
    """points (B, P, 3), mask (B, P) bool -> (B, k) int64 indices."""
    b = points.shape[0]
    rows = torch.arange(b, device=points.device)
    neg = torch.full_like(points[..., 0], -INF)
    dists = torch.where(mask, torch.full_like(neg, INF), neg)
    last = torch.argmax(mask.to(torch.uint8), dim=1)   # first valid point
    out = [last]
    for _ in range(k - 1):
        q = points[rows, last]                          # (B, 3)
        d = (points[..., 0] - q[:, None, 0]) ** 2
        d += (points[..., 1] - q[:, None, 1]) ** 2
        d += (points[..., 2] - q[:, None, 2]) ** 2
        dists = torch.minimum(dists, torch.where(mask, d, neg))
        last = torch.argmax(dists, dim=1)
        out.append(last)
    return torch.stack(out, dim=1)


def _ball_query_one(centers, centers_mask, points, points_mask, r2,
                    nsample, chunk):
    m = centers.shape[0]
    slots = torch.arange(1, nsample + 1, dtype=torch.int32,
                         device=centers.device)
    idx_parts, cnt_parts = [], []
    for s in range(0, m, chunk):
        c = centers[s:s + chunk]
        within = (_sqdist(c, points) < r2) & points_mask[None, :] \
            & centers_mask[s:s + chunk, None]
        rank = torch.cumsum(within.to(torch.int32), dim=1, dtype=torch.int32)
        del within
        cnt = rank[:, -1]
        # the position of the s-th in-radius point: the first where the
        # running count reaches s (P where there are fewer than s)
        idx = torch.searchsorted(rank, slots.expand(c.shape[0], nsample)
                                 .contiguous())
        del rank
        idx_parts.append(idx)
        cnt_parts.append(cnt)
    idx, cnt = torch.cat(idx_parts), torch.cat(cnt_parts)
    cnt = torch.clamp(cnt, max=nsample)
    first = idx[:, :1]
    slot = torch.arange(nsample, device=idx.device)[None, :]
    idx = torch.where(slot < cnt[:, None], idx, first)     # back-fill
    idx = torch.where(cnt[:, None] > 0, idx, torch.zeros_like(idx))
    return idx, cnt


def ball_query(centers, centers_mask, points, points_mask, radius,
               nsample: int, chunk_elems: int = None):
    """centers (B, M, 3) with mask (B, M), points (B, P, 3) with mask
    (B, P) -> (idx (B, M, nsample) int64, cnt (B, M) int32): per center the
    first `nsample` valid points within `radius` in point order,
    back-filled with the first; idx 0 and cnt 0 where the ball is empty.
    `chunk_elems` (default CHUNK_ELEMS) bounds the centers x points block
    one step forms."""
    per = int(chunk_elems or CHUNK_ELEMS)
    p = max(int(points.shape[1]), 1)
    chunk = max(1, per // p)
    r2 = float(radius) * float(radius)
    outs = [_ball_query_one(centers[i], centers_mask[i], points[i],
                            points_mask[i], r2, int(nsample), chunk)
            for i in range(centers.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def group_points(feats, idx):
    """feats (B, P, C), idx (B, M, S) -> (B, M, S, C)."""
    b, m, s = idx.shape
    flat = idx.reshape(b, m * s, 1).expand(-1, -1, feats.shape[-1])
    return torch.gather(feats, 1, flat).reshape(b, m, s, feats.shape[-1])


def three_nn(unknown, unknown_mask, known, known_mask):
    """unknown (B, N, 3), known (B, M, 3) with mask (B, M) -> (dist
    (B, N, 3), idx (B, N, 3) int64) of the 3 nearest valid known points.
    `unknown_mask` is not read, as in the reference."""
    d2 = torch.stack([_sqdist(u, k) for u, k in zip(unknown, known)])
    d2 = torch.where(known_mask[:, None, :], d2, torch.full_like(d2, INF))
    vals, idx = torch.sort(d2, dim=-1, stable=True)
    return torch.sqrt(torch.clamp(vals[..., :3], min=0.0)), idx[..., :3]


def three_interpolate(feats, idx, dist):
    """feats (B, M, C); idx / dist (B, N, 3) -> (B, N, C), inverse squared
    distance weighted."""
    w = 1.0 / torch.clamp(dist, min=1e-8) ** 2
    w = w / w.sum(dim=-1, keepdim=True)
    return (group_points(feats, idx) * w[..., None]).sum(dim=2)


def query_and_group(centers, centers_mask, points, points_mask, feats,
                    radius, nsample: int, use_xyz: bool = True,
                    chunk_elems: int = None):
    """Ball query + grouping relative to the center (QueryAndGroup):
    (grouped (B, M, S, 3 + C) — or (B, M, S, C) without `use_xyz`, or the
    relative xyz alone when `feats` is None — zero where the ball is
    empty, cnt (B, M))."""
    idx, cnt = ball_query(centers, centers_mask, points, points_mask,
                          radius, nsample, chunk_elems)
    out = group_points(points, idx) - centers[:, :, None, :]
    if feats is not None:
        grouped = group_points(feats, idx)
        out = torch.cat([out, grouped], dim=-1) if use_xyz else grouped
    out = torch.where((cnt > 0)[..., None, None], out, torch.zeros_like(out))
    return out, cnt
