"""Rotated BEV overlap and IoU — port of
findnpropagate_tpu/ops/rotated_iou.py (`boxes_overlap_bev`,
`boxes_aligned_overlap_bev` :132, `_height_overlap`, `boxes_iou_bev`,
`boxes_iou3d`, `boxes_aligned_iou3d` :169, `boxes_nearest_bev_iou` :184,
`limit_period_half` :209; the corners come from utils/geometry.py).

The convex intersection of two rotated rectangles, branch-free, with the
reference's fixed 24 candidates per pair: 16 edge-pair crossings, 4 corners
of A inside B, 4 corners of B inside A, each with a validity flag; the
valid candidates are sorted by angle around their centroid and the area is
the shoelace sum (invalid slots collapse onto one valid vertex and add
nothing). Leading batch axes broadcast, so the head's (B, P) x (B, M)
matching cost is one call.
"""

from __future__ import annotations

import math

import torch

from ..utils.geometry import boxes_to_corners_bev, limit_period

_EPS = 1e-8


def _inside(pts, quad):
    """pts (..., P, 2) inside quad (..., 4, 2): half-plane test against each
    edge, either winding, with a tolerance relative to |e| * |v|."""
    q0 = quad
    q1 = torch.roll(quad, -1, dims=-2)
    e = q1 - q0                                         # (..., 4, 2)
    v = pts[..., :, None, :] - q0[..., None, :, :]      # (..., P, 4, 2)
    crossz = e[..., None, :, 0] * v[..., 1] - e[..., None, :, 1] * v[..., 0]
    scale = torch.linalg.norm(e, dim=-1)[..., None, :] \
        * torch.linalg.norm(v, dim=-1)
    eps = 1e-5 * (scale + 1.0)
    orient = (q0[..., 0] * q1[..., 1] - q1[..., 0] * q0[..., 1]).sum(-1)
    s = torch.sign(orient)[..., None, None]
    return (crossz * s >= -eps).all(dim=-1)


def pair_intersection_area(corners_a, corners_b):
    """Intersection area of convex quads, corners (..., 4, 2) broadcast
    against each other -> (...)."""
    corners_a, corners_b = torch.broadcast_tensors(corners_a, corners_b)
    a0, a1 = corners_a, torch.roll(corners_a, -1, dims=-2)
    b0, b1 = corners_b, torch.roll(corners_b, -1, dims=-2)
    da = (a1 - a0)[..., :, None, :]                     # (..., 4, 1, 2)
    db = (b1 - b0)[..., None, :, :]                     # (..., 1, 4, 2)
    w = b0[..., None, :, :] - a0[..., :, None, :]       # (..., 4, 4, 2)
    denom = da[..., 0] * db[..., 1] - da[..., 1] * db[..., 0]
    ok = denom.abs() >= _EPS
    safe = torch.where(ok, denom, torch.ones_like(denom))
    t = (w[..., 0] * db[..., 1] - w[..., 1] * db[..., 0]) / safe
    u = (w[..., 0] * da[..., 1] - w[..., 1] * da[..., 0]) / safe
    inter_valid = ok & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    inter_pts = a0[..., :, None, :] + t[..., None] * da

    lead = corners_a.shape[:-2]
    pts = torch.cat([inter_pts.reshape(*lead, 16, 2), corners_a, corners_b],
                    dim=-2)                             # (..., 24, 2)
    valid = torch.cat([inter_valid.reshape(*lead, 16),
                       _inside(corners_a, corners_b),
                       _inside(corners_b, corners_a)], dim=-1)
    num_valid = valid.sum(dim=-1)
    first = torch.argmax(valid.to(torch.uint8), dim=-1)
    anchor = torch.gather(pts, -2, first[..., None, None].expand(
        *lead, 1, 2))
    pts = torch.where(valid[..., None], pts, anchor)
    center = torch.where(valid[..., None], pts, torch.zeros_like(pts)).sum(
        dim=-2) / torch.clamp(num_valid, min=1)[..., None]
    rel = pts - center[..., None, :]
    order = torch.argsort(torch.atan2(rel[..., 1], rel[..., 0]), dim=-1,
                          stable=True)
    ring = torch.gather(pts, -2, order[..., None].expand(*lead, 24, 2))
    nxt = torch.roll(ring, -1, dims=-2)
    area = 0.5 * (ring[..., 0] * nxt[..., 1]
                  - nxt[..., 0] * ring[..., 1]).sum(dim=-1).abs()
    return torch.where(num_valid >= 3, area, torch.zeros_like(area))


# pairs a block of rows of boxes_overlap_bev may hold: its 24 candidates of
# 2 floats and their sort keys take ~1 KB a pair
BLOCK_PAIRS = 1 << 21


def boxes_overlap_bev(boxes_a, boxes_b):
    """(..., N, 7), (..., M, 7) -> (..., N, M) rotated BEV intersection
    areas, in blocks of rows of at most BLOCK_PAIRS pairs (the reference's
    row blocks: the NMS of 4096 anchor boxes a sample, batch 4, would
    otherwise hold tens of GB of candidates)."""
    ca = boxes_to_corners_bev(boxes_a[..., :7])[..., :, None, :, :]
    cb = boxes_to_corners_bev(boxes_b[..., :7])[..., None, :, :, :]
    lead = math.prod(torch.broadcast_shapes(ca.shape[:-4], cb.shape[:-4]))
    rows = max(1, BLOCK_PAIRS // max(1, lead * cb.shape[-3]))
    if ca.shape[-4] <= rows:
        return pair_intersection_area(ca, cb)
    return torch.cat([pair_intersection_area(ca[..., i:i + rows, :, :, :],
                                             cb)
                      for i in range(0, ca.shape[-4], rows)], dim=-2)


def _height_overlap(boxes_a, boxes_b):
    """(..., N, 7), (..., M, 7) -> (..., N, M) z-extent overlaps."""
    a_top = (boxes_a[..., 2] + boxes_a[..., 5] / 2)[..., :, None]
    a_bot = (boxes_a[..., 2] - boxes_a[..., 5] / 2)[..., :, None]
    b_top = (boxes_b[..., 2] + boxes_b[..., 5] / 2)[..., None, :]
    b_bot = (boxes_b[..., 2] - boxes_b[..., 5] / 2)[..., None, :]
    return torch.clamp(torch.minimum(a_top, b_top)
                       - torch.maximum(a_bot, b_bot), min=0.0)


def boxes_iou_bev(boxes_a, boxes_b):
    """(..., N, 7), (..., M, 7) -> (..., N, M) rotated BEV IoU."""
    overlap = boxes_overlap_bev(boxes_a, boxes_b)
    area_a = (boxes_a[..., 3] * boxes_a[..., 4])[..., :, None]
    area_b = (boxes_b[..., 3] * boxes_b[..., 4])[..., None, :]
    return overlap / torch.clamp(area_a + area_b - overlap, min=_EPS)


def boxes_iou3d(boxes_a, boxes_b):
    """(..., N, 7), (..., M, 7) -> (..., N, M) 3D IoU: the rotated BEV
    overlap times the height overlap over the union of the volumes."""
    overlap_3d = boxes_overlap_bev(boxes_a, boxes_b) \
        * _height_overlap(boxes_a, boxes_b)
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return overlap_3d / torch.clamp(vol_a + vol_b - overlap_3d, min=1e-6)


def boxes_aligned_overlap_bev(boxes_a, boxes_b):
    """(..., 7), (..., 7) -> (...) rotated BEV intersection areas, pair by
    pair."""
    return pair_intersection_area(boxes_to_corners_bev(boxes_a[..., :7]),
                                  boxes_to_corners_bev(boxes_b[..., :7]))


def boxes_aligned_iou3d(boxes_a, boxes_b):
    """(..., 7), (..., 7) -> (...) 3D IoU, pair by pair."""
    a_top = boxes_a[..., 2] + boxes_a[..., 5] / 2
    a_bot = boxes_a[..., 2] - boxes_a[..., 5] / 2
    b_top = boxes_b[..., 2] + boxes_b[..., 5] / 2
    b_bot = boxes_b[..., 2] - boxes_b[..., 5] / 2
    overlap_h = torch.clamp(torch.minimum(a_top, b_top)
                            - torch.maximum(a_bot, b_bot), min=0.0)
    overlap_3d = boxes_aligned_overlap_bev(boxes_a, boxes_b) * overlap_h
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    return overlap_3d / torch.clamp(vol_a + vol_b - overlap_3d, min=1e-6)


def limit_period_half(val):
    """Wrap to [-pi/2, pi/2): offset 0.5, period pi."""
    return limit_period(val, 0.5, math.pi)


def _nearest_bev(boxes):
    """(..., 7) -> x1, y1, x2, y2 (...) of the axis-aligned box at the
    nearest cardinal heading (dx and dy swap past pi/4)."""
    rot = limit_period_half(boxes[..., 6]).abs()
    swap = rot > math.pi / 4
    dx = torch.where(swap, boxes[..., 4], boxes[..., 3])
    dy = torch.where(swap, boxes[..., 3], boxes[..., 4])
    x, y = boxes[..., 0], boxes[..., 1]
    return x - dx / 2, y - dy / 2, x + dx / 2, y + dy / 2


def boxes_nearest_bev_iou(boxes_a, boxes_b):
    """(..., N, 7), (..., M, 7) -> (..., N, M) "nearest BEV" IoU: each box
    snapped to its nearest cardinal heading, then the plain 2D IoU, rounded
    as the reference rounds it (the anchor assignment's force-matching
    compares these values for equality). The reference's compiled float32
    arithmetic (XLA on the CPU) fuses the product of b's area into the sum
    of the two areas, one rounding for both (an FMA); the port forms that
    sum in float64, exact, and rounds it once to float32, which gives the
    FMA's value on the CPU and on CUDA alike. Each axis is worked
    separately, so no (N, M, 2) intermediate is built."""
    ax1, ay1, ax2, ay2 = _nearest_bev(boxes_a)
    bx1, by1, bx2, by2 = _nearest_bev(boxes_b)
    w = torch.clamp(torch.minimum(ax2[..., :, None], bx2[..., None, :])
                    - torch.maximum(ax1[..., :, None], bx1[..., None, :]),
                    min=0.0)
    h = torch.clamp(torch.minimum(ay2[..., :, None], by2[..., None, :])
                    - torch.maximum(ay1[..., :, None], by1[..., None, :]),
                    min=0.0)
    overlap = w * h
    del w, h
    area_a = ((ax2 - ax1) * (ay2 - ay1))[..., :, None].double()
    area_b = ((bx2 - bx1).double() * (by2 - by1).double())[..., None, :]
    areas = (area_a + area_b).to(overlap.dtype)
    return overlap / torch.clamp(areas - overlap, min=_EPS)
