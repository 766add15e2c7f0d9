"""Rotated BEV overlap and IoU — port of `boxes_overlap_bev`,
`_height_overlap` and `boxes_iou_bev` of findnpropagate_tpu/ops/
rotated_iou.py:31-162 (the corners come from utils/geometry.py).

The convex intersection of two rotated rectangles, branch-free, with the
reference's fixed 24 candidates per pair: 16 edge-pair crossings, 4 corners
of A inside B, 4 corners of B inside A, each with a validity flag; the
valid candidates are sorted by angle around their centroid and the area is
the shoelace sum (invalid slots collapse onto one valid vertex and add
nothing). Leading batch axes broadcast, so the head's (B, P) x (B, M)
matching cost is one call.
"""

from __future__ import annotations

import torch

from ..utils.geometry import boxes_to_corners_bev

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


def boxes_overlap_bev(boxes_a, boxes_b):
    """(..., N, 7), (..., M, 7) -> (..., N, M) rotated BEV intersection
    areas."""
    ca = boxes_to_corners_bev(boxes_a[..., :7])[..., :, None, :, :]
    cb = boxes_to_corners_bev(boxes_b[..., :7])[..., None, :, :, :]
    return pair_intersection_area(ca, cb)


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
