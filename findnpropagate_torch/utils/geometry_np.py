"""Host-side numpy geometry of the data pipeline (augmentation, the
gt-database and pseudo-label collision checks) — the port's own copy of
findnpropagate_tpu/utils/geometry_np.py.

Same conventions as utils/geometry.py (the torch twin). The rotated BEV IoU
runs in the host C++ library (findnpropagate_torch/native); its numpy
polygon clip, `boxes_bev_iou_plain`, is the plain version the tests hold it
against.
"""

from __future__ import annotations

import numpy as np


def limit_period(val, offset=0.5, period=np.pi):
    return val - np.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """points (N, 3+C), scalar angle."""
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], dtype=points.dtype)
    out = points.copy()
    out[:, 0:3] = points[:, 0:3] @ rot
    return out


def rotate_boxes_along_z(boxes, angle):
    """boxes (N, 7+C): rotate centers, add angle to heading; velocities
    (cols 7:9 if present) rotate in-plane."""
    out = boxes.copy()
    out[:, 0:3] = rotate_points_along_z(boxes[:, 0:3], angle)
    out[:, 6] += angle
    if boxes.shape[1] > 8:
        vel = np.concatenate(
            [boxes[:, 7:9], np.zeros((len(boxes), 1), boxes.dtype)], axis=1
        )
        out[:, 7:9] = rotate_points_along_z(vel, angle)[:, 0:2]
    return out


def flip_along_x(points, boxes):
    """world flip about x axis: y -> -y (augmentor_utils.random_flip_along_x)."""
    points = points.copy()
    points[:, 1] = -points[:, 1]
    if boxes is not None and len(boxes):
        boxes = boxes.copy()
        boxes[:, 1] = -boxes[:, 1]
        boxes[:, 6] = -boxes[:, 6]
        if boxes.shape[1] > 8:
            boxes[:, 8] = -boxes[:, 8]
    return points, boxes


def flip_along_y(points, boxes):
    """world flip about y axis: x -> -x."""
    points = points.copy()
    points[:, 0] = -points[:, 0]
    if boxes is not None and len(boxes):
        boxes = boxes.copy()
        boxes[:, 0] = -boxes[:, 0]
        boxes[:, 6] = -(boxes[:, 6] + np.pi)
        if boxes.shape[1] > 8:
            boxes[:, 7] = -boxes[:, 7]
    return points, boxes


def mask_points_by_range(points, limit_range):
    return (
        (points[:, 0] >= limit_range[0])
        & (points[:, 0] <= limit_range[3])
        & (points[:, 1] >= limit_range[1])
        & (points[:, 1] <= limit_range[4])
    )


def mask_boxes_outside_range(boxes, limit_range):
    centers = boxes[:, 0:3]
    return (
        (centers >= np.asarray(limit_range[0:3])).all(axis=-1)
        & (centers <= np.asarray(limit_range[3:6])).all(axis=-1)
    )


def boxes_to_corners_3d(boxes):
    """(N, 7) -> (N, 8, 3) in the shared corner-template order
    (box_utils.boxes_to_corners_3d)."""
    template = np.array([
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
    ], np.float32) / 2
    c = template[None] * boxes[:, None, 3:6]
    cos, sin = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = c[..., 0] * cos[:, None] - c[..., 1] * sin[:, None]
    y = c[..., 0] * sin[:, None] + c[..., 1] * cos[:, None]
    return np.stack([x, y, c[..., 2]], -1) + boxes[:, None, :3]


def boxes_to_corners_bev(boxes):
    """(N, 7) -> (N, 4, 2)."""
    h = boxes[:, 3] / 2
    w = boxes[:, 4] / 2
    template = np.stack(
        [
            np.stack([h, w], -1),
            np.stack([-h, w], -1),
            np.stack([-h, -w], -1),
            np.stack([h, -w], -1),
        ],
        axis=1,
    )  # (N, 4, 2)
    c = np.cos(boxes[:, 6])[:, None]
    s = np.sin(boxes[:, 6])[:, None]
    x = template[..., 0] * c - template[..., 1] * s
    y = template[..., 0] * s + template[..., 1] * c
    return np.stack([x, y], -1) + boxes[:, None, 0:2]


def points_in_boxes_mask(points, boxes):
    """(P, 3), (N, 7) -> (N, P) bool."""
    shift = points[None, :, 0:3] - boxes[:, None, 0:3]
    c = np.cos(-boxes[:, 6])[:, None]
    s = np.sin(-boxes[:, 6])[:, None]
    lx = shift[..., 0] * c - shift[..., 1] * s
    ly = shift[..., 0] * s + shift[..., 1] * c
    return (
        (np.abs(lx) <= boxes[:, None, 3] / 2)
        & (np.abs(ly) <= boxes[:, None, 4] / 2)
        & (np.abs(shift[..., 2]) <= boxes[:, None, 5] / 2)
    )


def _clip_halfplane(poly, a, b):
    """Clip convex polygon `poly` (K, 2) by the half-plane left of a->b."""
    e = b - a
    d = e[0] * (poly[:, 1] - a[1]) - e[1] * (poly[:, 0] - a[0])
    out = []
    k = len(poly)
    for i in range(k):
        cur, nxt = poly[i], poly[(i + 1) % k]
        dc, dn = d[i], d[(i + 1) % k]
        if dc >= 0:
            out.append(cur)
        if (dc >= 0) != (dn >= 0):
            t = dc / (dc - dn)
            out.append(cur + t * (nxt - cur))
    return np.asarray(out) if out else np.zeros((0, 2))


def _rect_inter_area(ca, cb):
    """Exact intersection area of two rectangles given CCW corners (4, 2)."""
    poly = ca.astype(np.float64)
    cb = cb.astype(np.float64)
    # CCW so left-of-edge == inside
    e0, e1 = cb[1] - cb[0], cb[2] - cb[1]
    if e0[0] * e1[1] - e0[1] * e1[0] < 0:
        cb = cb[::-1]
    for e in range(4):
        poly = _clip_halfplane(poly, cb[e], cb[(e + 1) % 4])
        if len(poly) < 3:
            return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def boxes_bev_iou_cpu(boxes_a, boxes_b):
    """EXACT rotated BEV IoU for host-side collision checks — the contract
    of the reference's iou3d_nms_utils.boxes_bev_iou_cpu (C++ polygon
    clip), through the native library; raises where it cannot be built."""
    boxes_a = np.asarray(boxes_a, np.float32)
    boxes_b = np.asarray(boxes_b, np.float32)
    if boxes_a.size == 0 or boxes_b.size == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    from .. import native

    return native.iou_bev7(boxes_a[:, :7], boxes_b[:, :7])


def boxes_bev_iou_plain(boxes_a, boxes_b):
    """The same IoU by numpy Sutherland-Hodgman clipping with an AABB
    pre-filter (pairs whose axis-aligned hulls do not touch have IoU
    exactly 0): the plain version of boxes_bev_iou_cpu."""
    boxes_a = np.asarray(boxes_a, np.float32)
    boxes_b = np.asarray(boxes_b, np.float32)
    if boxes_a.size == 0 or boxes_b.size == 0:
        return np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    ca = boxes_to_corners_bev(boxes_a)
    cb = boxes_to_corners_bev(boxes_b)
    a_min, a_max = ca.min(axis=1), ca.max(axis=1)
    b_min, b_max = cb.min(axis=1), cb.max(axis=1)
    touch = ((a_min[:, None] <= b_max[None, :])
             & (a_max[:, None] >= b_min[None, :])).all(-1)
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    out = np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    for i, j in zip(*np.nonzero(touch)):
        inter = _rect_inter_area(ca[i], cb[j])
        union = float(area_a[i]) + float(area_b[j]) - inter
        out[i, j] = inter / union if union > 1e-8 else 0.0
    return out
