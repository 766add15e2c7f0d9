"""Core 3D box / point geometry — port of
findnpropagate_tpu/utils/geometry.py:18-141.

Boxes are (..., 7+C) = [x, y, z, dx, dy, dz, heading, ...] with (x, y, z)
the box centre in the LiDAR frame and the heading about +z. Leading batch
axes broadcast. The 3x3 rotations are written out element by element (no
matmul), so the CPU and a CUDA card round every product and sum alike.
"""

from __future__ import annotations

import numpy as np
import torch

# Corner template in the reference's corner order:
#        7 -------- 4
#       /|         /|
#      6 -------- 5 .
#      | |        | |
#      . 3 -------- 0
#      |/         |/
#      2 -------- 1
CORNER_TEMPLATE = np.array(
    [
        [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
        [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
    ],
    dtype=np.float32,
) / 2.0


def rotate_points_along_z(points, angle):
    """points (..., N, 3+C) rotated by angle (...,) about +z (row vectors
    times [[cos, sin, 0], [-sin, cos, 0], [0, 0, 1]]); extra columns pass
    through."""
    cosa = torch.cos(angle)[..., None]
    sina = torch.sin(angle)[..., None]
    x, y = points[..., 0], points[..., 1]
    return torch.cat([torch.stack([x * cosa - y * sina, x * sina + y * cosa],
                                  dim=-1), points[..., 2:]], dim=-1)


def rotate_points_2d(points, angle):
    """points (..., 2); angle broadcastable. Positive x==>y rotation."""
    cosa = torch.cos(angle)
    sina = torch.sin(angle)
    x = points[..., 0] * cosa - points[..., 1] * sina
    y = points[..., 0] * sina + points[..., 1] * cosa
    return torch.stack([x, y], dim=-1)


def boxes_to_corners_3d(boxes3d):
    """(..., 7) -> (..., 8, 3) corners in the reference's order."""
    template = torch.as_tensor(CORNER_TEMPLATE, dtype=boxes3d.dtype,
                               device=boxes3d.device)
    corners = boxes3d[..., None, 3:6] * template
    corners = rotate_points_along_z(corners, boxes3d[..., 6])
    return corners + boxes3d[..., None, 0:3]


def boxes_to_corners_bev(boxes):
    """(..., 7) -> (..., 4, 2) BEV corners: (+x,+y), (-x,+y), (-x,-y),
    (+x,-y) in the box frame, rotated by the heading, moved to the centre."""
    h = boxes[..., 3] / 2
    w = boxes[..., 4] / 2
    template = torch.stack([torch.stack([h, w], -1), torch.stack([-h, w], -1),
                            torch.stack([-h, -w], -1),
                            torch.stack([h, -w], -1)], dim=-2)
    return rotate_points_2d(template, boxes[..., None, 6]) \
        + boxes[..., None, 0:2]


def points_in_rotated_boxes(points, boxes, cos_neg, sin_neg,
                            z_margin: float = 0.0, xy_margin: float = 0.0):
    """`points_in_boxes_mask` with cos(-heading), sin(-heading) (..., N)
    given, so that a caller can compute them once: (..., N, P) bool."""
    sx = points[..., None, :, 0] - boxes[..., :, None, 0]
    sy = points[..., None, :, 1] - boxes[..., :, None, 1]
    sz = points[..., None, :, 2] - boxes[..., :, None, 2]
    c = cos_neg[..., None]
    s = sin_neg[..., None]
    local_x = sx * c - sy * s
    local_y = sx * s + sy * c
    return ((local_x.abs() <= boxes[..., None, 3] / 2 + xy_margin)
            & (local_y.abs() <= boxes[..., None, 4] / 2 + xy_margin)
            & (sz.abs() <= boxes[..., None, 5] / 2 + z_margin))


def points_in_boxes_mask(points, boxes, z_margin: float = 0.0,
                         xy_margin: float = 0.0):
    """points (..., P, 3), boxes (..., N, 7) -> (..., N, P) bool: the point
    lies inside the rotated box (translate to the centre, rotate by
    -heading, |local| <= dim / 2)."""
    return points_in_rotated_boxes(points, boxes, torch.cos(-boxes[..., 6]),
                                   torch.sin(-boxes[..., 6]), z_margin,
                                   xy_margin)


def points_in_boxes_index(points, boxes, boxes_mask=None):
    """points (P, 3), boxes (N, 7) -> (P,) int32 index of the first box
    that contains the point, -1 if none."""
    inside = points_in_boxes_mask(points, boxes)
    if boxes_mask is not None:
        inside = inside & boxes_mask[:, None]
    first = torch.argmax(inside.to(torch.uint8), dim=0).to(torch.int32)
    return torch.where(inside.any(dim=0), first, torch.full_like(first, -1))
