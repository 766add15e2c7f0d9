"""Camera geometry of the open-vocabulary pipeline — port of
findnpropagate_tpu/openvocab/camera.py:19-143: projection of LiDAR points
into the cameras, the lift of image coordinates back to LiDAR, the image
frustum's corners, the masked quantile (torch.quantile's linear
interpolation), 2D IoU and per-class greedy 2D NMS.

The reference computes its 3x3 products at full f32 precision
(`Precision.HIGHEST`). Here they are broadcast products summed left to
right, with no matmul (so no TF32 either), and 3x3 inverses by cofactors:
the CPU and a CUDA card then round each product and sum alike, which
matters where a point lies on an image or box edge. Leading batch axes
broadcast.
"""

from __future__ import annotations

import torch

from ..ops.nms import _suppress
from ..utils.geometry import CORNER_TEMPLATE


def seq_sum(x, dim=-1):
    """Sum over a short axis, left to right (the same rounding on every
    device)."""
    parts = x.unbind(dim)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def norm3(x):
    """Euclidean norm over the last axis (2 or 3 long), left to right."""
    return torch.sqrt(seq_sum(x * x))


def matvec3(m, p):
    """m (..., 3, >=3) times the column p (..., 3) -> (..., 3), each row
    summed left to right."""
    return seq_sum(m[..., :3, :3] * p[..., None, :3])


def matmul3(a, b):
    """(..., 3, 3) @ (..., 3, 3), each entry summed left to right."""
    return seq_sum(a[..., :, None, :] * b.transpose(-1, -2)[..., None, :, :])


def inv3(m):
    """Inverse of (..., 3, 3) matrices: the adjugate over the determinant.
    The cofactor of (i, j) is m[i+1, j+1] m[i+2, j+2] - m[i+1, j+2]
    m[i+2, j+1], indices mod 3 (rolls, so no index tensor is copied to the
    device)."""
    def r(di, dj):
        return m.roll((-di, -dj), (-2, -1))

    cof = r(1, 1) * r(2, 2) - r(1, 2) * r(2, 1)
    det = seq_sum(m[..., 0, :] * cof[..., 0, :])
    return cof.transpose(-1, -2) / det[..., None, None]


def project_to_camera(points, lidar2image, lidar_aug_matrix=None,
                      image_size=(900, 1600)):
    """points (..., P, 3) in the LiDAR frame -> (u, v, depth) per camera.

    lidar2image (..., NCAM, 4, 4). Returns coords (..., NCAM, P, 3) and
    on_img (..., NCAM, P): in front of the camera and inside the image."""
    pts = points
    if lidar_aug_matrix is not None:
        # back to the raw frame: inv(R) (p - t) for the augmentation [R | t]
        pts = matvec3(inv3(lidar_aug_matrix[:3, :3]),
                      pts - lidar_aug_matrix[:3, 3])
    hom = matvec3(lidar2image[..., :, None, :3, :3], pts[..., None, :, :]) \
        + lidar2image[..., :, None, :3, 3]
    depth = torch.clamp(hom[..., 2], 1e-5, 1e5)
    u = hom[..., 0] / depth
    v = hom[..., 1] / depth
    h, w = image_size
    on_img = (hom[..., 2] > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    return torch.stack([u, v, depth], dim=-1), on_img


def lift_matrix(cam2lidar_rots, intrins):
    """cam2lidar_rots @ inv(intrins): image (u d, v d, d) -> LiDAR
    rotation, (..., 3, 3)."""
    return matmul3(cam2lidar_rots, inv3(intrins))


def lift(image_coords, combine, cam2lidar_trans, extra_rots=None,
         extra_trans=None):
    """get_geometry_at_image_coords with `lift_matrix` given."""
    d = image_coords[..., 2]
    pts = torch.stack([image_coords[..., 0] * d, image_coords[..., 1] * d, d],
                      dim=-1)
    pts = matvec3(combine, pts) + cam2lidar_trans
    if extra_rots is not None:
        pts = matvec3(extra_rots, pts)
    if extra_trans is not None:
        pts = pts + extra_trans
    return pts


def get_geometry_at_image_coords(image_coords, cam2lidar_rots,
                                 cam2lidar_trans, intrins, extra_rots=None,
                                 extra_trans=None):
    """(..., 3) [u, v, depth] -> (..., 3) LiDAR xyz; cam2lidar_rots
    (..., 3, 3), cam2lidar_trans (..., 3), intrins (..., 3, 3), gathered
    per point; extra_rots (3, 3) and extra_trans (3,) the augmentation."""
    return lift(image_coords, lift_matrix(cam2lidar_rots, intrins),
                cam2lidar_trans, extra_rots, extra_trans)


def get_cam_frustum(xyzxyz, template=None):
    """(..., 6) [x1, y1, zmin, x2, y2, zmax] image-space box -> (..., 8, 3)
    corners in the shared corner-template order. `template`: the corner
    template already on the device (else it is copied there)."""
    whl = xyzxyz[..., 3:] - xyzxyz[..., :3]
    center = (xyzxyz[..., 3:] + xyzxyz[..., :3]) / 2
    if template is None:
        template = torch.as_tensor(CORNER_TEMPLATE, dtype=xyzxyz.dtype,
                                   device=xyzxyz.device)
    return whl[..., None, :] * template + center[..., None, :]


def masked_quantile(values, mask, q):
    """torch.quantile(values[mask], q) with linear interpolation, fixed
    shape: values, mask (..., P); q a float in [0, 1]. 0 where the mask is
    empty."""
    big = torch.finfo(values.dtype).max
    v, _ = torch.sort(torch.where(mask, values, torch.full_like(values, big)),
                      dim=-1)
    n = mask.sum(dim=-1)
    idx_f = q * torch.clamp(n - 1, min=0).to(values.dtype)
    lo = torch.floor(idx_f).long()
    hi = torch.ceil(idx_f).long()
    frac = idx_f - lo.to(values.dtype)
    last = values.shape[-1] - 1
    lo_v = torch.gather(v, -1, lo.clamp(0, last)[..., None])[..., 0]
    hi_v = torch.gather(v, -1, hi.clamp(0, last)[..., None])[..., 0]
    out = lo_v * (1 - frac) + hi_v * frac
    return torch.where(n > 0, out, torch.zeros_like(out))


def boxes_2d_iou(boxes_a, boxes_b):
    """(..., N, 4), (..., M, 4) xyxy -> (..., N, M) IoU."""
    a = boxes_a[..., :, None, :]
    b = boxes_b[..., None, :, :]
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = torch.clamp((a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1]),
                         min=0.0)
    area_b = torch.clamp((b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1]),
                         min=0.0)
    return inter / torch.clamp(area_a + area_b - inter, min=1e-7)


def nms_2d(boxes, scores, labels, thresh, valid=None):
    """Per-class greedy 2D NMS (torchvision batched_nms semantics).

    boxes (..., N, 4) xyxy, scores (..., N), labels (..., N), valid
    (..., N) broadcast against each other (the seeker runs every camera's
    NMS in one call over (NCAM, D)). Returns the keep mask (..., N)."""
    s = scores if valid is None else torch.where(
        valid, scores, torch.full_like(scores, float("-inf")))
    lead = torch.broadcast_shapes(s.shape, labels.shape, boxes.shape[:-1])
    s = s.expand(lead)
    s_sorted, order = torch.sort(-s, dim=-1, stable=True)
    b = torch.gather(boxes.expand(*lead, 4), -2,
                     order[..., None].expand(*lead, 4))
    lab = torch.gather(labels.expand(lead), -1, order)
    over = (boxes_2d_iou(b, b) > thresh) & (lab[..., :, None]
                                            == lab[..., None, :])
    keep_sorted = _suppress(over, torch.isfinite(s_sorted))
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)
