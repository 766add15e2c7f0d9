"""CenterNet-style heatmap targets and decode — port of `gaussian_radius`,
`draw_heatmap` and `topk_heatmap`,
findnpropagate_tpu/models/model_utils/centernet.py:19-96. All take any
leading batch axes (the reference vmaps them)."""

from __future__ import annotations

import torch

from ..post_processing import top_k_lower_index_first


def gaussian_radius(height, width, min_overlap: float = 0.5):
    """Elementwise CenterNet radius."""
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp(b1 ** 2 - 4 * c1, min=0.0))) / 2

    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp(b2 ** 2 - 16 * c2, min=0.0))) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp(b3 ** 2 - 4 * a3 * c3, min=0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def draw_heatmap(centers, radii, class_ids, valid, num_classes: int,
                 height: int, width: int):
    """Gaussian heatmap targets. centers (..., M, 2) float (x, y) in
    feature-map units; radii (..., M) int; class_ids (..., M) int,
    0-indexed; valid (..., M) bool. Returns (..., num_classes, height,
    width) float32, each pixel the largest gaussian drawn on it: centred on
    the integer centre, sigma = (2r+1)/6, cut to |dx|, |dy| <= r, values
    below float32 eps zeroed."""
    dev = centers.device
    lead = centers.shape[:-2]
    m = centers.shape[-2]
    cx = centers[..., 0].to(torch.int32)
    cy = centers[..., 1].to(torch.int32)
    radii = radii.to(torch.int32)
    ys = torch.arange(height, device=dev, dtype=torch.int32)[:, None]
    xs = torch.arange(width, device=dev, dtype=torch.int32)[None, :]
    dy = ys - cy[..., None, None]                       # (..., M, H, 1)
    dx = xs - cx[..., None, None]                       # (..., M, 1, W)
    sigma = (2 * radii + 1).float() / 6.0
    g = torch.exp(-(dx.float() ** 2 + dy.float() ** 2)
                  / (2 * sigma ** 2)[..., None, None])
    r = radii[..., None, None]
    inside = (dx.abs() <= r) & (dy.abs() <= r) & valid[..., None, None]
    g = torch.where(inside & (g >= torch.finfo(torch.float32).eps), g,
                    torch.zeros_like(g))
    cls = torch.where(valid, class_ids.long(),
                      torch.full_like(class_ids.long(), num_classes))
    heatmap = torch.zeros(*lead, num_classes + 1, height, width, device=dev)
    heatmap.scatter_reduce_(
        -3, cls[..., None, None].expand(*lead, m, height, width), g,
        reduce="amax", include_self=True)
    return heatmap[..., :num_classes, :, :]


def topk_heatmap(scores, k: int):
    """(..., C, H, W) scores -> the k best over all classes and cells:
    (scores (..., k), class_ids, ys, xs, flat cell indices (..., k) int32).
    Ties go to the lower flat index, as `jax.lax.top_k` orders them: with
    untrained weights every empty cell has the same score."""
    c, h, w = scores.shape[-3:]
    top, idx = top_k_lower_index_first(scores.flatten(-3), k)
    spatial = idx % (h * w)
    return (top, (idx // (h * w)).to(torch.int32),
            (spatial // w).to(torch.int32), (spatial % w).to(torch.int32),
            spatial.to(torch.int32))
