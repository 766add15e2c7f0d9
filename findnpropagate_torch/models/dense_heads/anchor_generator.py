"""Anchor grid generation — port of
findnpropagate_tpu/models/dense_heads/anchor_generator.py (whole file):
numpy, computed once per config. Per class an anchor set over the feature
map, laid out so that the flattened order (y, x, class * size, rot) is the
head's conv output order.
"""

from __future__ import annotations

import numpy as np


def generate_anchors(anchor_generator_cfg, grid_size, point_cloud_range,
                     anchor_ndim: int = 7):
    """Returns (anchors (ny, nx, A, anchor_ndim) float32, num_anchors_per_loc,
    per-anchor-slot class index (A,), matched/unmatched thresholds (A,)).

    grid_size: full voxel grid (nx, ny, nz); each class cfg carries
    'feature_map_stride'.
    """
    rng = np.asarray(point_cloud_range, dtype=np.float64)
    per_class = []
    class_slots = []
    matched = []
    unmatched = []
    fm_shape = None
    for cls_idx, cfg in enumerate(anchor_generator_cfg):
        stride = int(cfg.get("feature_map_stride", 1))
        nx = int(grid_size[0]) // stride
        ny = int(grid_size[1]) // stride
        if fm_shape is None:
            fm_shape = (ny, nx)
        assert fm_shape == (ny, nx), "per-class feature maps must match"

        sizes = np.asarray(cfg["anchor_sizes"], dtype=np.float64)       # (S, 3)
        rotations = np.asarray(cfg["anchor_rotations"], dtype=np.float64)  # (R,)
        heights = np.asarray(cfg["anchor_bottom_heights"], dtype=np.float64)  # (Z,)
        align_center = bool(cfg.get("align_center", False))

        if align_center:
            x_stride = (rng[3] - rng[0]) / nx
            y_stride = (rng[4] - rng[1]) / ny
            x_offset, y_offset = x_stride / 2, y_stride / 2
        else:
            x_stride = (rng[3] - rng[0]) / (nx - 1)
            y_stride = (rng[4] - rng[1]) / (ny - 1)
            x_offset = y_offset = 0.0

        x_shifts = np.arange(rng[0] + x_offset, rng[3] + 1e-5, x_stride)[:nx]
        y_shifts = np.arange(rng[1] + y_offset, rng[4] + 1e-5, y_stride)[:ny]

        s = sizes.shape[0]
        r = rotations.shape[0]
        z = heights.shape[0]
        # (ny, nx, Z, S, R, 7); flatten order per location: z, size, rot —
        # reference order is (size, rot) with z folded via meshgrid third axis.
        xx, yy, zz = np.meshgrid(x_shifts, y_shifts, heights, indexing="ij")
        base = np.stack([xx, yy, zz], axis=-1)  # (nx, ny, Z, 3)
        base = np.transpose(base, (1, 0, 2, 3))  # (ny, nx, Z, 3)
        base = np.broadcast_to(base[:, :, :, None, None, :], (ny, nx, z, s, r, 3))
        size_b = np.broadcast_to(
            sizes[None, None, None, :, None, :], (ny, nx, z, s, r, 3)
        )
        rot_b = np.broadcast_to(
            rotations[None, None, None, None, :, None], (ny, nx, z, s, r, 1)
        )
        anchors = np.concatenate([base, size_b, rot_b], axis=-1)
        anchors = anchors.copy()
        anchors[..., 2] += anchors[..., 5] / 2  # bottom -> center z
        a_per_cls = z * s * r
        per_class.append(anchors.reshape(ny, nx, a_per_cls, 7))
        class_slots.extend([cls_idx] * a_per_cls)
        matched.extend([float(cfg["matched_threshold"])] * a_per_cls)
        unmatched.extend([float(cfg["unmatched_threshold"])] * a_per_cls)

    anchors = np.concatenate(per_class, axis=2)  # (ny, nx, A_total, 7)
    if anchor_ndim > 7:
        pad = np.zeros(anchors.shape[:-1] + (anchor_ndim - 7,), anchors.dtype)
        anchors = np.concatenate([anchors, pad], axis=-1)
    return (
        anchors.astype(np.float32),
        anchors.shape[2],
        np.asarray(class_slots, dtype=np.int32),
        np.asarray(matched, dtype=np.float32),
        np.asarray(unmatched, dtype=np.float32),
    )
