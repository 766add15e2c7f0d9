"""Greedy Box Seeker + Oracle, KITTI variant (FrustumProposerOGKITTI) —
port of findnpropagate_tpu/openvocab/frustum_proposer_kitti.py:28-331.

One front camera given by KITTI's P2, R0 and Tr_velo2cam (V2C) matrices,
a 7-class anchor table, no image-bounds mask on the points, and the KITTI
oracle score ``dns_w + density / sum + iou_w * iou + dst_w * dist_rank``
(density normalised by its sum over the valid proposals, not its max).
The program is the nuScenes seeker's (frustum_proposer.py): points sorted
by depth once, quantiles from the running count of each detection's
on-box mask, the point-in-proposal test over the compacted on-box points,
every detection at once.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..ops.nms import nms_normal_bev
from .camera import get_cam_frustum, inv3, matmul3, matvec3, nms_2d, norm3
from .frustum_proposer import (
    NEG_SCORE,
    base_boxes,
    box_quantiles,
    constants,
    dist_rank,
    front_centre,
    in_box_stats,
    on_box_mask,
    projected_iou,
    proposals,
    select,
    sort_by_depth,
    to_device,
)

# KITTI per-class size anchors (frustum_proposals_v1_kitti.py:157-165):
# car, tram (construction-veh anchor), truck, van (truck), person_sitting
# (pedestrian), cyclist, pedestrian.
KITTI_ANCHORS = np.array(
    [
        [3.9, 1.6, 1.56],
        [6.37, 2.85, 3.19],
        [6.93, 2.51, 2.84],
        [6.93, 2.51, 2.84],
        [0.8, 0.6, 1.73],
        [1.76, 0.6, 1.73],
        [0.8, 0.6, 1.73],
    ],
    dtype=np.float32,
)

# matching class-name order for the anchor table
KITTI_SEEKER_CLASSES = ('Car', 'Tram', 'Truck', 'Van', 'Person_sitting',
                        'Cyclist', 'Pedestrian')


class KittiSeekerOutput(NamedTuple):
    boxes: torch.Tensor    # (D*topk, 7)
    scores: torch.Tensor   # (D*topk,) 2D-detection score per kept proposal
    oracle: torch.Tensor   # (D*topk,)
    labels: torch.Tensor   # (D*topk,) int32 1-indexed
    valid: torch.Tensor    # (D*topk,) bool


def _rect_transform(R0, V2C):
    """rect = M @ lidar + t with M = R0 @ V2C[:, :3], t = R0 @ V2C[:, 3]."""
    return matmul3(R0, V2C[:, :3]), matvec3(R0, V2C[:, 3])


def lidar_to_img_kitti(pts, P2, R0, V2C):
    """(..., 3) LiDAR -> ((..., 2) image uv, (...,) rect depth), KITTI's
    Calibration.lidar_to_img: uv = (P2 hom(rect))[:2] / rect_z, depth =
    (P2 hom(rect))_z - P2[2, 3]."""
    m, t = _rect_transform(R0, V2C)
    rect = matvec3(m, pts) + t
    proj = matvec3(P2, rect) + P2[:, 3]
    return proj[..., :2] / rect[..., 2:3], proj[..., 2] - P2[2, 3]


def img_to_lidar_kitti(uvd, P2, R0, V2C):
    """(..., 3) [u, v, rect depth] -> (..., 3) LiDAR xyz (img_to_rect, then
    rect_to_lidar)."""
    cu, cv = P2[0, 2], P2[1, 2]
    fu, fv = P2[0, 0], P2[1, 1]
    tx = P2[0, 3] / (-fu)
    ty = P2[1, 3] / (-fv)
    d = uvd[..., 2]
    x = (uvd[..., 0] - cu) * d / fu + tx
    y = (uvd[..., 1] - cv) * d / fv + ty
    m, t = _rect_transform(R0, V2C)
    return matvec3(inv3(m), torch.stack([x, y, d], dim=-1) - t)


@dataclass(frozen=True)
class FrustumProposerOGKITTI:
    """Config container and KITTI seeker. Defaults = the reference's
    constructor defaults (frustum_proposals_v1_kitti.py:42-44)."""

    class_names: tuple = KITTI_SEEKER_CLASSES
    anchors: tuple = tuple(map(tuple, KITTI_ANCHORS.tolist()))
    lq: float = 0.336
    uq: float = 0.356
    cq: float = 0.46
    iou_w: float = 0.95
    dst_w: float = 0.226
    dns_w: float = 0.05
    min_cam_iou: float = 0.3
    size_min: float = 0.957
    size_max: float = 1.2
    ry_min: float = 0.0
    ry_max: float = float(np.pi)
    num_mags: int = 6
    num_sizes: int = 4
    num_rotations: int = 10
    max_dist: float = 70.0
    topk: int = 1
    nms_2d_thresh: float = 0.7
    nms_normal: float = 0.7
    score_thr: float = 0.1
    clamp_bottom: float = 0.0
    search_depth: float | None = None
    det_chunk: int = 8  # see FrustumProposerOG.det_chunk
    frustum_min: float = 2.0
    # clamp extents for back-projected corners (the reference keeps the
    # nuScenes [900, 1600] here)
    image_size: tuple = (900, 1600)
    point_cloud_range: tuple = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)

    def __post_init__(self):
        object.__setattr__(self, "_consts", {})

    @classmethod
    def from_config(cls, model_cfg, class_names=None):
        p = dict(model_cfg.get("PARAMS", {}))
        kw = {}
        remap = {"nms_2d": "nms_2d_thresh"}
        for k, v in p.items():
            key = remap.get(k, k)
            if key in cls.__dataclass_fields__:
                kw[key] = v
        if class_names is not None:
            kw["class_names"] = tuple(class_names)
        return cls(**kw)

    def base_boxes(self):
        """(num_class, R*S, 7) zero-centred proposal templates."""
        return base_boxes(self.anchors, self.size_min, self.size_max,
                          self.ry_min, self.ry_max, self.num_sizes,
                          self.num_rotations)

    def propose(self, points, points_mask, det_boxes, det_labels, det_scores,
                det_mask, P2, R0, V2C, device=None):
        """Single KITTI frame.

        points (P, >=3); det_* (D, ...) padded 2D detections (boxes xyxy,
        labels 1-indexed into the anchor table); P2 (3, 4), R0 (3, 3), V2C
        (3, 4); numpy arrays or tensors. Runs on `device` (default CUDA).
        Returns a KittiSeekerOutput with D * topk slots."""
        dev = resolve_device(device)
        f32 = torch.float32
        pts = to_device(points, dev, f32)[:, :3]
        points_mask = to_device(points_mask, dev, torch.bool)
        det_boxes = to_device(det_boxes, dev, f32)
        det_labels = to_device(det_labels, dev, torch.int32)
        det_scores = to_device(det_scores, dev, f32)
        det_mask = to_device(det_mask, dev, torch.bool)
        P2, R0, V2C = (to_device(a, dev, f32) for a in (P2, R0, V2C))
        consts = constants(self, dev)
        cls = torch.clamp(det_labels.long() - 1, 0,
                          consts["base"].shape[0] - 1)
        cam = torch.zeros_like(cls)

        uv_all, depth_all = lidar_to_img_kitti(pts, P2, R0, V2C)

        # per-class 2D NMS over the detections, then the score gate
        m = det_mask & (det_scores >= self.score_thr)
        keep = nms_2d(det_boxes, det_scores, det_labels, self.nms_2d_thresh,
                      valid=det_mask) & m

        key = torch.where(points_mask, depth_all,
                          torch.full_like(depth_all, torch.finfo(f32).max))
        cols = torch.stack([uv_all[:, 0], uv_all[:, 1], depth_all,
                            pts[:, 0], pts[:, 1], pts[:, 2],
                            points_mask.to(f32)])[:, None]     # (7, 1, P)
        cols, _ = sort_by_depth(key[None], cols)
        on_box = on_box_mask(cols[0][cam], cols[1][cam], cols[6][cam] > 0,
                             det_boxes)
        cnt = torch.cumsum(on_box, dim=1, dtype=torch.int32)
        n_box_pts = cnt[:, -1]
        q = box_quantiles(cnt, cols[2], cam, consts["qs"])
        q_lo, q_hi, cz = q.unbind(-1)
        if self.search_depth is not None:
            q_hi = q_lo + self.search_depth
        fmax = torch.clamp(q_hi, max=self.max_dist)
        fmin = torch.clamp(q_lo, min=self.frustum_min)

        x1, y1, x2, y2 = det_boxes.unbind(-1)
        centre_xyz = img_to_lidar_kitti(
            torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, cz], -1), P2, R0, V2C)
        frust_box = img_to_lidar_kitti(
            get_cam_frustum(torch.stack([x1, y1, fmin, x2, y2, fmax], -1),
                            consts["template"]), P2, R0, V2C)  # (D, 8, 3)
        if self.clamp_bottom > 0:
            # clamp the frustum to the on-box points' extent
            dims = []
            for d in range(3):
                p = cols[3 + d][cam]
                big = torch.full_like(p, 1e9)
                pmin = torch.where(on_box, p, big).amin(-1)
                pmax = torch.where(on_box, p, -big).amax(-1)
                f = frust_box[..., d]
                f1 = torch.maximum(pmin, f.amin(-1))
                f2 = torch.minimum(pmax, f.amax(-1))
                dims.append(torch.clamp(f, f1[:, None], f2[:, None]))
            frust_box = torch.stack(dims, dim=-1)
        fbev = (frust_box[:, 0::2] + frust_box[:, 1::2]) / 2
        close = (fbev[:, 0] + fbev[:, 1]) / 2
        center_vec = (fbev[:, 2] + fbev[:, 3]) / 2 - close
        if self.search_depth is not None:
            center_vec = center_vec / (norm3(center_vec)[:, None] + 1e-9) \
                * self.search_depth

        boxes3d, corners, cos_neg, sin_neg = proposals(consts, cls, close,
                                                       center_vec)
        d_n, n_prop = boxes3d.shape[:2]
        boxes3d, corners, wfc = front_centre(boxes3d, corners)
        # distance filter on the pre-shift front centres
        prop_valid = norm3(wfc) < self.max_dist
        uv_c, _ = lidar_to_img_kitti(corners, P2, R0, V2C)
        ious = projected_iou(uv_c, det_boxes, self.image_size)
        dists_ranked = dist_rank(norm3(wfc - centre_xyz[:, None]), prop_valid)
        prop_valid = prop_valid & (ious > self.min_cam_iou)

        del on_box
        counts = in_box_stats(cnt, cols[3:6], cam, boxes3d, cos_neg, sin_neg,
                              self.det_chunk)["counts"]
        total = torch.where(prop_valid, counts,
                            torch.zeros_like(counts)).sum(-1)
        soft_density = counts / (total[:, None] + 1e-8)
        oracle = self.dns_w + soft_density + self.iou_w * ious \
            + self.dst_w * dists_ranked
        oracle = torch.where(prop_valid, oracle,
                             torch.full_like(oracle, NEG_SCORE))

        idx, _ = nms_normal_bev(boxes3d, oracle, self.nms_normal,
                                pre_maxsize=n_prop, post_maxsize=self.topk,
                                valid_mask=prop_valid)
        boxes_o, oracle_o, valid_o = select(
            boxes3d, oracle, idx, (keep & (n_box_pts > 0))[:, None])
        k = self.topk
        return KittiSeekerOutput(
            boxes=boxes_o.reshape(d_n * k, 7),
            scores=det_scores[:, None].expand(d_n, k).reshape(-1),
            oracle=oracle_o.reshape(d_n * k),
            labels=det_labels[:, None].expand(d_n, k).reshape(-1),
            valid=valid_o.reshape(d_n * k))
