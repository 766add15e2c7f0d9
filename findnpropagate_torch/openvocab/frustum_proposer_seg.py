"""FrustumProposerSEG — the segmentation-filtered Greedy Box Seeker; port
of findnpropagate_tpu/openvocab/frustum_proposer_seg.py:42-143.

The OG seeker (frustum_proposer.py) with one more stage: each detection's
in-frustum points are filtered by a Frustum-PointNets instance
segmentation network before the depth quantiles and density counts.
Frustums with more than `seg_pts_thr` points have their first
`max_seg_points` on-box points (in point order) rotated so that their
centroid lies on +x, run through PointNetInstanceSeg (eval: BatchNorm from
its running statistics, no dropout) with the 6-way hierarchy one-hot of
the label, and only points predicted foreground with confidence above
`seg_thr` survive; smaller frustums pass unfiltered. All detections run
as one batch through the network, and the verdicts scatter back into the
(D, P) mask that FrustumProposerOG.propose takes as `det_point_mask`.

The reference's pretrained weights are not shipped: give `seg_params`, a
state dict of the port's PointNetInstanceSeg (utils/weights.py carries a
flax tree across), or leave it None to disable the filter (the proposer
then equals OG).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..models.frustum_pointnets import PointNetInstanceSeg
from .camera import project_to_camera
from .frustum_proposer import FrustumProposerOG, on_box_mask, to_device

# det label (0-indexed) -> hierarchy class
LABEL_TO_HIERARCHY = (0, 1, 1, 2, 2, 3, 4, 4, 5, 5)


class FrustumProposerSEG:
    """Wraps FrustumProposerOG with the PointNet foreground filter."""

    def __init__(self, class_names, seg_params=None, seg_thr: float = 0.5,
                 seg_pts_thr: int = 50, max_seg_points: int = 512,
                 n_seg_classes: int = 6, **og_kwargs):
        self.og = FrustumProposerOG(class_names=tuple(class_names),
                                    **og_kwargs)
        self.seg_net = PointNetInstanceSeg(n_classes=n_seg_classes).eval()
        self.seg_params = seg_params
        if seg_params is not None:
            self.seg_net.load_state_dict(seg_params)
        self.seg_thr = float(seg_thr)
        self.seg_pts_thr = int(seg_pts_thr)
        self.max_seg_points = int(max_seg_points)
        self.n_seg_classes = int(n_seg_classes)

    @classmethod
    def from_config(cls, model_cfg, class_names, seg_params=None):
        p = dict(model_cfg.get("PARAMS", {}))
        seg_kw = {k: p.pop(k) for k in
                  ("seg_thr", "seg_pts_thr", "max_seg_points") if k in p}
        og = FrustumProposerOG.from_config(model_cfg, class_names)
        kw = {f: getattr(og, f) for f in og.__dataclass_fields__
              if f != "class_names"}
        return cls(class_names, seg_params=seg_params, **seg_kw, **kw)

    @torch.no_grad()
    def seg_point_masks(self, points, points_mask, det_boxes, det_labels,
                        det_cams, det_mask, lidar2image,
                        lidar_aug_matrix=None, device=None):
        """(D, P) bool foreground mask per detection, on `device` (default
        CUDA)."""
        dev = resolve_device(device)
        f32 = torch.float32
        pts = to_device(points, dev, f32)[:, :3]
        points_mask = to_device(points_mask, dev, torch.bool)
        det_boxes = to_device(det_boxes, dev, f32)
        det_labels = to_device(det_labels, dev, torch.long)
        det_mask = to_device(det_mask, dev, torch.bool)
        l2i = to_device(lidar2image, dev, f32)
        lam = None if lidar_aug_matrix is None else to_device(
            lidar_aug_matrix, dev, f32)
        cam = torch.clamp(to_device(det_cams, dev, torch.long), 0,
                          l2i.shape[0] - 1)
        p = pts.shape[0]
        k = min(self.max_seg_points, p)
        coords, on_img = project_to_camera(pts, l2i, lam, self.og.image_size)
        on_img = on_img & points_mask[None, :]
        on_box = on_box_mask(coords[..., 0][cam], coords[..., 1][cam],
                             on_img[cam], det_boxes)           # (D, P)
        n = on_box.sum(-1)
        # the first k on-box points in point order, then the first others
        # (the reference's top_k over on_box * 2P - index)
        _, order = torch.sort((~on_box).to(torch.uint8), dim=-1, stable=True)
        idx = order[:, :k]
        sel_valid = torch.gather(on_box, 1, idx)
        sel = pts[idx]                                         # (D, k, 3)
        # FrustumRotation: the centroid onto +x
        m = sel_valid[..., None].to(f32)
        ctr = (sel * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
        rot = torch.atan2(ctr[:, 1], ctr[:, 0])
        c = torch.cos(-rot)[:, None]
        s = torch.sin(-rot)[:, None]
        rsel = torch.stack([sel[..., 0] * c - sel[..., 1] * s,
                            sel[..., 0] * s + sel[..., 1] * c,
                            sel[..., 2]], dim=-1)
        lab2h = to_device(np.asarray(LABEL_TO_HIERARCHY), dev, torch.long)
        one_hot = torch.nn.functional.one_hot(
            lab2h[torch.clamp(det_labels - 1, 0, len(LABEL_TO_HIERARCHY) - 1)],
            self.n_seg_classes).to(f32)
        net = self.seg_net.to(dev)
        prob = torch.sigmoid(net(rsel, one_hot, sel_valid))    # (D, k, 2)
        fg = (prob[..., 1] >= prob[..., 0]) & (prob[..., 1] > self.seg_thr) \
            & sel_valid
        mask = torch.zeros_like(on_box).scatter(1, idx, fg)
        use = det_mask & (n > self.seg_pts_thr)
        return torch.where(use[:, None], mask, torch.ones_like(mask))

    def propose(self, points, points_mask, det_boxes, det_labels,
                det_scores, det_cams, det_mask, lidar2image, camera2lidar,
                intrinsics, lidar_aug_matrix=None, device=None):
        det_point_mask = None
        if self.seg_params is not None:
            det_point_mask = self.seg_point_masks(
                points, points_mask, det_boxes, det_labels, det_cams,
                det_mask, lidar2image, lidar_aug_matrix, device=device)
        return self.og.propose(
            points, points_mask, det_boxes, det_labels, det_scores,
            det_cams, det_mask, lidar2image, camera2lidar, intrinsics,
            lidar_aug_matrix, det_point_mask=det_point_mask, device=device)
