"""PointRCNNHead, the canonical point-cloud ROI refinement — port of
findnpropagate_tpu/models/roi_heads/pointrcnn_head.py (`_MLP1x1` :35,
`_SASingle` :51, `PointRCNNHead` :97, `pointrcnn_rcnn_loss` :229).

Each ROI (grown by POOL_EXTRA_WIDTH) pools its first NUM_SAMPLED_POINTS
inside points (ops/roi_pool.py::roipoint_pool3d) with a prefix of the
detached segmentation score and the normalised depth ahead of the point
features; their xyz go into the ROI's frame (the ROI detached, the
reference's stop-gradients); ROIs that are invalid or empty are zeroed.
The xyz + prefix channels go up through ``xyz_up``, are concatenated
with the point features and merged down (``merge_down``); then a stack
of single-scale set abstractions over each ROI's points, the B*R ROIs as
the batch (FPS and ball query, or with NPOINTS -1 one group of all the
points relative to their mean), and the cls and reg towers with BN over
the valid, non-empty ROIs. Linear layers carry a bias and no BN unless
USE_BN. Names: ``xyz_up/fc{i}``, ``sa{k}/mlp/fc{i}``, ``cls_fc/fc{i}`` +
``cls_fc/bn{i}``, ``cls_out``, ``reg_...``.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.pointnet2 import query_and_group
from ...ops.roi_pool import roipoint_pool3d
from ...utils.geometry import rotate_points_along_z
from ..backbones_3d.pointnet2_backbone import sample_centers
from ..blocks import MaskedBatchNorm
from .roi_head_template import RoIHeadTemplate, two_stage_rcnn_loss

N_PREFIX = 5      # xyz, score, depth


class MLP1x1(nn.Module):
    """Linear ``fc{i}`` (+ masked BN ``bn{i}`` with `use_bn`, then no
    bias) + ReLU layers."""

    def __init__(self, cin, channels, use_bn=False):
        super().__init__()
        self.use_bn = bool(use_bn)
        self.depth = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"fc{i}", nn.Linear(int(cin), int(ch),
                                                bias=not self.use_bn))
            if self.use_bn:
                self.add_module(f"bn{i}", MaskedBatchNorm(int(ch)))
            cin = ch
        self.out_channels = int(cin)

    def forward(self, x, valid):
        for i in range(self.depth):
            x = getattr(self, f"fc{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn{i}")(x, valid, channels_last=True)
            x = torch.relu(x)
        return x


class SASingle(nn.Module):
    """Single-scale set abstraction: FPS centres + ball query + MLP + max,
    or, with npoint <= 0, one group of all the valid points."""

    def __init__(self, cin, npoint, radius, nsample, mlp, use_bn=False):
        super().__init__()
        self.npoint = int(npoint)
        self.radius = float(radius)
        self.nsample = int(nsample)
        self.mlp = MLP1x1(3 + int(cin), mlp, use_bn)

    def forward(self, xyz, mask, feats):
        if self.npoint > 0:
            new_xyz, new_mask = sample_centers(xyz, mask, self.npoint)
            grouped, cnt = query_and_group(new_xyz, new_mask, xyz, mask,
                                           feats, self.radius, self.nsample)
            b, m, s, c = grouped.shape
            h = self.mlp(grouped.reshape(b, m * s, c),
                         new_mask.repeat_interleave(s, dim=1)
                         ).reshape(b, m, s, -1)
            h = torch.where((cnt > 0)[..., None, None], h,
                            torch.zeros_like(h))
            out = h.amax(dim=2)
            return new_xyz, new_mask, torch.where(
                new_mask[..., None], out, torch.zeros_like(out))
        # group all: one output point per set, xyz relative to the mean
        mf = mask[..., None].to(xyz.dtype)
        anyv = mask.any(dim=1)
        mean = (xyz * mf).sum(1, keepdim=True) / torch.clamp(
            mf.sum(1, keepdim=True), min=1.0)
        rel = xyz - torch.where(anyv[:, None, None], mean,
                                torch.zeros_like(mean))
        h = self.mlp(torch.cat([rel, feats], dim=-1), mask)
        h = torch.where(mask[..., None], h, torch.full_like(h, -torch.inf))
        out = h.amax(dim=1, keepdim=True)
        out = torch.where(anyv[:, None, None], out, torch.zeros_like(out))
        return xyz.new_zeros(xyz.shape[0], 1, 3), anyv[:, None], out


class PointRCNNHead(RoIHeadTemplate):
    def __init__(self, model_cfg, point_cloud_range, voxel_size,
                 num_class=1, input_channels=0):
        super().__init__(model_cfg, point_cloud_range, voxel_size, num_class)
        use_bn = bool(model_cfg.get("USE_BN", False))
        up = [int(c) for c in model_cfg["XYZ_UP_LAYER"]]
        self.xyz_up = MLP1x1(N_PREFIX, up, use_bn)
        self.merge_down = MLP1x1(up[-1] + int(input_channels), (up[-1],),
                                 use_bn)
        sa = model_cfg["SA_CONFIG"]
        cin = up[-1]
        self.n_sa = len(sa["NPOINTS"])
        for k in range(self.n_sa):
            mod = SASingle(cin, sa["NPOINTS"][k], sa["RADIUS"][k],
                           sa["NSAMPLE"][k], sa["MLPS"][k], use_bn)
            self.add_module(f"sa{k}", mod)
            cin = mod.mlp.out_channels
        self.cls_fc = MLP1x1(cin, model_cfg["CLS_FC"], use_bn=True)
        self.cls_out = nn.Linear(self.cls_fc.out_channels, 1)
        self.reg_fc = MLP1x1(cin, model_cfg["REG_FC"], use_bn=True)
        self.reg_out = nn.Linear(self.reg_fc.out_channels, 7)

    def forward(self, batch, generator=None):
        rois, _, roi_labels, roi_valid, targets = self.proposals(batch,
                                                                 generator)
        pool = self.model_cfg["ROI_POINT_POOL"]
        ew = [float(e) for e in pool.get("POOL_EXTRA_WIDTH", (0, 0, 0))]
        pts = batch["point_coords"].detach()
        scores = batch["point_cls_scores"].detach()
        depths = torch.linalg.vector_norm(pts, dim=-1) \
            / float(pool["DEPTH_NORMALIZER"]) - 0.5
        feats_all = torch.cat([scores[..., None], depths[..., None],
                               batch["point_features"]], dim=-1)
        rois_sg = rois.detach()
        pool_rois = rois_sg
        if any(ew):
            pool_rois = torch.cat([rois_sg[..., :3], rois_sg[..., 3:6]
                                   + torch.as_tensor(ew, dtype=rois.dtype,
                                                     device=rois.device),
                                   rois_sg[..., 6:]], dim=-1)
        pooled, empty = roipoint_pool3d(pool_rois, pts, feats_all,
                                        batch["point_valid"],
                                        int(pool["NUM_SAMPLED_POINTS"]))
        b, r, s, _ = pooled.shape
        local = rotate_points_along_z(
            (pooled[..., 0:3] - rois_sg[..., None, 0:3]).reshape(b * r, s, 3),
            -rois_sg[..., 6].reshape(b * r))
        pooled = torch.cat([local.reshape(b, r, s, 3), pooled[..., 3:]],
                           dim=-1)
        ok = ~empty & roi_valid
        pooled = torch.where(ok[..., None, None], pooled,
                             torch.zeros_like(pooled))
        flat_valid = ok.reshape(b * r, 1).expand(b * r, s)
        xyz_feat = self.xyz_up(pooled[..., :N_PREFIX].reshape(b * r, s, -1),
                               flat_valid)
        merged = self.merge_down(torch.cat(
            [xyz_feat, pooled[..., N_PREFIX:].reshape(b * r, s, -1)], dim=-1),
            flat_valid)
        xyz, mask, feats = pooled[..., :3].reshape(b * r, s, 3), flat_valid, \
            merged
        for k in range(self.n_sa):
            xyz, mask, feats = getattr(self, f"sa{k}")(xyz, mask, feats)
        shared = feats.reshape(b, r, -1)
        rcnn_cls = self.cls_out(self.cls_fc(shared, ok))
        rcnn_reg = self.reg_out(self.reg_fc(shared, ok))
        return self.refined(batch, rois, roi_labels, roi_valid, rcnn_cls,
                            rcnn_reg, targets)


pointrcnn_rcnn_loss = two_stage_rcnn_loss
