"""PartA2FCHead, Part-A2's part-aggregation ROI head — port of
findnpropagate_tpu/models/roi_heads/parta2_head.py (`_MaskedConv3dStack`
:34, `PartA2FCHead` :56, `parta2_rcnn_loss` :174).

Each ROI pools, over POOL_SIZE^3 cells of its own frame
(ops/roi_pool.py::roiaware_pool3d), the part features — the predicted
part locations, zeroed where the detached segmentation score is below
SEG_MASK_SCORE_THRESH, and that score — by average, and the U-Net's point
features by max. Two stacks of 3x3x3 convs (``conv_part``, ``conv_rpn``)
masked to the cells holding part features, with BN over those cells of
the valid ROIs, stand in for the reference's submanifold convs; their
outputs (U-Net branch first) concatenated, max-pooled by 2, flattened in
the reference's (x, y, z, channel) order and through the shared, cls and
reg towers (no dropout, as in the reference's towers). The pooled grids
are channels-first for F.conv3d; the flax kernels (kx, ky, kz, Cin, Cout)
map onto them in utils/weights.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.roi_pool import roiaware_pool3d
from ..blocks import MaskedBatchNorm
from .roi_head_template import RoIHeadTemplate, two_stage_rcnn_loss


class MaskedConv3dStack(nn.Module):
    """3x3x3 convs (no bias) ``conv{i}``, each output masked to the
    occupied cells, BN ``conv{i}_bn`` over the occupied cells of the valid
    ROIs, ReLU, masked again."""

    def __init__(self, cin, channels):
        super().__init__()
        self.depth = len(channels)
        for i, ch in enumerate(channels):
            self.add_module(f"conv{i}", nn.Conv3d(int(cin), int(ch), 3,
                                                  padding=1, bias=False))
            self.add_module(f"conv{i}_bn", MaskedBatchNorm(int(ch)))
            cin = ch

    def forward(self, x, occ, valid_roi):
        """x (N, C, ox, oy, oz); occ (N, ox, oy, oz) bool; valid_roi (N,)."""
        occ_c = occ[:, None]
        m = occ & valid_roi[:, None, None, None]
        for i in range(self.depth):
            x = getattr(self, f"conv{i}")(x)
            x = torch.where(occ_c, x, torch.zeros_like(x))
            x = torch.relu(getattr(self, f"conv{i}_bn")(x, m))
            x = torch.where(occ_c, x, torch.zeros_like(x))
        return x


class PartA2FCHead(RoIHeadTemplate):
    def __init__(self, model_cfg, point_cloud_range, voxel_size,
                 num_class=1, input_channels=0):
        super().__init__(model_cfg, point_cloud_range, voxel_size, num_class)
        pool = model_cfg["ROI_AWARE_POOL"]
        self.pool_size = int(pool["POOL_SIZE"])
        c0 = int(pool["NUM_FEATURES"]) // 2
        self.conv_part = MaskedConv3dStack(4, (64, c0))
        self.conv_rpn = MaskedConv3dStack(int(input_channels), (64, c0))
        cin = (self.pool_size // 2) ** 3 * 2 * c0
        cin = self.add_stack("shared", cin, model_cfg["SHARED_FC"])
        self.cls_out = nn.Linear(
            self.add_stack("cls", cin, model_cfg["CLS_FC"]), 1)
        self.reg_out = nn.Linear(
            self.add_stack("reg", cin, model_cfg["REG_FC"]), 7)

    def forward(self, batch, generator=None):
        rois, _, roi_labels, roi_valid, targets = self.proposals(batch,
                                                                 generator)
        ps = self.pool_size
        thresh = float(self.model_cfg.get("SEG_MASK_SCORE_THRESH", 0.3))
        pts = batch["point_coords"].detach()
        pvalid = batch["point_valid"]
        seg = batch["point_cls_scores"].detach()
        part = batch["point_part_offset"]
        part = torch.where((seg >= thresh)[..., None], part,
                           torch.zeros_like(part))
        part_feats = torch.cat([part, seg[..., None]], dim=-1)
        rois_sg = rois.detach()
        size = (ps, ps, ps)
        pooled_part = roiaware_pool3d(rois_sg, pts, part_feats, pvalid, size,
                                      "avg")
        pooled_rpn = roiaware_pool3d(rois_sg, pts, batch["point_features"],
                                     pvalid, size, "max")
        b, r = roi_valid.shape
        part_g = pooled_part.reshape(b * r, ps, ps, ps, -1)
        rpn_g = pooled_rpn.reshape(b * r, ps, ps, ps, -1)
        # occupancy: the cells with any pooled part mass
        occ = part_g.abs().sum(-1) > 0
        rv = roi_valid.reshape(-1)
        part_x = self.conv_part(part_g.permute(0, 4, 1, 2, 3), occ, rv)
        rpn_x = self.conv_rpn(rpn_g.permute(0, 4, 1, 2, 3), occ, rv)
        merged = F.max_pool3d(torch.cat([rpn_x, part_x], dim=1), 2, 2)
        flat = merged.permute(0, 2, 3, 4, 1).reshape(b, r, -1)
        x = self.run_stack("shared", flat, roi_valid)
        rcnn_cls = self.cls_out(self.run_stack("cls", x, roi_valid))
        rcnn_reg = self.reg_out(self.run_stack("reg", x, roi_valid))
        return self.refined(batch, rois, roi_labels, roi_valid, rcnn_cls,
                            rcnn_reg, targets)


parta2_rcnn_loss = two_stage_rcnn_loss
