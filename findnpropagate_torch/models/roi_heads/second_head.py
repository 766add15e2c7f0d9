"""SECONDHead — the IoU-scoring second stage of SECOND-IoU over rotated
BEV grid pooling — port of findnpropagate_tpu/models/roi_heads/
second_head.py (`rotated_bev_grid_sample` :27, `SECONDHead` :69,
`rcnn_iou_loss` :157).

Class-agnostic proposals (and ROI sampling in training), a GRID_SIZE^2
rotated grid per ROI sampled bilinearly from the detached
``spatial_features_2d`` (torch's affine_grid + grid_sample with
align_corners=True, zero padding), shared FCs, IoU FCs and one IoU logit
per ROI. At eval the logits score the ROIs themselves (stage-1 boxes).
"""

from __future__ import annotations

import torch
from torch import nn

from ...parallel.mesh import all_sum
from ..pfe.voxel_set_abstraction import bev_bilinear
from .roi_head_template import RoIHeadTemplate


def rotated_bev_grid_sample(feat, rois, grid_size, pc_range, bev_stride,
                            voxel_size):
    """feat (B, C, H, W) with H = ny, W = nx; rois (B, M, 7) -> (B, M,
    grid_size * grid_size * C), the grid's rows along the ROI's y."""
    b, c = feat.shape[:2]
    g = int(grid_size)
    sx = voxel_size[0] * bev_stride
    sy = voxel_size[1] * bev_stride
    cx = ((rois[..., 0] - pc_range[0]) / sx)[..., None, None]
    cy = ((rois[..., 1] - pc_range[1]) / sy)[..., None, None]
    dx = (rois[..., 3] / sx / 2)[..., None, None]
    dy = (rois[..., 4] / sy / 2)[..., None, None]
    cosa = torch.cos(rois[..., 6])[..., None, None]
    sina = torch.sin(rois[..., 6])[..., None, None]
    lin = torch.linspace(-1.0, 1.0, g, device=feat.device)
    xo = lin[None, :].expand(g, g)
    yo = lin[:, None].expand(g, g)
    px = cx + dx * (cosa * xo - sina * yo)                 # (B, M, g, g)
    py = cy + dy * (sina * xo + cosa * yo)
    out = bev_bilinear(feat, px.reshape(b, -1), py.reshape(b, -1))
    return out.reshape(b, rois.shape[1], g * g * c)


class SECONDHead(RoIHeadTemplate):
    def __init__(self, model_cfg, point_cloud_range, voxel_size,
                 num_class=1, input_channels=0):
        super().__init__(model_cfg, point_cloud_range, voxel_size, num_class)
        g = int(model_cfg["ROI_GRID_POOL"]["GRID_SIZE"])
        cin = self.add_stack("shared", g * g * int(input_channels),
                             model_cfg["SHARED_FC"])
        cin = self.add_stack("iou", cin, model_cfg["IOU_FC"])
        self.iou_out = nn.Linear(cin, 1)

    def forward(self, batch, generator=None):
        cfg = self.model_cfg
        rois, roi_scores, roi_labels, roi_valid, targets = self.proposals(
            batch, generator)
        pool = cfg["ROI_GRID_POOL"]
        pooled = rotated_bev_grid_sample(
            batch["spatial_features_2d"].detach(), rois.detach(),
            int(pool["GRID_SIZE"]), self.point_cloud_range,
            int(pool["DOWNSAMPLE_RATIO"]), self.voxel_size)
        n_shared = len(cfg["SHARED_FC"])
        x = self.run_stack("shared", pooled, roi_valid,
                           range(n_shared - 1), generator)
        rcnn_iou = self.iou_out(self.run_stack("iou", x, roi_valid))
        batch.update(rois=rois, roi_labels=roi_labels, roi_valid=roi_valid,
                     rcnn_iou=rcnn_iou,
                     roi_scores=targets["roi_scores"] if self.training
                     else roi_scores)
        if self.training:
            batch["rcnn_targets"] = {k: targets[k] for k in (
                "rcnn_cls_labels", "reg_valid_mask", "gt_iou_of_rois")}
        else:
            # stage-2 scores on the stage-1 boxes
            batch.update(batch_cls_preds=rcnn_iou, batch_box_preds=rois,
                         batch_roi_labels=roi_labels,
                         cls_preds_normalized=False,
                         stage1_scores=roi_scores)
        return batch


def rcnn_iou_loss(out_batch, loss_cfg):
    """The IoU loss (BinaryCrossEntropy, L2 or smooth L1) against the
    IoU-guided labels of the labelled ROIs."""
    rcnn_iou = out_batch["rcnn_iou"].reshape(-1)
    labels = out_batch["rcnn_targets"]["rcnn_cls_labels"].reshape(-1)
    valid = (labels >= 0).to(rcnn_iou.dtype)
    kind = str(loss_cfg.get("IOU_LOSS", "BinaryCrossEntropy"))
    if kind == "BinaryCrossEntropy":
        p = torch.clamp(torch.sigmoid(rcnn_iou), 1e-7, 1 - 1e-7)
        per = -(labels * torch.log(p) + (1 - labels) * torch.log(1 - p))
    elif kind == "L2":
        per = (rcnn_iou - labels) ** 2
    else:   # smoothL1
        d = (rcnn_iou - labels).abs()
        per = torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    loss = (per * valid).sum() / torch.clamp(all_sum(valid.sum()), min=1.0) \
        * float(loss_cfg["LOSS_WEIGHTS"].get("rcnn_iou_weight", 1.0))
    return loss, {"rcnn_loss_iou": loss}
