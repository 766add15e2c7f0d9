"""PointHeadSimple — keypoint foreground segmentation, PV-RCNN's auxiliary
head — port of findnpropagate_tpu/models/dense_heads/point_head_simple.py
(`PointHeadSimple` :23, `point_head_loss` :45).

A Linear (no bias) + masked BN + ReLU stack (``cls_fc{i}`` / ``cls_bn{i}``)
and a Linear ``cls_out`` over the keypoint features (those before the
VSA's fusion unless ``USE_POINT_FEATURES_BEFORE_FUSION: False``); the
sigmoid scores weight the keypoint features for the ROI head
(``point_cls_scores``). The loss: sigmoid focal loss against "inside a
ground truth box grown by GT_EXTRA_WIDTH", normalised by the positives of
the batch.
"""

from __future__ import annotations

import torch
from torch import nn

from ...utils import losses as L
from ...utils.geometry import points_in_boxes_mask
from ..blocks import MaskedBatchNorm


class PointHeadSimple(nn.Module):
    def __init__(self, model_cfg, input_channels):
        super().__init__()
        self.model_cfg = model_cfg
        cin = int(input_channels)
        self.num_fc = len(model_cfg["CLS_FC"])
        for i, ch in enumerate(model_cfg["CLS_FC"]):
            self.add_module(f"cls_fc{i}", nn.Linear(cin, int(ch), bias=False))
            self.add_module(f"cls_bn{i}", MaskedBatchNorm(int(ch)))
            cin = int(ch)
        self.cls_out = nn.Linear(cin, 1)

    def forward(self, batch):
        before = bool(self.model_cfg.get("USE_POINT_FEATURES_BEFORE_FUSION",
                                         True))
        x = batch["point_features_before_fusion" if before
                  else "point_features"]
        valid = batch["point_valid"]
        for i in range(self.num_fc):
            x = torch.relu(getattr(self, f"cls_bn{i}")(
                getattr(self, f"cls_fc{i}")(x), valid, channels_last=True))
        logits = self.cls_out(x)                          # (B, K, 1)
        batch["point_cls_logits"] = logits
        batch["point_cls_scores"] = torch.sigmoid(logits)[..., 0]
        return batch


def point_head_loss(out_batch, loss_cfg, extra_width=(0.2, 0.2, 0.2)):
    """Sigmoid focal segmentation loss of the keypoints: (loss, tb)."""
    logits = out_batch["point_cls_logits"][..., 0]        # (B, K)
    valid = out_batch["point_valid"]
    gt = out_batch["gt_boxes"]                            # (B, G, 8)
    ew = torch.as_tensor(extra_width, dtype=gt.dtype, device=gt.device)
    boxes = torch.cat([gt[..., :3], gt[..., 3:6] + ew, gt[..., 6:7]], dim=-1)
    with torch.no_grad():
        inside = points_in_boxes_mask(out_batch["point_coords"], boxes) \
            & (gt[..., 7] > 0)[..., None]                 # (B, G, K)
    targets = inside.any(dim=1).to(logits.dtype)
    w = valid.to(logits.dtype)
    w = w / torch.clamp((targets * w).sum(), min=1.0)
    per = L.sigmoid_focal_loss(logits.reshape(-1, 1), targets.reshape(-1, 1),
                               w.reshape(-1))
    loss = per.sum() * float(loss_cfg["LOSS_WEIGHTS"].get(
        "point_cls_weight", 1.0))
    return loss, {"point_loss_cls": loss}
