"""PointIntraPartOffsetHead, Part-A2's first-stage point head — port of
findnpropagate_tpu/models/dense_heads/point_intra_part_head.py
(`PointIntraPartOffsetHead` :29, `assign_part_targets` :69,
`point_part_head_loss` :101).

Per-point stacks over the U-Net's point features (``cls_...`` with
num_class channels, ``part_...`` with 3): the segmentation scores
(``point_cls_scores``) and the intra-object part location in [0, 1]^3
(``point_part_offset``, sigmoid). With REG_FC (PartA2_free) a box branch
too, whose PointResidualCoder boxes are the ROI head's proposals. Targets:
the containing box's class (ignore ring from GT_EXTRA_WIDTH) and the
point's position in its box's frame over the box's size, plus 0.5. The
loss: sigmoid focal classification normalised by the positives, and the
part locations' binary cross-entropy over the foreground points; the box
branch has no loss term, as in the reference.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...utils import losses as L
from ...utils.geometry import rotate_points_along_z
from .point_head_box import FCStacks, _take, decode_proposals, make_coder
from .point_head_box import point_fg_labels


class PointIntraPartOffsetHead(FCStacks):
    def __init__(self, model_cfg, input_channels, num_class=3):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = int(num_class)
        self.add_fc_stack("cls", input_channels, model_cfg.get("CLS_FC", []),
                          self.num_class)
        self.add_fc_stack("part", input_channels,
                          model_cfg.get("PART_FC", []), 3)
        self.coder = None
        if "REG_FC" in model_cfg:
            self.coder = make_coder(model_cfg)
            self.add_fc_stack("reg", input_channels, model_cfg["REG_FC"],
                              self.coder.code_size)

    def forward(self, batch):
        feats = batch["point_features"]
        valid = batch["point_valid"]
        cls_preds = self.fc_stack("cls", feats, valid)
        part_preds = self.fc_stack("part", feats, valid)
        batch["point_cls_preds"] = cls_preds
        batch["point_part_preds"] = part_preds
        batch["point_cls_scores"] = torch.sigmoid(cls_preds.amax(dim=-1))
        batch["point_part_offset"] = torch.sigmoid(part_preds)
        if self.coder is not None:
            box_preds = self.fc_stack("reg", feats, valid)
            batch["point_box_preds_enc"] = box_preds
            batch = decode_proposals(batch, cls_preds, box_preds, self.coder)
        return batch


@torch.no_grad()
def assign_part_targets(points, points_valid, gt_boxes_with_cls,
                        extra_width=(0.2, 0.2, 0.2)):
    """(labels (B, P) in {-1, 0, 1..C}, part targets (B, P, 3) in [0, 1],
    zero off the foreground)."""
    labels, safe, fg = point_fg_labels(points, points_valid,
                                       gt_boxes_with_cls, extra_width)
    box_of = _take(gt_boxes_with_cls[..., :7], safe)
    local = rotate_points_along_z((points - box_of[..., :3])[..., None, :],
                                  -box_of[..., 6])[..., 0, :]
    part = local / torch.clamp(box_of[..., 3:6], min=1e-5) + 0.5
    return labels, torch.where(fg[..., None], part, torch.zeros_like(part))


def point_part_head_loss(out_batch, model_cfg, num_class):
    """Focal classification + part-location BCE: (loss, tb)."""
    labels, part_targets = assign_part_targets(
        out_batch["point_coords"], out_batch["point_valid"],
        out_batch["gt_boxes"], tuple(model_cfg["TARGET_CONFIG"].get(
            "GT_EXTRA_WIDTH", (0.2, 0.2, 0.2))))
    cls_preds = out_batch["point_cls_preds"]
    part_preds = out_batch["point_part_preds"]
    valid = out_batch["point_valid"]
    lw = model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
    pos = (labels > 0) & valid
    neg = (labels == 0) & valid
    pos_norm = pos.float().sum()
    cls_w = (neg.float() + pos.float()) / torch.clamp(pos_norm, min=1.0)
    onehot = F.one_hot(torch.clamp(labels, 0, num_class),
                       num_class + 1)[..., 1:].float()
    cls_loss = L.sigmoid_focal_loss(cls_preds, onehot, cls_w).sum() \
        * float(lw["point_cls_weight"])
    bce = L.sigmoid_cross_entropy_with_logits(part_preds, part_targets)
    part_loss = (bce.sum(-1) * pos.float()).sum() \
        / (3 * torch.clamp(pos_norm, min=1.0)) \
        * float(lw["point_part_weight"])
    return cls_loss + part_loss, {"point_loss_cls": cls_loss,
                                  "point_loss_part": part_loss,
                                  "point_pos_num": pos_norm}
