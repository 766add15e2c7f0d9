"""Axis-aligned anchor target assignment — port of
findnpropagate_tpu/models/dense_heads/target_assigner.py
(`_assign_single` :31-78, `assign_targets` :81-110).

Per sample: the IoU of every anchor with every ground truth of its class
(nearest-BEV, or 3D with MATCH_HEIGHT; other pairs and padding rows -2);
each ground truth's best anchors (IoU == its maximum, > 0) are force-matched
to their own best ground truth; anchors at or above their class's
matched_threshold are foreground, below unmatched_threshold background,
the rest ignored (-1); foreground anchors get ResidualCoder targets.
Labels come out exactly as the reference's: the IoU is the reference's
float32 arithmetic, and torch.argmax, like jnp.argmax, takes the first
maximum. Samples are assigned one at a time, so the peak memory is one
(anchors x ground truths) IoU matrix with its masks: 1.31 M anchors x 256
boxes is 1.3 GB a matrix (waymo_models/pointpillar_1x.yaml).
"""

from __future__ import annotations

import torch

from ...ops.rotated_iou import boxes_iou3d, boxes_nearest_bev_iou


def assign_single(anchors, anchor_class, matched_t, unmatched_t, gt_boxes,
                  gt_classes, coder, match_height: bool):
    """anchors (N, 7), anchor_class (N,) 0-indexed, gt_boxes (M, 7),
    gt_classes (M,) 1-indexed with 0 = padding. Returns labels (N,) int32,
    regression targets (N, code) and weights (N,)."""
    iou = boxes_iou3d(anchors, gt_boxes) if match_height \
        else boxes_nearest_bev_iou(anchors, gt_boxes)
    pair_valid = (anchor_class[:, None] == (gt_classes[None, :] - 1)) \
        & (gt_classes > 0)[None, :]
    iou = iou.masked_fill_(~pair_valid, -2.0)
    anchor_to_gt_max = iou.amax(dim=1)
    anchor_to_gt_argmax = torch.argmax(iou, dim=1)
    gt_to_anchor_max = iou.amax(dim=0)
    force = pair_valid & (iou == gt_to_anchor_max[None, :]) \
        & (gt_to_anchor_max > 0)[None, :]
    del iou, pair_valid
    fg = force.any(dim=1) | (anchor_to_gt_max >= matched_t)
    bg = anchor_to_gt_max < unmatched_t
    labels = torch.where(fg, gt_classes[anchor_to_gt_argmax],
                         torch.where(bg, 0, -1)).to(torch.int32)
    reg = coder.encode(gt_boxes[anchor_to_gt_argmax], anchors[:, :7])
    reg = torch.where(fg[:, None], reg, torch.zeros_like(reg))
    return labels, reg, fg.to(torch.float32)


def assign_targets(anchors, anchor_class, matched_t, unmatched_t, gt_boxes,
                   coder, match_height: bool = False,
                   norm_by_num_examples: bool = False):
    """gt_boxes (B, M, 8+) [x, y, z, dx, dy, dz, rot, ..., class] — the
    first 7 columns are the box, column 7 the class, as in the reference.
    Returns {box_cls_labels (B, N), box_reg_targets (B, N, code),
    reg_weights (B, N)}."""
    gt = gt_boxes[..., :7]
    gt_cls = gt_boxes[..., 7].to(torch.int64)
    out = [assign_single(anchors, anchor_class, matched_t, unmatched_t,
                         gt[i], gt_cls[i], coder, match_height)
           for i in range(gt_boxes.shape[0])]
    labels, reg_targets, reg_weights = (torch.stack(x) for x in zip(*out))
    if norm_by_num_examples:
        num_examples = (labels >= 0).sum(dim=1, keepdim=True).to(
            torch.float32)
        reg_weights = reg_weights / torch.clamp(num_examples, min=1.0)
    return {"box_cls_labels": labels, "box_reg_targets": reg_targets,
            "reg_weights": reg_weights}
