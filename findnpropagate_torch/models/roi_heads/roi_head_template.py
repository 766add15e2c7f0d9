"""Two-stage (R-CNN) machinery: the proposal layer, proposal-target
sampling, canonical-frame targets and the second-stage losses — port of
findnpropagate_tpu/models/roi_heads/roi_head_template.py
(`proposal_layer` :29, `_masked_rank` :50, `sample_rois_for_rcnn` :61,
`canonicalize_gt_of_rois` :147, `rcnn_reg_loss` :163, `rcnn_cls_loss`
:193, `generate_predicted_boxes` :206).

Every function takes the batch axis first, the JAX functions' per-sample
arguments stacked:
  * the proposal layer is class-agnostic rotated NMS to a fixed ROI count
    (NMS_POST_MAXSIZE), labels 1-indexed, empty slots zero;
  * ROI sampling ranks the foreground, hard and easy background ROIs by
    uniform draws, caps them at the reference's ratios and takes
    ROI_PER_IMAGE by one top-k of priority + draw / 2. The draws are an
    argument `r` (B, M): the port cannot replay JAX's PRNG, so the caller
    draws them from its torch.Generator (or is handed the JAX draws, as
    the parity tests do). Sorts and top-k break ties as `lax.top_k` and
    the stable `jnp.argsort` do: the lower index first;
  * the losses are masked means over the fixed ROI set, the regression
    loss per sample and then averaged over the batch, as the reference
    vmaps it.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.nms import _top_k, nms_bev
from ...ops.rotated_iou import boxes_iou3d
from ...utils.box_coders import ResidualCoder
from ...utils.geometry import rotate_points_along_z
from ...utils.losses import corner_loss_lidar, smooth_l1
from ..blocks import MaskedBatchNorm
from ..model_utils.transformer import dropout


def _take(x, idx):
    """x (B, N, ...) at idx (B, K) -> (B, K, ...)."""
    idx = idx.long()
    flat = idx.reshape(*idx.shape, *([1] * (x.ndim - 2))).expand(
        *idx.shape, *x.shape[2:])
    return torch.gather(x, 1, flat)


def proposal_layer(cls_preds, box_preds, nms_cfg):
    """cls_preds (B, N, C), box_preds (B, N, 7+) -> (rois (B, M, 7+),
    roi_scores (B, M), roi_labels (B, M) int64 1-indexed, roi_valid
    (B, M)) with M = NMS_POST_MAXSIZE."""
    post = int(nms_cfg["NMS_POST_MAXSIZE"])
    scores = cls_preds.amax(dim=-1)
    labels = torch.argmax(cls_preds, dim=-1)     # the first of equal maxima
    with torch.no_grad():
        # indices only: the up to 9000^2 IoUs keep no autograd graph
        idx, _ = nms_bev(box_preds.detach(), scores.detach(),
                         float(nms_cfg["NMS_THRESH"]),
                         pre_maxsize=int(nms_cfg["NMS_PRE_MAXSIZE"]),
                         post_maxsize=post)
    valid = idx >= 0
    sel = torch.clamp(idx, min=0)
    rois = torch.where(valid[..., None], _take(box_preds, sel),
                       torch.zeros((), dtype=box_preds.dtype,
                                   device=box_preds.device))
    roi_scores = torch.where(valid, _take(scores, sel),
                             torch.zeros_like(scores[:, :1]))
    roi_labels = torch.where(valid, _take(labels, sel) + 1,
                             torch.zeros_like(labels[:, :1]))
    return rois, roi_scores, roi_labels, valid


def _masked_rank(keys, mask):
    """Rank (0-based) of each element among the masked ones by ascending
    key along the last axis, the lower index first among equal keys;
    masked-out elements get rank N."""
    n = keys.shape[-1]
    k = torch.where(mask, keys, torch.full_like(keys, math.inf))
    order = torch.argsort(k, dim=-1, stable=True)
    rank = torch.empty_like(order).scatter_(
        -1, order, torch.arange(n, device=keys.device).expand_as(order))
    return torch.where(mask, rank, torch.full_like(rank, n))


def sample_rois_for_rcnn(r, rois, roi_scores, roi_labels, roi_valid,
                         gt_boxes, gt_labels, gt_valid, sampler_cfg):
    """Fixed-count ROI subsampling with the reference's fg / bg ratios.
    r (B, M) uniform draws in [0, 1); rois (B, M, 7+); gt_boxes (B, G, 7).
    Returns a dict of (B, ROI_PER_IMAGE, ...) entries, `take` the source
    index of each sampled ROI."""
    n_roi = int(sampler_cfg["ROI_PER_IMAGE"])
    fg_ratio = float(sampler_cfg["FG_RATIO"])
    reg_fg = float(sampler_cfg["REG_FG_THRESH"])
    cls_fg = float(sampler_cfg["CLS_FG_THRESH"])
    cls_bg = float(sampler_cfg["CLS_BG_THRESH"])
    bg_lo = float(sampler_cfg["CLS_BG_THRESH_LO"])
    hard_ratio = float(sampler_cfg["HARD_BG_RATIO"])
    fg_per_image = int(round(fg_ratio * n_roi))
    fg_thresh = min(reg_fg, cls_fg)

    iou = boxes_iou3d(rois[..., :7], gt_boxes[..., :7])      # (B, M, G)
    keep = gt_valid[:, None, :]
    if bool(sampler_cfg.get("SAMPLE_ROI_BY_EACH_CLASS", True)):
        keep = keep & (roi_labels[:, :, None] == gt_labels[:, None, :])
    iou = torch.where(keep, iou, torch.zeros_like(iou))
    max_overlaps = iou.amax(dim=-1)
    gt_assignment = torch.argmax(iou, dim=-1)
    max_overlaps = torch.where(roi_valid, max_overlaps,
                               torch.zeros_like(max_overlaps))

    fg = roi_valid & (max_overlaps >= fg_thresh)
    easy = roi_valid & (max_overlaps < bg_lo)
    hard = roi_valid & (max_overlaps >= bg_lo) & (max_overlaps < reg_fg) \
        & ~fg
    fg_rank = _masked_rank(r, fg)
    hard_rank = _masked_rank(r, hard)
    easy_rank = _masked_rank(r, easy)

    i32 = torch.int32
    n_fg = torch.clamp(fg.sum(-1).to(i32), max=fg_per_image)
    n_bg = n_roi - n_fg
    n_hard_want = (n_bg * hard_ratio).to(i32)
    n_hard = torch.minimum(hard.sum(-1).to(i32), n_hard_want)
    n_easy = torch.minimum(easy.sum(-1).to(i32), n_bg - n_hard)
    # easy running short: more hard (sample_bg_inds' fallback)
    n_hard2 = torch.minimum(hard.sum(-1).to(i32), n_bg - n_easy)

    sel = (fg & (fg_rank < n_fg[:, None])) \
        | (hard & (hard_rank < n_hard2[:, None])) \
        | (easy & (easy_rank < n_easy[:, None]))
    prio = torch.where(sel, 2.0, torch.where(roi_valid, 1.0, 0.0)).to(
        r.dtype)
    _, take = _top_k(prio + r * 0.5, n_roi)

    assign = _take(gt_assignment, take)
    gt_src = _take(gt_boxes[..., :7], assign)
    out = {
        "rois": _take(rois, take),
        "roi_scores": _take(roi_scores, take),
        "roi_labels": _take(roi_labels, take),
        "gt_of_rois_src": torch.where(_take(gt_valid, assign)[..., None],
                                      gt_src, torch.zeros_like(gt_src)),
        "gt_labels_of_rois": _take(gt_labels, assign),
        "gt_iou_of_rois": _take(max_overlaps, take),
        "roi_valid": _take(roi_valid, take),
        "take": take,
    }
    ious = out["gt_iou_of_rois"]
    out["reg_valid_mask"] = (ious > reg_fg) & out["roi_valid"]
    if str(sampler_cfg.get("CLS_SCORE_TYPE", "roi_iou")) == "roi_iou":
        fg_m = ious > cls_fg
        interval = ~fg_m & ~(ious < cls_bg)
        lab = torch.where(interval,
                          (ious - cls_bg) / max(cls_fg - cls_bg, 1e-6),
                          fg_m.to(ious.dtype))
    else:   # 'cls'
        lab = (ious > cls_fg).to(ious.dtype)
        lab = torch.where((ious > cls_bg) & (ious < cls_fg),
                          torch.full_like(lab, -1.0), lab)
    out["rcnn_cls_labels"] = torch.where(out["roi_valid"], lab,
                                         torch.full_like(lab, -1.0))
    return out


def canonicalize_gt_of_rois(rois, gt_of_rois):
    """The ground truth in each ROI's frame with the heading flipped into
    [-pi/2, pi/2]. rois / gt (..., M, 7+)."""
    two_pi = 2 * math.pi
    roi_ry = torch.remainder(rois[..., 6], two_pi)
    xyz = rotate_points_along_z((gt_of_rois[..., 0:3]
                                 - rois[..., 0:3])[..., None, :],
                                -roi_ry)[..., 0, :]
    heading = torch.remainder(gt_of_rois[..., 6] - roi_ry, two_pi)
    opposite = (heading > math.pi * 0.5) & (heading < math.pi * 1.5)
    heading = torch.where(opposite,
                          torch.remainder(heading + math.pi, two_pi),
                          heading)
    heading = torch.where(heading > math.pi, heading - two_pi, heading)
    heading = torch.clamp(heading, -math.pi / 2, math.pi / 2)
    return torch.cat([xyz, gt_of_rois[..., 3:6], heading[..., None],
                      gt_of_rois[..., 7:]], dim=-1)


def _roi_anchors(rois):
    """The ROIs as anchors of their own frame: centre and heading 0."""
    z = torch.zeros_like(rois[..., :3])
    return torch.cat([z, rois[..., 3:6], z[..., :1]], dim=-1)


def _to_lidar(decoded, rois):
    xyz = rotate_points_along_z(decoded[..., None, 0:3],
                                rois[..., 6])[..., 0, :]
    return torch.cat([xyz + rois[..., 0:3], decoded[..., 3:6],
                      (decoded[..., 6] + rois[..., 6])[..., None],
                      decoded[..., 7:]], dim=-1)


def rcnn_reg_loss(rcnn_reg, rois, gt_ct, gt_src, reg_valid, loss_cfg,
                  coder: ResidualCoder):
    """Smooth-L1 of the canonical residuals (+ the corner loss), per sample
    (B,): (loss, tb of per-sample losses)."""
    anchors = _roi_anchors(rois)
    reg_targets = coder.encode(gt_ct[..., :7], anchors)
    cw = torch.as_tensor(loss_cfg["LOSS_WEIGHTS"]["code_weights"],
                         dtype=rcnn_reg.dtype, device=rcnn_reg.device)
    l1 = smooth_l1(rcnn_reg - reg_targets, beta=1.0 / 9.0) * cw
    fg = reg_valid.to(rcnn_reg.dtype)
    n_fg = torch.clamp(fg.sum(-1), min=1.0)
    loss = (l1.sum(-1) * fg).sum(-1) / n_fg \
        * float(loss_cfg["LOSS_WEIGHTS"]["rcnn_reg_weight"])
    tb = {"rcnn_loss_reg": loss}
    if bool(loss_cfg.get("CORNER_LOSS_REGULARIZATION", False)):
        decoded = _to_lidar(coder.decode(rcnn_reg, anchors), rois)
        b, m = fg.shape
        cl = corner_loss_lidar(decoded[..., :7].reshape(b * m, 7),
                               gt_src[..., :7].reshape(b * m, 7)).reshape(
                                   b, m)
        closs = (cl * fg).sum(-1) / n_fg \
            * float(loss_cfg["LOSS_WEIGHTS"]["rcnn_corner_weight"])
        loss = loss + closs
        tb["rcnn_loss_corner"] = closs
    return loss, tb


def rcnn_cls_loss(rcnn_cls, cls_labels, loss_cfg):
    """Binary cross entropy over every labelled ROI of the batch."""
    logits = rcnn_cls.reshape(-1)
    labels = cls_labels.reshape(-1)
    valid = (labels >= 0).to(logits.dtype)
    p = torch.sigmoid(logits)
    bce = -(labels * torch.log(torch.clamp(p, min=1e-7))
            + (1 - labels) * torch.log(torch.clamp(1 - p, min=1e-7)))
    loss = (bce * valid).sum() / torch.clamp(valid.sum(), min=1.0) \
        * float(loss_cfg["LOSS_WEIGHTS"]["rcnn_cls_weight"])
    return loss, {"rcnn_loss_cls": loss}


def generate_predicted_boxes(rois, rcnn_reg, coder: ResidualCoder):
    """The second stage's residuals decoded back to the lidar frame.
    rois (..., M, 7), rcnn_reg (..., M, 7)."""
    return _to_lidar(coder.decode(rcnn_reg, _roi_anchors(rois)), rois)


def two_stage_rcnn_loss(out_batch, loss_cfg):
    """The cls + reg losses over the stored targets (pvrcnn_head.py:159,
    shared by VoxelRCNNHead): the regression loss is the batch mean of the
    per-sample losses."""
    t = out_batch["rcnn_targets"]
    cls_loss, tb = rcnn_cls_loss(out_batch["rcnn_cls"], t["rcnn_cls_labels"],
                                 loss_cfg)
    reg, tb_reg = rcnn_reg_loss(out_batch["rcnn_reg"], out_batch["rois"],
                                t["gt_of_rois"], t["gt_of_rois_src"],
                                t["reg_valid_mask"], loss_cfg,
                                ResidualCoder())
    tb = dict(tb)
    tb.update({k: v.mean() for k, v in tb_reg.items()})
    total = cls_loss + reg.mean()
    tb["rcnn_loss"] = total
    return total, tb


class RoIHeadTemplate(nn.Module):
    """What the ROI heads share: the proposal layer and the ROI sampling of
    their NMS_CONFIG / TARGET_CONFIG, their Linear (no bias) + masked BN +
    ReLU towers under the flax names (``{name}_fc{i}``, ``{name}_bn{i}``),
    and the refinement outputs."""

    def __init__(self, model_cfg, point_cloud_range, voxel_size,
                 num_class=1):
        super().__init__()
        self.model_cfg = model_cfg
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.num_class = int(num_class)
        self.dp_ratio = float(model_cfg.get("DP_RATIO", 0))
        self.stacks = {}

    def add_stack(self, name, cin, channels):
        """Linear + masked BN layers ``{name}_fc{i}`` / ``{name}_bn{i}``;
        returns the width out."""
        cin = int(cin)
        for i, ch in enumerate(channels):
            self.add_module(f"{name}_fc{i}", nn.Linear(cin, int(ch),
                                                       bias=False))
            self.add_module(f"{name}_bn{i}", MaskedBatchNorm(int(ch)))
            cin = int(ch)
        self.stacks[name] = len(channels)
        return cin

    def run_stack(self, name, x, valid, dropout_after=(), generator=None):
        """The stack over x (B, M, C) with BN over the valid ROIs, dropout
        (DP_RATIO, training only) after the layers in `dropout_after`."""
        for i in range(self.stacks[name]):
            x = getattr(self, f"{name}_fc{i}")(x)
            x = torch.relu(getattr(self, f"{name}_bn{i}")(
                x, valid, channels_last=True))
            if i in dropout_after and self.dp_ratio > 0:
                x = dropout(x, self.dp_ratio, self.training, generator)
        return x

    def proposals(self, batch, generator=None, from_batch=False):
        """(rois, roi_scores, roi_labels, roi_valid, targets): the proposal
        layer over the first stage's boxes and, in training, the sampled
        ROIs with their targets (None at eval). With `from_batch`, ROIs an
        earlier stage wrote (PV-RCNN++) are taken as they are."""
        if from_batch and "rois" in batch:
            return (batch["rois"], batch.get("roi_scores"),
                    batch["roi_labels"], batch["roi_valid"],
                    batch.get("roi_targets"))
        cfg = self.model_cfg
        nms_cfg = cfg["NMS_CONFIG"]["TRAIN" if self.training else "TEST"]
        rois, scores, labels, valid = proposal_layer(
            batch["batch_cls_preds"], batch["batch_box_preds"], nms_cfg)
        if not self.training:
            return rois, scores, labels, valid, None
        t = sample_targets(batch, rois, scores, labels, valid,
                           cfg["TARGET_CONFIG"], generator)
        return t["rois"], t["roi_scores"], t["roi_labels"], \
            t["roi_valid"], t

    def refined(self, batch, rois, roi_labels, roi_valid, rcnn_cls,
                rcnn_reg, targets):
        """The refinement outputs: training targets in the ROIs' frame, or
        at eval the decoded boxes for the two-stage post-processing."""
        batch.update(rois=rois, roi_labels=roi_labels, roi_valid=roi_valid,
                     rcnn_cls=rcnn_cls, rcnn_reg=rcnn_reg)
        if self.training:
            batch["rcnn_targets"] = {
                "rcnn_cls_labels": targets["rcnn_cls_labels"],
                "reg_valid_mask": targets["reg_valid_mask"],
                "gt_of_rois": canonicalize_gt_of_rois(
                    rois, targets["gt_of_rois_src"][..., :7]),
                "gt_of_rois_src": targets["gt_of_rois_src"]}
        else:
            batch.update(
                batch_cls_preds=rcnn_cls,
                batch_box_preds=generate_predicted_boxes(rois, rcnn_reg,
                                                         ResidualCoder()),
                batch_roi_labels=roi_labels, cls_preds_normalized=False,
                rcnn_iou=rcnn_cls)
        return batch


def sample_targets(batch, rois, roi_scores, roi_labels, roi_valid,
                   target_cfg, generator=None):
    """sample_rois_for_rcnn over the batch's ground truths (B, G, 8), the
    draws from ``batch["roi_draws"]`` (B, M) where given, else uniform from
    `generator` on the ROIs' device."""
    gt = batch["gt_boxes"]
    r = batch.get("roi_draws")
    if r is None:
        r = torch.rand(rois.shape[:2], generator=generator,
                       device=rois.device)
    return sample_rois_for_rcnn(
        r.to(rois.dtype), rois, roi_scores, roi_labels, roi_valid,
        gt[..., :7], gt[..., -1].to(torch.int64), gt[..., -1] > 0,
        target_cfg)
