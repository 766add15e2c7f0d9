"""AnchorHeadSingle, its targets, loss and decode — port of
findnpropagate_tpu/models/dense_heads/anchor_head.py (`AnchorHeadSingle`
:45-124, `AnchorHeadTools` :127-209, `make_anchor_head_tools` :212-232,
`_add_sin_difference` :235).

1x1 convs ``conv_cls`` / ``conv_box`` (/ ``conv_dir``) over the NCHW BEV
map, flattened to the anchors' (y, x, anchor) order; the boxes are decoded
from the anchors with the ResidualCoder and, with the direction
classifier, the heading snapped to the predicted direction bin. The loss
(`AnchorHeadTools`, shared with AnchorHeadMulti): sigmoid focal loss over
the cared anchors, normalised per sample by its positives; smooth L1 of
the box deltas with the sin-difference heading and the code weights; the
direction bins' cross entropy over the positives. The anchors and their
per-anchor class and thresholds are non-persistent buffers of the tools,
so they follow the head to its device and stay out of checkpoints.

The coder is read from ``DENSE_HEAD.BOX_CODER_CONFIG`` only, as in the
reference: the multi-head yamls' ``BOX_CODER_CONFIG`` under
``TARGET_ASSIGNER_CONFIG`` (sincos, code 7 or 9) is not read, so their
8- to 11-value ``code_weights`` meet a 7-wide code and training raises,
as the reference's does (its smooth L1 fails to broadcast); inference
works.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...parallel.mesh import global_rows
from ...utils import losses as L
from ...utils.box_coders import ResidualCoder
from ...utils.geometry import limit_period
from .anchor_generator import generate_anchors
from .target_assigner import assign_targets


def build_anchors(model_cfg, grid_size, point_cloud_range):
    return generate_anchors(model_cfg["ANCHOR_GENERATOR_CONFIG"], grid_size,
                            point_cloud_range)


def dir_params(model_cfg):
    return (float(model_cfg.get("DIR_OFFSET", 0.78539)),
            float(model_cfg.get("DIR_LIMIT_OFFSET", 0.0)),
            int(model_cfg.get("NUM_DIR_BINS", 2)))


def head_coder(model_cfg, sincos=True):
    """The ResidualCoder of DENSE_HEAD.BOX_CODER_CONFIG (AnchorHeadMulti's
    ignores its encode_angle_by_sincos, as the reference's does)."""
    bc = model_cfg.get("BOX_CODER_CONFIG", {}) or {}
    return ResidualCoder(
        code_size=int(bc.get("code_size", 7)),
        encode_angle_by_sincos=sincos and bool(
            bc.get("encode_angle_by_sincos", False)))


def decode_boxes(model_cfg, coder, anchors, box_preds, dir_preds):
    """Boxes (B, N, 7+) of the deltas over the anchors (N, 7), the heading
    snapped to the direction bin when dir_preds is given."""
    boxes = coder.decode(box_preds, anchors[None])
    if dir_preds is None:
        return boxes
    dir_offset, dir_limit_offset, num_bins = dir_params(model_cfg)
    period = 2 * np.pi / num_bins
    dir_labels = torch.argmax(dir_preds, dim=-1)
    dir_rot = limit_period(boxes[..., 6] - dir_offset, dir_limit_offset,
                           period)
    heading = dir_rot + dir_offset + period * dir_labels.to(boxes.dtype)
    return torch.cat([boxes[..., :6], heading[..., None], boxes[..., 7:]],
                     dim=-1)


def add_sin_difference(boxes1, boxes2, dim: int = 6):
    rad_pred = torch.sin(boxes1[..., dim:dim + 1]) \
        * torch.cos(boxes2[..., dim:dim + 1])
    rad_tg = torch.cos(boxes1[..., dim:dim + 1]) \
        * torch.sin(boxes2[..., dim:dim + 1])
    return (torch.cat([boxes1[..., :dim], rad_pred, boxes1[..., dim + 1:]],
                      dim=-1),
            torch.cat([boxes2[..., :dim], rad_tg, boxes2[..., dim + 1:]],
                      dim=-1))


class AnchorHeadTools(nn.Module):
    """Target assignment and loss of an anchor head (no parameters)."""

    def __init__(self, model_cfg, num_class, anchors, anchor_class,
                 matched_t, unmatched_t, coder, class_slots):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = int(num_class)
        self.coder = coder
        # the class index of each anchor slot of a location (A,)
        self.class_slots = np.asarray(class_slots)
        for name, arr in (("anchors", anchors), ("anchor_class", anchor_class),
                          ("matched_t", matched_t),
                          ("unmatched_t", unmatched_t)):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(
                arr)), persistent=False)

    def assign(self, gt_boxes):
        tac = self.model_cfg.get("TARGET_ASSIGNER_CONFIG", {})
        return assign_targets(
            self.anchors, self.anchor_class.long(), self.matched_t,
            self.unmatched_t, gt_boxes, self.coder,
            match_height=bool(tac.get("MATCH_HEIGHT", False)),
            norm_by_num_examples=bool(tac.get("NORM_BY_NUM_EXAMPLES", False)))

    def compute_loss(self, out_batch):
        self.check_code_weights(out_batch["box_preds"].shape[-1])
        return self.loss(out_batch, self.assign(out_batch["gt_boxes"]))

    def check_code_weights(self, code):
        cw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"].get("code_weights")
        if cw is not None and len(cw) != code:
            raise ValueError(
                f"DENSE_HEAD.LOSS_CONFIG.LOSS_WEIGHTS.code_weights holds "
                f"{len(cw)} values, but the box code is {code} wide: the "
                "coder is read from DENSE_HEAD.BOX_CODER_CONFIG only (absent:"
                " the 7-wide raw-angle ResidualCoder), and a BOX_CODER_CONFIG "
                "under DENSE_HEAD.TARGET_ASSIGNER_CONFIG is not read")

    def loss(self, out_batch, targets):
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        cls_preds = out_batch["cls_preds"]
        box_preds = out_batch["box_preds"]
        labels = targets["box_cls_labels"]
        reg_targets = targets["box_reg_targets"]
        batch_size = global_rows(cls_preds.shape[0])

        positives = labels > 0
        cls_weights = (labels >= 0).to(torch.float32)
        pos_normalizer = torch.clamp(positives.sum(
            dim=1, keepdim=True).to(torch.float32), min=1.0)
        reg_weights = targets["reg_weights"] / pos_normalizer
        cls_weights = cls_weights / pos_normalizer
        cls_targets = torch.where(labels >= 0, labels,
                                  torch.zeros_like(labels))
        one_hot = F.one_hot(cls_targets.long(), self.num_class + 1)[
            ..., 1:].to(cls_preds.dtype)
        cls_loss = L.sigmoid_focal_loss(cls_preds, one_hot, cls_weights).sum() \
            / batch_size * float(lw["cls_weight"])

        bp_sin, rt_sin = add_sin_difference(box_preds, reg_targets)
        loc_loss = L.weighted_smooth_l1_loss(
            bp_sin, rt_sin, reg_weights, code_weights=lw.get("code_weights")
        ).sum() / batch_size * float(lw["loc_weight"])
        tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
        total = cls_loss + loc_loss

        if "dir_cls_preds" in out_batch:
            dir_offset, _, num_bins = dir_params(self.model_cfg)
            rot_gt = reg_targets[..., 6] + self.anchors[None, :, 6]
            offset_rot = limit_period(rot_gt - dir_offset, 0, 2 * np.pi)
            bin_width = torch.full((), 2 * math.pi / num_bins,
                                   dtype=offset_rot.dtype,
                                   device=offset_rot.device)
            dir_targets = torch.clamp(torch.floor(offset_rot / bin_width).to(
                torch.int64), 0, num_bins - 1)
            w = positives.to(torch.float32)
            w = w / torch.clamp(w.sum(dim=-1, keepdim=True), min=1.0)
            dir_loss = L.weighted_cross_entropy_loss(
                out_batch["dir_cls_preds"],
                F.one_hot(dir_targets, num_bins).to(cls_preds.dtype), w
            ).sum() / batch_size * float(lw["dir_weight"])
            total = total + dir_loss
            tb["rpn_loss_dir"] = dir_loss
        tb["rpn_loss"] = total
        return total, tb


def make_anchor_head_tools(model_cfg, num_class, grid_size,
                           point_cloud_range):
    anchors, _, cls_slots, matched, unmatched = build_anchors(
        model_cfg, grid_size, point_cloud_range)
    # per-location arrays (A,) -> per anchor (ny * nx * A,), (y, x, a) order
    locs = anchors.shape[0] * anchors.shape[1]
    return AnchorHeadTools(
        model_cfg, num_class, anchors.reshape(-1, anchors.shape[-1]),
        np.tile(cls_slots, locs), np.tile(matched, locs),
        np.tile(unmatched, locs), head_coder(model_cfg), cls_slots)


def nchw_rows(x, width):
    """(B, A * width, H, W) -> (B, H * W * A, width), the (y, x, a) order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1, width)


class AnchorHeadSingle(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 point_cloud_range, voxel_size=(), grid_size=(),
                 predict_boxes_when_training=True):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.num_class = int(num_class)
        self.predict_boxes_when_training = bool(predict_boxes_when_training)
        self.tools = make_anchor_head_tools(cfg, num_class, grid_size,
                                            point_cloud_range)
        self.box_coder = head_coder(cfg)
        a = len(self.tools.class_slots)
        code = self.box_coder.full_code_size
        self.conv_cls = nn.Conv2d(input_channels, a * self.num_class, 1)
        nn.init.constant_(self.conv_cls.bias, -math.log((1 - 0.01) / 0.01))
        self.conv_box = nn.Conv2d(input_channels, a * code, 1)
        nn.init.normal_(self.conv_box.weight, std=0.001)
        self.use_dir = bool(cfg.get("USE_DIRECTION_CLASSIFIER", False))
        if self.use_dir:
            self.conv_dir = nn.Conv2d(input_channels,
                                      a * int(cfg["NUM_DIR_BINS"]), 1)

    def forward(self, batch, generator=None):
        x = batch["spatial_features_2d"]          # (B, C, H, W)
        code = self.box_coder.full_code_size
        batch["cls_preds"] = nchw_rows(self.conv_cls(x), self.num_class)
        batch["box_preds"] = nchw_rows(self.conv_box(x), code)
        dir_preds = None
        if self.use_dir:
            dir_preds = nchw_rows(self.conv_dir(x),
                                  int(self.model_cfg["NUM_DIR_BINS"]))
            batch["dir_cls_preds"] = dir_preds
        return decode_into(self, batch, dir_preds)

    def compute_loss(self, out_batch):
        return self.tools.compute_loss(out_batch)


def decode_into(head, batch, dir_preds):
    """The decoded boxes into the batch, as the reference's heads write
    them (at eval, and in training with predict_boxes_when_training). In
    training no gradient is kept unless the head's `boxes_need_grad` is
    set: a two-stage detector's ROI losses differentiate through them."""
    if head.training and not head.predict_boxes_when_training:
        return batch
    keep = not head.training or getattr(head, "boxes_need_grad", False)
    with contextlib.nullcontext() if keep else torch.no_grad():
        batch["batch_box_preds"] = decode_boxes(
            head.model_cfg, head.box_coder, head.tools.anchors,
            batch["box_preds"], dir_preds)
    batch["batch_cls_preds"] = batch["cls_preds"]
    batch["cls_preds_normalized"] = False
    return batch
