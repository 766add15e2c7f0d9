"""PointHeadBox, PointRCNN's first stage, and PointHeadBoxWPseudos — port
of findnpropagate_tpu/models/dense_heads/point_head_box.py (`_fc_stack`
:30, `PointHeadBox` :38, `_make_coder` :77, `assign_point_targets` :85,
`point_head_box_loss` :118, `PointHeadBoxWPseudos` :151,
`_relabel_known_to_full` :190, `point_head_box_w_pseudo_loss` :205).

Per-point Linear (no bias) + masked BN + ReLU stacks (``cls_fc{i}`` /
``cls_bn{i}`` / ``cls_out``, ``reg_...``) over the point features; the
box branch's PointResidualCoder residuals are decoded at the points into
the proposals the ROI head reads (``batch_cls_preds``, padded points at
-1e9, ``batch_box_preds``). PointHeadBox keeps the reference's binary
head: one cls channel, so every decode uses class 1's mean size.
PointHeadBoxWPseudos scores the full class space (ALL_CLASS_NAMES) and
trains on the known-class ground truth relabelled into it plus the
batch's ``pseudo_boxes``.

Targets (`assign_point_targets`): a valid point inside a ground-truth box
is foreground (1, or the box's class), one only inside the box grown by
GT_EXTRA_WIDTH is ignored (-1); foreground points carry the residuals of
their box (the first box that holds them). The loss: sigmoid focal
classification and code-weighted smooth-L1 regression, both normalised by
the batch's positives.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...utils import losses as L
from ...utils.box_coders import PointResidualCoder
from ...utils.geometry import enlarge_box3d, points_in_boxes_mask
from ..blocks import MaskedBatchNorm


class FCStacks(nn.Module):
    """Named Linear + masked BN + ReLU stacks, each ending in a Linear
    ``{name}_out``: ``{name}_fc{i}`` / ``{name}_bn{i}``."""

    def add_fc_stack(self, name, cin, channels, out_ch):
        cin = int(cin)
        for i, ch in enumerate(channels):
            self.add_module(f"{name}_fc{i}", nn.Linear(cin, int(ch),
                                                       bias=False))
            self.add_module(f"{name}_bn{i}", MaskedBatchNorm(int(ch)))
            cin = int(ch)
        self.add_module(f"{name}_out", nn.Linear(cin, int(out_ch)))
        self.depth = getattr(self, "depth", {})
        self.depth[name] = len(channels)

    def fc_stack(self, name, x, valid):
        for i in range(self.depth[name]):
            x = torch.relu(getattr(self, f"{name}_bn{i}")(
                getattr(self, f"{name}_fc{i}")(x), valid,
                channels_last=True))
        return getattr(self, f"{name}_out")(x)


def make_coder(cfg):
    bc = cfg["TARGET_CONFIG"]["BOX_CODER_CONFIG"]
    return PointResidualCoder(
        use_mean_size=bool(bc.get("use_mean_size", True)),
        mean_size=tuple(tuple(m) for m in bc.get("mean_size", ())))


def decode_proposals(batch, cls_preds, box_preds, coder):
    """The per-point boxes of the first stage, the ROI head's proposals."""
    valid = batch["point_valid"]
    pred_classes = torch.argmax(cls_preds, dim=-1) + 1
    decoded = coder.decode(box_preds, batch["point_coords"], pred_classes)
    batch["batch_cls_preds"] = torch.where(
        valid[..., None], cls_preds, torch.full_like(cls_preds, -1e9))
    batch["batch_box_preds"] = decoded[..., :7]
    batch["cls_preds_normalized"] = False
    return batch


class PointHeadBox(FCStacks):
    """`num_class`: its cls channels, 1 as the fork pins it (no yaml
    changes it)."""

    def __init__(self, model_cfg, input_channels, num_class=1):
        super().__init__()
        self.model_cfg = model_cfg
        self.feature_key = "point_features_before_fusion" if bool(
            model_cfg.get("USE_POINT_FEATURES_BEFORE_FUSION", False)) \
            else "point_features"
        self.coder = make_coder(model_cfg)
        self.add_fc_stack("cls", input_channels, model_cfg["CLS_FC"],
                          num_class)
        self.add_fc_stack("reg", input_channels, model_cfg["REG_FC"],
                          self.coder.code_size)

    def forward(self, batch):
        feats = batch[self.feature_key]
        valid = batch["point_valid"]
        cls_preds = self.fc_stack("cls", feats, valid)
        box_preds = self.fc_stack("reg", feats, valid)
        batch["point_cls_preds"] = cls_preds
        batch["point_box_preds_enc"] = box_preds
        batch["point_cls_scores"] = torch.sigmoid(cls_preds.amax(dim=-1))
        return decode_proposals(batch, cls_preds, box_preds, self.coder)


class PointHeadBoxWPseudos(PointHeadBox):
    """The full class space: len(ALL_CLASS_NAMES) cls channels (num_class
    where the yaml names none); reads ``point_features``."""

    def __init__(self, model_cfg, input_channels, num_class=10):
        n = len(model_cfg.get("ALL_CLASS_NAMES", [None] * int(num_class)))
        super().__init__(model_cfg, input_channels, num_class=n)
        self.feature_key = "point_features"


def points_in_boxes_index(points, boxes, boxes_mask):
    """points (B, P, 3), boxes (B, N, 7), boxes_mask (B, N) -> (B, P)
    int64 index of the first masked box holding the point, -1 if none."""
    out = []
    for pts, bx, bm in zip(points, boxes, boxes_mask):
        inside = points_in_boxes_mask(pts, bx) & bm[:, None]     # (N, P)
        first = torch.argmax(inside.to(torch.uint8), dim=0)
        out.append(torch.where(inside.any(dim=0), first,
                               torch.full_like(first, -1)))
    return torch.stack(out)


def _take(x, idx):
    """x (B, N, ...) at idx (B, P) -> (B, P, ...)."""
    flat = idx.reshape(*idx.shape, *([1] * (x.ndim - 2))).expand(
        *idx.shape, *x.shape[2:])
    return torch.gather(x, 1, flat)


@torch.no_grad()
def point_fg_labels(points, points_valid, gt_boxes_with_cls, extra_width):
    """(labels (B, P): the containing box's class at foreground points, 0
    at background, -1 in the GT_EXTRA_WIDTH ring; the index of the
    containing box, clamped to 0; foreground mask)."""
    boxes = gt_boxes_with_cls[..., :7]
    gcls = gt_boxes_with_cls[..., -1].to(torch.int64)
    gvalid = gcls > 0
    idx = points_in_boxes_index(points, boxes, gvalid)
    fg = (idx >= 0) & points_valid
    idx_ext = points_in_boxes_index(points, enlarge_box3d(boxes,
                                                          extra_width),
                                    gvalid)
    ignore = fg ^ ((idx_ext >= 0) & points_valid)
    safe = torch.clamp(idx, min=0)
    labels = torch.where(fg, _take(gcls, safe), torch.zeros_like(safe))
    labels = torch.where(ignore, torch.full_like(labels, -1), labels)
    return labels, safe, fg


@torch.no_grad()
def assign_point_targets(points, points_valid, gt_boxes_with_cls, coder,
                         extra_width=(0.2, 0.2, 0.2), binary=True):
    """(labels (B, P) in {-1, 0, 1} — or the box's class without
    `binary` —, box residual targets (B, P, code) at foreground points)."""
    labels, safe, fg = point_fg_labels(points, points_valid,
                                       gt_boxes_with_cls, extra_width)
    if binary:
        labels = torch.where(labels > 0, torch.ones_like(labels), labels)
    gt_of = _take(gt_boxes_with_cls[..., :7], safe)
    cls_of = _take(gt_boxes_with_cls[..., -1].to(torch.int64), safe)
    enc = coder.encode(gt_of, points, cls_of)
    return labels, torch.where(fg[..., None], enc, torch.zeros_like(enc))


def _box_head_loss(out_batch, cfg, labels, box_targets, onehot):
    cls_preds = out_batch["point_cls_preds"]
    box_preds = out_batch["point_box_preds_enc"]
    valid = out_batch["point_valid"]
    lw = cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
    pos = (labels > 0) & valid
    neg = (labels == 0) & valid
    pos_norm = pos.float().sum()
    cls_w = (neg.float() + pos.float()) / torch.clamp(pos_norm, min=1.0)
    cls_loss = L.sigmoid_focal_loss(cls_preds, onehot, cls_w).sum() \
        * float(lw["point_cls_weight"])
    code_w = torch.as_tensor(lw.get("code_weights",
                                    [1.0] * box_preds.shape[-1]),
                             dtype=box_preds.dtype, device=box_preds.device)
    reg_w = pos.float() / torch.clamp(pos_norm, min=1.0)
    diff = L.smooth_l1(box_preds - box_targets, beta=1.0 / 9.0)
    reg_loss = (diff * code_w * reg_w[..., None]).sum() \
        * float(lw["point_box_weight"])
    return cls_loss + reg_loss, {"point_loss_cls": cls_loss,
                                 "point_loss_box": reg_loss,
                                 "point_pos_num": pos_norm}


def _extra_width(cfg):
    return tuple(cfg["TARGET_CONFIG"].get("GT_EXTRA_WIDTH", (0.2, 0.2, 0.2)))


def point_head_box_loss(out_batch, model_cfg):
    """The binary head's focal classification + box regression: (loss,
    tb)."""
    labels, box_targets = assign_point_targets(
        out_batch["point_coords"], out_batch["point_valid"],
        out_batch["gt_boxes"], make_coder(model_cfg),
        _extra_width(model_cfg))
    pos = (labels > 0) & out_batch["point_valid"]
    return _box_head_loss(out_batch, model_cfg, labels, box_targets,
                          pos.float()[..., None])


def relabel_known_to_full(gt_boxes, known_names, all_names):
    """Ground-truth label i (1-indexed into KNOWN_CLASS_NAMES) -> its
    index in ALL_CLASS_NAMES, 1-indexed."""
    lut = [0] + [list(all_names).index(n) + 1 for n in known_names]
    lut = torch.as_tensor(lut, dtype=gt_boxes.dtype, device=gt_boxes.device)
    labels = torch.clamp(gt_boxes[..., -1].to(torch.int64), 0,
                         len(known_names))
    return torch.cat([gt_boxes[..., :-1], lut[labels][..., None]], dim=-1)


def point_head_box_w_pseudo_loss(out_batch, model_cfg):
    """Full-space multi-class focal classification + box regression over
    the relabelled ground truth and the batch's pseudo boxes: (loss,
    tb)."""
    all_names = list(model_cfg["ALL_CLASS_NAMES"])
    n_cls = len(all_names)
    gt = relabel_known_to_full(out_batch["gt_boxes"],
                               list(model_cfg["KNOWN_CLASS_NAMES"]),
                               all_names)
    if "pseudo_boxes" in out_batch:
        pb = out_batch["pseudo_boxes"]
        gt = torch.cat([gt, pb[..., :gt.shape[-1]].to(gt.dtype)], dim=1)
    labels, box_targets = assign_point_targets(
        out_batch["point_coords"], out_batch["point_valid"], gt,
        make_coder(model_cfg), _extra_width(model_cfg), binary=False)
    onehot = F.one_hot(torch.clamp(labels, 0, n_cls), n_cls + 1)[..., 1:]
    return _box_head_loss(out_batch, model_cfg, labels, box_targets,
                          onehot.float())
