"""CenterHead, CenterPoint's heatmap head — port of
findnpropagate_tpu/models/dense_heads/center_head.py (`CenterHead` :33-116,
`CenterHeadTools` :119-334, `make_center_head_tools` :337-356).

Shared 3x3 conv -> BatchNorm (eps 1e-3, flax momentum) -> ReLU, then one
SeparateHead per CLASS_NAMES_EACH_HEAD group over the flattened (B, HW, C)
map; each group's outputs are (B, H, W, C), as in the reference. Targets:
a gaussian heatmap per group with group-local class ids, and per ground
truth a regression slot (sub-cell centre offset, z, log dims, cos / sin
yaw, the extra columns) at its centre cell. Loss: CenterNet focal loss on
the clipped sigmoid plus the masked L1 of the slots gathered at their cells
(an invalid slot gathers cell 0 and is masked). Decode: per group the top
MAX_OBJ_PER_SAMPLE (class, cell) pairs, ties to the lower index, the score
and range filter, global labels, then class-agnostic rotated NMS over all
groups with the invalid candidates masked. The reference's pure
`CenterHeadTools` functions are methods of the head here, written over the
whole batch (the reference vmaps per-sample functions).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...utils import losses as L
from ..blocks import BN_EPS, BatchNorm2d
from ..model_utils.centernet import draw_heatmap, gaussian_radius, topk_heatmap
from ..post_processing import nms_detections
from .transfusion_head import SeparateHead


def _gather_rows(x, idx):
    """x (B, N, C), idx (B, K) -> (B, K, C); the backward adds the rows of
    repeated indices, as take_along_axis's does."""
    return torch.gather(x, 1, idx.long()[..., None].expand(
        -1, -1, x.shape[-1]))


def _nms_detections(boxes, scores, labels, ok, nms_cfg, thresh, pre, post):
    """Class-agnostic rotated NMS of (B, N) candidates with the head's
    NMS_CONFIG (defaults `thresh`, `pre`, `post`)."""
    return nms_detections(
        boxes, scores, labels, ok, float(nms_cfg.get("NMS_THRESH", thresh)),
        int(nms_cfg.get("NMS_PRE_MAXSIZE", pre)),
        int(nms_cfg.get("NMS_POST_MAXSIZE", post)))


class CenterHead(nn.Module):
    bn_eps = BN_EPS

    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 point_cloud_range, voxel_size, grid_size,
                 predict_boxes_when_training=False):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.num_classes = int(num_class)
        self.class_names = tuple(class_names)
        self.grid_size = tuple(int(g) for g in grid_size)   # (nx, ny, nz)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.predict_boxes_when_training = bool(predict_boxes_when_training)
        self.shared_ch = int(cfg.get("SHARED_CONV_CHANNEL", 64))
        self.use_bias = bool(cfg.get("USE_BIAS_BEFORE_NORM", False))
        names = list(self.class_names)
        self.group_names = [list(g) for g in (
            cfg.get("CLASS_NAMES_EACH_HEAD") or [names])]
        # per group its global 1-indexed labels; one implicit group of
        # every class when CLASS_NAMES_EACH_HEAD is not given
        self.group_labels = tuple(
            tuple(names.index(n) + 1 for n in g) for g in self.group_names) \
            if cfg.get("CLASS_NAMES_EACH_HEAD") \
            else (tuple(range(1, self.num_classes + 1)),)
        self._build(input_channels)

    def _build(self, input_channels):
        self.shared_conv = nn.Conv2d(input_channels, self.shared_ch, 3,
                                     padding=1, bias=self.use_bias)
        self.shared_bn = BatchNorm2d(self.shared_ch, eps=self.bn_eps)
        for gi, group in enumerate(self.group_names):
            self.add_module(f"group{gi}", SeparateHead(
                self._head_dict(len(group)), self.shared_ch, self.shared_ch,
                use_bias=self.use_bias))

    def _head_dict(self, hm_channels):
        heads = dict(self.model_cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"])
        heads["hm"] = {"out_channels": hm_channels,
                       "num_conv": int(self.model_cfg.get("NUM_HM_CONV", 2))}
        return heads

    def _shared(self, batch):
        x = batch["spatial_features_2d"]                 # (B, Cin, H, W)
        x = torch.relu(self.shared_bn(self.shared_conv(x)))
        b, c, h, w = x.shape
        return x.flatten(2).transpose(1, 2), (b, h, w)   # (B, HW, C)

    def forward(self, batch, generator=None):
        """generator: unused (the head has no dropout)."""
        xf, (b, h, w) = self._shared(batch)
        out = tuple({k: v.reshape(b, h, w, -1)
                     for k, v in getattr(self, f"group{gi}")(xf).items()}
                    for gi in range(len(self.group_names)))
        batch["center_preds"] = out
        if self.predict_boxes_when_training:
            self._dense_decode(batch, out, b, h, w)
        return batch

    def _dense_decode(self, batch, out, b, h, w):
        """Every cell's box and class scores in the global class layout,
        for a proposal stage downstream (center_head.py:79-116)."""
        stride = self.stride
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        pcr = self.point_cloud_range
        dev = out[0]["hm"].device
        xs = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
        ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        cls_rows, box_rows = [], []
        for preds, labels in zip(out, self.group_labels):
            cx = (xs + preds["center"][..., 0]) * stride * vx + pcr[0]
            cy = (ys + preds["center"][..., 1]) * stride * vy + pcr[1]
            ang = torch.atan2(preds["rot"][..., 1], preds["rot"][..., 0])
            parts = [cx[..., None], cy[..., None], preds["center_z"],
                     torch.exp(preds["dim"]), ang[..., None]]
            if "vel" in preds:
                parts.append(preds["vel"])
            box_rows.append(torch.cat(parts, dim=-1).reshape(b, h * w, -1))
            hm = torch.sigmoid(preds["hm"]).reshape(b, h * w, len(labels))
            full = hm.new_zeros(b, h * w, self.num_classes)
            full[..., [lb - 1 for lb in labels]] = hm
            cls_rows.append(full)
        batch["batch_cls_preds"] = torch.cat(cls_rows, dim=1)
        batch["batch_box_preds"] = torch.cat(box_rows, dim=1)
        batch["cls_preds_normalized"] = True

    # ---- targets and loss ------------------------------------------------

    @property
    def stride(self):
        return int(self.model_cfg["TARGET_ASSIGNER_CONFIG"]
                   ["FEATURE_MAP_STRIDE"])

    @property
    def head_order(self):
        return list(self.model_cfg["SEPARATE_HEAD_CFG"]["HEAD_ORDER"])

    def fm_size(self):
        return (self.grid_size[1] // self.stride,
                self.grid_size[0] // self.stride)

    def assign_single(self, gt_boxes, gt_labels, gt_valid, num_classes):
        """(B, M, 7+) boxes, (B, M) group-local 0-indexed labels and
        validity -> heatmaps (B, C, H, W), target slots (B, M, 8 + extra),
        cell indices (B, M) (0 where invalid) and the valid mask (B, M)
        (center_head.py:152-209)."""
        cfg = self.model_cfg["TARGET_ASSIGNER_CONFIG"]
        h, w = self.fm_size()
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        pcr = self.point_cloud_range
        cx = torch.clamp((gt_boxes[..., 0] - pcr[0]) / vx / self.stride,
                         0, w - 0.5)
        cy = torch.clamp((gt_boxes[..., 1] - pcr[1]) / vy / self.stride,
                         0, h - 0.5)
        cxi = cx.to(torch.int32)
        cyi = cy.to(torch.int32)
        dx = gt_boxes[..., 3] / vx / self.stride
        dy = gt_boxes[..., 4] / vy / self.stride
        radius = gaussian_radius(dx, dy,
                                 float(cfg.get("GAUSSIAN_OVERLAP", 0.1)))
        radius = torch.clamp(radius.to(torch.int32),
                             int(cfg.get("MIN_RADIUS", 2)), max(h, w) // 2)
        valid = gt_valid & (dx > 0) & (dy > 0)
        heatmap = draw_heatmap(torch.stack([cx, cy], -1), radius, gt_labels,
                               valid, num_classes=num_classes, height=h,
                               width=w)
        logd = torch.log(torch.clamp(gt_boxes[..., 3:6], min=1e-5))
        target = torch.cat([
            (cx - cxi.to(cx.dtype))[..., None],
            (cy - cyi.to(cy.dtype))[..., None], gt_boxes[..., 2:3], logd,
            torch.cos(gt_boxes[..., 6:7]), torch.sin(gt_boxes[..., 6:7]),
            gt_boxes[..., 7:]], dim=-1)
        inds = cyi * w + cxi
        return (heatmap,
                torch.where(valid[..., None], target, torch.zeros_like(target)),
                torch.where(valid, inds, torch.zeros_like(inds)), valid)

    @torch.no_grad()
    def assign(self, gt_boxes_with_cls, group=None, num_classes=None):
        """gt (B, M, 8+) padded, class last (1-indexed, 0 = padding). With
        `group` (its global labels) the boxes of other classes are dropped
        and the labels are the group's own, 0-indexed."""
        gt = gt_boxes_with_cls[..., :-1]
        glabels = gt_boxes_with_cls[..., -1].to(torch.int32)
        valid = glabels > 0
        if group is None:
            labels = torch.clamp(glabels - 1, min=0)
            nc = num_classes or self.num_classes
        else:
            lut = [-1] * (self.num_classes + 1)
            for li, gl in enumerate(group):
                lut[gl] = li
            local = torch.tensor(lut, dtype=torch.int32, device=gt.device)[
                torch.clamp(glabels, 0, self.num_classes).long()]
            valid = valid & (local >= 0)
            labels = torch.clamp(local, min=0)
            nc = len(group)
        return self.assign_single(gt, labels, valid, nc)

    def _reg_loss(self, preds, target_boxes, inds, masks, lw):
        """The weighted masked L1 of the regression slots at their cells."""
        b, h, w, _ = preds["hm"].shape
        reg = torch.cat([preds[k] for k in self.head_order],
                        dim=-1).reshape(b, h * w, -1)
        gathered = _gather_rows(reg, inds)
        code = gathered.shape[-1]
        target = target_boxes[..., :code]
        if target.shape[-1] < code:
            # boxes without velocity (the data layer keeps 7 values) under
            # a velocity head: NaN targets, which the loss leaves out; the
            # reference's shapes do not broadcast there
            target = F.pad(target, (0, code - target.shape[-1]),
                           value=float("nan"))
        per_dim = L.reg_loss_centernet(gathered, target, masks)
        code_w = torch.tensor(lw["code_weights"], dtype=torch.float32,
                              device=reg.device)
        return (per_dim * code_w).sum() * float(lw["loc_weight"])

    @staticmethod
    def _hm_loss(hm, heatmaps, lw):
        pred = torch.clamp(torch.sigmoid(hm.permute(0, 3, 1, 2)),
                           1e-4, 1 - 1e-4)
        return L.focal_loss_centernet(pred, heatmaps) \
            * float(lw["cls_weight"])

    def compute_loss(self, out_batch):
        """(total loss, tb dict of 0-d tensors)."""
        preds_all = out_batch["center_preds"]
        if isinstance(preds_all, dict):
            preds_all = (preds_all,)
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        hm_total = loc_total = 0.0
        for preds, group in zip(preds_all, self.group_labels):
            heatmaps, target_boxes, inds, masks = self.assign(
                out_batch["gt_boxes"],
                group=None if len(self.group_labels) == 1 else group)
            hm_total = hm_total + self._hm_loss(preds["hm"], heatmaps, lw)
            loc_total = loc_total + self._reg_loss(preds, target_boxes, inds,
                                                   masks, lw)
        total = hm_total + loc_total
        return total, {"hm_loss": hm_total.detach(),
                       "loc_loss": loc_total.detach(),
                       "rpn_loss": total.detach()}

    # ---- decode ------------------------------------------------------------

    def _post(self, dev):
        pp = self.model_cfg["POST_PROCESSING"]
        return (pp, float(pp.get("SCORE_THRESH", 0.1)),
                torch.tensor(pp["POST_CENTER_LIMIT_RANGE"],
                             dtype=torch.float32, device=dev))

    def _decode_top(self, preds, k, keys):
        """The top-k (class, cell) pairs of one group over the batch and
        their boxes from the regression outputs `keys`: (scores, class ids,
        flat cells, boxes (B, k, 7 + extra))."""
        h, w = self.fm_size()
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        pcr = self.point_cloud_range
        b = preds["hm"].shape[0]
        scores, cls_ids, ys, xs, flat = topk_heatmap(
            torch.sigmoid(preds["hm"].permute(0, 3, 1, 2)), k)
        reg = torch.cat([preds[key].reshape(b, h * w, -1) for key in keys],
                        dim=-1)
        g = _gather_rows(reg, flat)
        x = (xs.float() + g[..., 0]) * self.stride * vx + pcr[0]
        y = (ys.float() + g[..., 1]) * self.stride * vy + pcr[1]
        parts = [x[..., None], y[..., None], g[..., 2:3],
                 torch.exp(g[..., 3:6]),
                 torch.atan2(g[..., 7], g[..., 6])[..., None], g[..., 8:]]
        return scores, cls_ids, flat, torch.cat(parts, dim=-1)

    @staticmethod
    def _in_range(scores, boxes, score_thresh, post_range):
        return ((scores > score_thresh)
                & (boxes[..., :3] >= post_range[:3]).all(-1)
                & (boxes[..., :3] <= post_range[3:]).all(-1))

    @torch.no_grad()
    def get_bboxes(self, out_batch, max_obj: int = 500):
        """Final detections: (B, NMS_POST_MAXSIZE) fixed slots, labels
        1-indexed global."""
        preds_all = out_batch["center_preds"]
        if isinstance(preds_all, dict):
            preds_all = (preds_all,)
        pp, score_thresh, post_range = self._post(preds_all[0]["hm"].device)
        k = int(pp.get("MAX_OBJ_PER_SAMPLE", max_obj))
        parts_b, parts_s, parts_l, parts_ok = [], [], [], []
        for preds, group in zip(preds_all, self.group_labels):
            keys = ["center", "center_z", "dim", "rot"] \
                + (["vel"] if "vel" in preds else [])
            scores, cls_ids, _, boxes = self._decode_top(preds, k, keys)
            ok = self._in_range(scores, boxes, score_thresh, post_range)
            lut = torch.tensor((0,) + tuple(group), dtype=torch.int32,
                               device=boxes.device)
            parts_b.append(boxes)
            parts_s.append(torch.where(ok, scores, torch.zeros_like(scores)))
            parts_l.append(lut[torch.clamp(cls_ids + 1, 0, len(group))
                               .long()])
            parts_ok.append(ok)
        return _nms_detections(
            torch.cat(parts_b, 1), torch.cat(parts_s, 1),
            torch.cat(parts_l, 1), torch.cat(parts_ok, 1),
            pp.get("NMS_CONFIG", {}), 0.7, k, 128)
