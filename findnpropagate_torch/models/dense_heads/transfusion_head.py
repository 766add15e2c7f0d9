"""TransFusionHead — port of
findnpropagate_tpu/models/dense_heads/transfusion_head.py (forward
:41-199, `decode_boxes` :226-240, targets and loss :241-496, `get_bboxes`
:498-536).

Shared conv -> class heatmap -> 3x3 local-max query selection (kernel 1
for the small nuScenes classes) -> top NUM_PROPOSALS over (class, cell) ->
class embedding -> one transformer decoder layer over the flattened BEV ->
per-query regression heads; decode with the heatmap-score blend. Ties in
both top-k's go to the lower index, as in `jax.lax.top_k`. Maps are NCHW;
per-query tensors (B, P, C) as in the reference.

Training: Hungarian-matched targets from the detached predictions (focal
class cost + normalised-centre L1 + 3D IoU with the assigner's
z-as-bottom height overlap), gaussian heatmap targets, and the loss
(gaussian focal heatmap + sigmoid focal class + L1 box) with its `tb`
dictionary. The reference's pure `TransFusionTools` functions are methods
here, written over the whole batch (the reference vmaps per-sample
functions). The matching itself runs on the host (ops/lap.py): one
device-to-host copy of the (B, M, P) cost per step.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.lap import solve_lap
from ...ops.rotated_iou import boxes_overlap_bev
from ...parallel.mesh import all_sum
from ...utils import losses as L
from ..blocks import BN_EPS, BatchNorm1d, BatchNorm2d
from ..model_utils.centernet import draw_heatmap, gaussian_radius
from ..model_utils.transformer import TransformerDecoderLayer
from ..post_processing import Detections, top_k_lower_index_first


class SeparateHead(nn.Module):
    """Per output name: (num_conv-1) x [Linear, BatchNorm, ReLU], Linear."""

    def __init__(self, head_dict, in_channels, head_channels=64,
                 use_bias=False):
        super().__init__()
        self.spec = {k: (int(v["out_channels"]), int(v["num_conv"]))
                     for k, v in head_dict.items()}
        for name, (out_c, n_conv) in self.spec.items():
            c = in_channels
            for k in range(n_conv - 1):
                self.add_module(f"{name}_fc{k}",
                                nn.Linear(c, head_channels, bias=use_bias))
                self.add_module(f"{name}_bn{k}",
                                BatchNorm1d(head_channels, eps=BN_EPS))
                c = head_channels
            self.add_module(f"{name}_out", nn.Linear(c, out_c))

    def forward(self, x):
        out = {}
        for name, (_, n_conv) in self.spec.items():
            h = x
            for k in range(n_conv - 1):
                h = getattr(self, f"{name}_fc{k}")(h)
                h = getattr(self, f"{name}_bn{k}")(
                    h.transpose(1, 2)).transpose(1, 2)
                h = torch.relu(h)
            out[name] = getattr(self, f"{name}_out")(h)
        return out


class TransFusionHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 point_cloud_range, voxel_size, grid_size):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.num_classes = int(cfg.get("NUM_CLASSES", num_class))
        self.class_names = tuple(class_names)
        self.grid_size = tuple(int(g) for g in grid_size)   # (nx, ny, nz)
        self.unknown_labels = tuple(cfg.get("UNKNOWN_LABELS", ()))
        self.relabel_lut = tuple(cfg.get("RELABEL_LUT", ()))
        if "KNOWN_CLASS_NAMES" in cfg and "FULL_CLASS_NAMES" in cfg:
            known = list(cfg["KNOWN_CLASS_NAMES"])
            full = list(cfg["FULL_CLASS_NAMES"])
            self.relabel_lut = tuple([0] + [full.index(n) + 1 for n in known])
            self.unknown_labels = tuple(
                i + 1 for i, n in enumerate(full) if n not in known)
        self.hidden = int(cfg["HIDDEN_CHANNEL"])
        self.num_proposals = int(cfg["NUM_PROPOSALS"])
        self.nms_kernel_size = int(cfg.get("NMS_KERNEL_SIZE", 3))
        ta = cfg["TARGET_ASSIGNER_CONFIG"]
        self.stride = int(ta.get("FEATURE_MAP_STRIDE", 8))
        self.dataset_name = ta.get("DATASET", "nuScenes")
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.voxel_size = tuple(float(v) for v in voxel_size)

        h = self.hidden
        self.shared_conv = nn.Conv2d(input_channels, h, 3, padding=1)
        self.hm_block_conv = nn.Conv2d(
            h, h, 3, padding=1,
            bias=bool(cfg.get("USE_BIAS_BEFORE_NORM", False)))
        self.hm_block_bn = BatchNorm2d(h, eps=BN_EPS)
        self.hm_out = nn.Conv2d(h, self.num_classes, 3, padding=1)
        self.class_encoding = nn.Linear(self.num_classes, h)
        self.decoder = TransformerDecoderLayer(
            d_model=h, nhead=int(cfg["NUM_HEADS"]),
            dim_feedforward=int(cfg["FFN_CHANNEL"]),
            dropout=float(cfg.get("DROPOUT", 0.1)))
        heads = dict(cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"])
        heads["heatmap"] = {"out_channels": self.num_classes,
                            "num_conv": int(cfg.get("NUM_HM_CONV", 2))}
        self.prediction_head = SeparateHead(
            heads, h, use_bias=bool(cfg.get("USE_BIAS_BEFORE_NORM", False)))

    def _flat_kernel1_classes(self):
        if self.dataset_name == "nuScenes" and self.num_classes == 10:
            return (8, 9)
        if self.dataset_name == "Waymo":
            return (1, 2)
        if self.dataset_name == "kitti":
            return tuple(i for i, n in enumerate(self.class_names)
                         if n in ("Pedestrian", "Person_Sitting", "Cyclist"))
        return ()

    def forward(self, batch, generator=None):
        """generator: the torch.Generator of the decoder's dropout masks
        (training only)."""
        feats = batch["spatial_features_2d"]            # (B, Cin, H, W)
        b, _, h, w = feats.shape
        lidar_feat = self.shared_conv(feats)            # (B, hidden, H, W)
        lidar_flat = lidar_feat.flatten(2).transpose(1, 2)   # (B, HW, hid)

        hm = torch.relu(self.hm_block_bn(self.hm_block_conv(lidar_feat)))
        dense_heatmap = self.hm_out(hm)                 # (B, C, H, W)

        heatmap = torch.sigmoid(dense_heatmap.detach())
        pad = self.nms_kernel_size // 2
        inner = F.max_pool2d(heatmap, self.nms_kernel_size, stride=1)
        local_max = F.pad(inner, (pad, pad, pad, pad))
        for ci in self._flat_kernel1_classes():
            local_max[:, ci] = heatmap[:, ci]
        heatmap = heatmap * (heatmap == local_max)

        # top NUM_PROPOSALS over (class, cell): class = idx // (H*W)
        _, top = top_k_lower_index_first(heatmap.reshape(b, -1),
                                         self.num_proposals)
        query_class = top // (h * w)
        query_index = top % (h * w)
        query_feat = torch.gather(
            lidar_flat, 1, query_index[..., None].expand(-1, -1, self.hidden))
        one_hot = F.one_hot(query_class, self.num_classes).to(
            query_feat.dtype)
        query_feat = query_feat + self.class_encoding(one_hot)

        ys = (query_index // w).float() + 0.5
        xs = (query_index % w).float() + 0.5
        query_pos = torch.stack([xs, ys], dim=-1)
        yy, xx = torch.meshgrid(torch.arange(h, device=feats.device),
                                torch.arange(w, device=feats.device),
                                indexing="ij")
        bev_pos = torch.stack([xx.reshape(-1) + 0.5, yy.reshape(-1) + 0.5],
                              dim=-1).float()
        bev_pos = bev_pos[None].expand(b, -1, -1)

        query_feat = self.decoder(query_feat, lidar_flat, query_pos, bev_pos,
                                  generator)
        res = self.prediction_head(query_feat)
        res["center"] = res["center"] + query_pos
        res["query_heatmap_score"] = torch.gather(
            heatmap.reshape(b, self.num_classes, h * w), 2,
            query_index[:, None, :].expand(-1, self.num_classes, -1)
        ).transpose(1, 2)
        res["dense_heatmap"] = dense_heatmap
        res["query_labels"] = query_class.to(torch.int32)
        batch["transfusion_preds"] = res
        return batch

    def decode_boxes(self, res):
        """res dict -> (B, P, 7 or 9) world boxes."""
        pcr = self.point_cloud_range
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        center = res["center"]
        x = center[..., 0] * self.stride * vx + pcr[0]
        y = center[..., 1] * self.stride * vy + pcr[1]
        z = res["height"][..., 0]
        dims = torch.exp(res["dim"])
        rot = torch.atan2(res["rot"][..., 0], res["rot"][..., 1])
        parts = [x[..., None], y[..., None], z[..., None], dims,
                 rot[..., None]]
        if "vel" in res:
            parts.append(res["vel"])
        return torch.cat(parts, dim=-1)

    # ---- targets and loss ------------------------------------------------

    @property
    def code_size(self):
        return len(self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
                   ["code_weights"])

    def encode_gt(self, gt_boxes):
        """(..., M, 7+) world gt -> (..., M, code) regression targets. A
        code of 10 reads the velocity columns 7 and 8; on narrower boxes
        the column index clamps to the last one, as an out-of-range index
        does in the reference."""
        pcr = self.point_cloud_range
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        last = gt_boxes.shape[-1] - 1
        out = [(gt_boxes[..., 0] - pcr[0]) / (self.stride * vx),
               (gt_boxes[..., 1] - pcr[1]) / (self.stride * vy),
               gt_boxes[..., 2],
               torch.log(torch.clamp(gt_boxes[..., 3], min=1e-5)),
               torch.log(torch.clamp(gt_boxes[..., 4], min=1e-5)),
               torch.log(torch.clamp(gt_boxes[..., 5], min=1e-5)),
               torch.sin(gt_boxes[..., 6]),
               torch.cos(gt_boxes[..., 6])]
        if self.code_size == 10:
            out.extend([gt_boxes[..., min(7, last)],
                        gt_boxes[..., min(8, last)]])
        return torch.stack(out, dim=-1)

    @staticmethod
    def _iou3d_bottom(boxes_a, boxes_b):
        """(B, P, 7+), (B, M, 7+) -> (B, P, M) 3D IoU with the assigner's
        quirk of reading z as the box bottom in the height overlap."""
        overlap_bev = boxes_overlap_bev(boxes_a[..., :7], boxes_b[..., :7])
        a_top = (boxes_a[..., 2] + boxes_a[..., 5])[..., :, None]
        a_bot = boxes_a[..., 2][..., :, None]
        b_top = (boxes_b[..., 2] + boxes_b[..., 5])[..., None, :]
        b_bot = boxes_b[..., 2][..., None, :]
        overlap_h = torch.clamp(torch.minimum(a_top, b_top)
                                - torch.maximum(a_bot, b_bot), min=0.0)
        inter = overlap_bev * overlap_h
        va = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., None]
        vb = (boxes_b[..., 3] * boxes_b[..., 4]
              * boxes_b[..., 5])[..., None, :]
        return inter / torch.clamp(va + vb - inter, min=1e-8)

    def _is_unknown(self, labels0):
        unk = torch.zeros_like(labels0, dtype=torch.bool)
        for u in self.unknown_labels:
            unk |= (labels0 + 1) == int(u)
        return unk

    def _assign(self, res, gt_boxes, gt_labels, gt_valid):
        """Hungarian assignment of the batch. res: detached head outputs
        (B, P, ...); gt_boxes (B, M, 7+), gt_labels (B, M) 0-indexed,
        gt_valid (B, M)."""
        cfg = self.model_cfg["TARGET_ASSIGNER_CONFIG"]["HUNGARIAN_ASSIGNER"]
        boxes = self.decode_boxes(res)                      # (B, P, 7+)
        score = res["heatmap"]                              # (B, P, C)
        b, p, _ = score.shape
        m = gt_boxes.shape[1]

        alpha = float(cfg["cls_cost"].get("alpha", 0.25))
        gamma = float(cfg["cls_cost"].get("gamma", 2.0))
        w_cls = float(cfg["cls_cost"].get("weight", 0.15))
        eps = 1e-12
        prob = torch.sigmoid(score)
        neg_cost = -torch.log(1 - prob + eps) * (1 - alpha) * prob ** gamma
        pos_cost = -torch.log(prob + eps) * alpha * (1 - prob) ** gamma
        cls_cost = torch.gather(
            pos_cost - neg_cost, 2,
            gt_labels.long()[:, None, :].expand(b, p, m)) * w_cls

        pcr = torch.tensor(self.point_cloud_range, device=score.device)
        w_reg = float(cfg["reg_cost"].get("weight", 0.25))
        span = pcr[3:5] - pcr[0:2]
        nb = (boxes[..., :2] - pcr[0:2]) / span
        ng = (gt_boxes[..., :2] - pcr[0:2]) / span
        reg_cost = (nb[:, :, None] - ng[:, None, :]).abs().sum(-1) * w_reg

        w_iou = float(cfg["iou_cost"].get("weight", 0.25))
        iou = self._iou3d_bottom(boxes, gt_boxes)
        cost = cls_cost + reg_cost - iou * w_iou            # (B, P, M)

        col_to_row = solve_lap(cost.transpose(1, 2), gt_valid).long()
        matched = col_to_row >= 0
        safe_gt = torch.clamp(col_to_row, min=0)

        labels = torch.where(matched, torch.gather(gt_labels.long(), 1,
                                                   safe_gt),
                             torch.full_like(safe_gt, self.num_classes))
        label_weights = torch.ones(b, p, device=score.device)
        enc = self.encode_gt(gt_boxes)
        bbox_targets = torch.where(
            matched[..., None],
            torch.gather(enc, 1, safe_gt[..., None].expand(
                b, p, enc.shape[-1])), torch.zeros(()).to(enc))
        bbox_weights = matched[..., None].float().expand(
            b, p, self.code_size)
        ious = torch.where(
            matched, torch.gather(iou, 2, safe_gt[..., None])[..., 0],
            torch.zeros(()).to(iou))
        ious = torch.clamp(ious, 0.0, 1.0)
        unknown_mask = matched & self._is_unknown(labels)
        return labels, label_weights, bbox_targets, bbox_weights, \
            matched.sum(), ious, unknown_mask

    def _heatmap_targets(self, gt_boxes, gt_labels, gt_valid):
        cfg = self.model_cfg["TARGET_ASSIGNER_CONFIG"]
        vx, vy = self.voxel_size[0], self.voxel_size[1]
        w = self.grid_size[0] // self.stride
        h = self.grid_size[1] // self.stride
        dx = gt_boxes[..., 3] / vx / self.stride
        dy = gt_boxes[..., 4] / vy / self.stride
        radius = gaussian_radius(dy, dx,
                                 float(cfg.get("GAUSSIAN_OVERLAP", 0.1)))
        radius = torch.clamp(radius.to(torch.int32),
                             min=int(cfg.get("MIN_RADIUS", 2)))
        if self.unknown_labels:
            mult = float(cfg.get("UNK_RADIUS_MULT", 1.0))
            radius = torch.where(self._is_unknown(gt_labels),
                                 (radius.float() * mult).to(torch.int32),
                                 radius)
        pcr = self.point_cloud_range
        cx = (gt_boxes[..., 0] - pcr[0]) / vx / self.stride
        cy = (gt_boxes[..., 1] - pcr[1]) / vy / self.stride
        valid = gt_valid & (dx > 0) & (dy > 0)
        return draw_heatmap(torch.stack([cx, cy], -1), radius, gt_labels,
                            valid, num_classes=self.num_classes, height=h,
                            width=w)

    @torch.no_grad()
    def get_targets(self, res, gt_boxes_with_cls):
        """res: batched head outputs; gt (B, M, 8+) padded, class last
        (1-indexed, 0 = padding)."""
        gt = gt_boxes_with_cls[..., :-1]
        gt_labels = torch.clamp(gt_boxes_with_cls[..., -1].to(torch.int32)
                                - 1, min=0)
        gt_valid = ((gt_boxes_with_cls[..., -1] > 0) & (gt[..., 3] > 0)
                    & (gt[..., 4] > 0))
        keys = [k for k in ("center", "height", "dim", "rot", "vel",
                            "heatmap") if k in res]
        res_sub = {k: res[k].detach() for k in keys}
        labels, lw, bt, bw, npos, ious, unk = self._assign(
            res_sub, gt, gt_labels, gt_valid)
        heatmap = self._heatmap_targets(gt, gt_labels, gt_valid)
        return {"labels": labels, "label_weights": lw, "bbox_targets": bt,
                "bbox_weights": bw, "num_pos": npos, "ious": ious,
                "heatmap": heatmap, "unknown_mask": unk}

    def merge_pseudos(self, gt_boxes, pseudo_boxes):
        """GT + pseudo-label merge: relabel the known-space GT labels into
        the full class space through the LUT, then append the padded pseudo
        boxes (zero rows stay padding)."""
        gt = gt_boxes
        if self.relabel_lut:
            lut = torch.tensor(self.relabel_lut, dtype=torch.long,
                               device=gt.device)
            labels = torch.clamp(gt[..., -1].long(), 0, len(lut) - 1)
            gt = torch.cat([gt[..., :-1], torch.where(
                gt[..., -1] > 0, lut[labels].to(gt.dtype),
                torch.zeros(()).to(gt))[..., None]], dim=-1)
        c = gt.shape[-1]
        pseudo = pseudo_boxes[..., :c]
        if pseudo_boxes.shape[-1] < c:
            pad = gt.new_zeros(*pseudo_boxes.shape[:-1],
                               c - pseudo_boxes.shape[-1])
            pseudo = torch.cat([pseudo_boxes[..., :-1], pad,
                                pseudo_boxes[..., -1:]], dim=-1)
        return torch.cat([gt, pseudo.to(gt.dtype)], dim=1)

    def compute_loss(self, out_batch):
        if out_batch.get("pseudo_boxes") is not None:
            out_batch = dict(out_batch)
            out_batch["gt_boxes"] = self.merge_pseudos(
                out_batch["gt_boxes"], out_batch["pseudo_boxes"])
        return self.loss(out_batch)

    def loss(self, batch, targets=None):
        """(total loss, tb dict of 0-d tensors)."""
        res = batch["transfusion_preds"]
        lw_cfg = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        loss_cls_cfg = self.model_cfg["LOSS_CONFIG"]["LOSS_CLS"]
        if targets is None:
            targets = self.get_targets(res, batch["gt_boxes"])

        hm_pred = L.clip_sigmoid(res["dense_heatmap"])
        hm_tgt = targets["heatmap"]
        # both normalisers count over the (global) batch
        hm_peaks, num_pos = all_sum((hm_tgt == 1.0).sum().float(),
                                    targets["num_pos"])
        loss_hm = L.gaussian_focal_loss(hm_pred, hm_tgt).sum() / torch.clamp(
            hm_peaks, min=1.0)

        labels = targets["labels"].reshape(-1)
        label_weights = targets["label_weights"].reshape(-1)
        num_pos = torch.clamp(num_pos, min=1)

        if self.unknown_labels and "unknown_cls_weight" in lw_cfg:
            unk = targets["unknown_mask"].reshape(-1)
            label_weights = torch.where(
                unk, label_weights * float(lw_cfg["unknown_cls_weight"]),
                label_weights)

        cls_score = res["heatmap"].reshape(-1, self.num_classes)
        one_hot = F.one_hot(labels, self.num_classes + 1)[..., :-1].to(
            cls_score.dtype)
        loss_cls = L.sigmoid_focal_loss(
            cls_score, one_hot, label_weights,
            gamma=float(loss_cls_cfg.get("gamma", 2.0)),
            alpha=float(loss_cls_cfg.get("alpha", 0.25))).sum() / num_pos

        head_order = [k for k in ("center", "height", "dim", "rot", "vel")
                      if k in res]
        preds = torch.cat([res[k] for k in head_order], dim=-1)
        code_weights = torch.tensor(lw_cfg["code_weights"],
                                    dtype=torch.float32, device=preds.device)
        reg_weights = targets["bbox_weights"] * code_weights
        if self.unknown_labels and "unknown_code_weights" in lw_cfg:
            ucw = torch.tensor(lw_cfg["unknown_code_weights"],
                               dtype=torch.float32, device=preds.device)
            reg_weights = torch.where(targets["unknown_mask"][..., None],
                                      reg_weights * ucw, reg_weights)
        loss_bbox = ((preds - targets["bbox_targets"]).abs()
                     * reg_weights).sum() / num_pos

        total = (loss_hm * float(lw_cfg["hm_weight"])
                 + loss_cls * float(lw_cfg["cls_weight"])
                 + loss_bbox * float(lw_cfg["bbox_weight"]))
        matched = labels < self.num_classes
        ious_flat = targets["ious"].reshape(-1)
        zero = torch.zeros(()).to(ious_flat)
        with torch.no_grad():
            # tb entries are this process's share of the global batch's
            # value (runtime/trainer.py sums them): local sums over the
            # global counts
            per_class = [matched & (labels == ci)
                         for ci in range(len(self.class_names or ()))]
            counts = all_sum(torch.stack(
                [matched.sum()] + [cm.sum() for cm in per_class]))
            tb = {
                "loss_heatmap": loss_hm * float(lw_cfg["hm_weight"]),
                "loss_cls": loss_cls * float(lw_cfg["cls_weight"]),
                "loss_bbox": loss_bbox * float(lw_cfg["bbox_weight"]),
                "matched_ious": torch.where(matched, ious_flat, zero).sum()
                / torch.clamp(counts[0], min=1),
                "loss_trans": total.detach(),
            }
            if self.class_names:
                probs = torch.sigmoid(cls_score)
                for ci, name in enumerate(self.class_names):
                    cm = per_class[ci]
                    n = cm.sum()
                    nc = torch.clamp(counts[ci + 1], min=1)
                    tb[f"{name}_matches"] = n
                    tb[f"{name}_iou_mean"] = torch.where(
                        cm, ious_flat, zero).sum() / nc
                    tb[f"{name}_tp_pred_conf_mean"] = torch.where(
                        cm, probs[:, ci], zero).sum() / nc
        return total, tb

    def get_bboxes(self, res, max_det: int = 200):
        """Final detections with max_det fixed slots (labels 1-indexed)."""
        pp = self.model_cfg["POST_PROCESSING"]
        score_thresh = float(pp.get("SCORE_THRESH", 0.0))
        post_range = torch.tensor(pp["POST_CENTER_RANGE"],
                                  dtype=torch.float32,
                                  device=res["heatmap"].device)
        prob = torch.sigmoid(res["heatmap"])
        one_hot = F.one_hot(res["query_labels"].long(), self.num_classes)
        prob = prob * res["query_heatmap_score"] * one_hot
        boxes = self.decode_boxes(res)
        scores = prob.amax(dim=-1)
        labels = torch.argmax(prob, dim=-1)
        mask = ((scores > score_thresh)
                & (boxes[..., :3] >= post_range[:3]).all(-1)
                & (boxes[..., :3] <= post_range[3:]).all(-1))
        k = min(max_det, boxes.shape[1])
        s = torch.where(mask, scores, torch.full_like(scores, -1.0))
        top_s, idx = top_k_lower_index_first(s, k)
        good = top_s > 0
        out_boxes = torch.gather(
            boxes, 1, idx[..., None].expand(-1, -1, boxes.shape[-1]))
        out_boxes = torch.where(good[..., None], out_boxes,
                                torch.zeros_like(out_boxes))
        out_labels = torch.where(good, torch.gather(labels, 1, idx) + 1,
                                 torch.zeros_like(idx))
        return Detections(out_boxes, torch.where(good, top_s,
                                                 torch.zeros_like(top_s)),
                          out_labels.to(torch.int32),
                          good.sum(dim=1).to(torch.int32))
