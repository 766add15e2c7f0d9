"""TransFusionHead at eval — a frozen copy of the port's
findnpropagate_torch/models/dense_heads/transfusion_head.py (forward,
`decode_boxes`, `get_bboxes`; the training targets and loss left out),
kept under the benchmark so that a change to the program cannot move the
yardstick.

Shared conv -> class heatmap -> 3x3 local-max query selection (kernel 1
for the small nuScenes classes) -> top NUM_PROPOSALS over (class, cell) ->
class embedding -> one transformer decoder layer over the flattened BEV ->
per-query regression heads; decode with the heatmap-score blend. Ties in
both top-k's go to the lower index. `forward` also takes the queries as
given (`queries`: (class, cell) per query), so the reference can run the
decoder on another side's picks and judge them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from typing import NamedTuple

from .blocks import BN_EPS, BatchNorm1d, BatchNorm2d
from .transformer import TransformerDecoderLayer


class Detections(NamedTuple):
    boxes: torch.Tensor   # (B, D, 7+C)
    scores: torch.Tensor  # (B, D)
    labels: torch.Tensor  # (B, D) int32, 1-indexed; 0 for empty slots
    count: torch.Tensor   # (B,) int32


def top_k_lower_index_first(x, k: int):
    """(values, indices) of the k largest entries along the last axis, ties
    broken by the lower index first (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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

    def forward(self, batch, generator=None, queries=None):
        """queries: None (the head picks its own), or (query_class,
        query_index), each (B, NUM_PROPOSALS) int64, to decode another
        side's picks."""
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
        if queries is None:
            _, top = top_k_lower_index_first(heatmap.reshape(b, -1),
                                             self.num_proposals)
            query_class = top // (h * w)
            query_index = top % (h * w)
        else:
            query_class, query_index = (q.long() for q in queries)
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
        res["query_index"] = query_index
        res["heatmap_suppressed"] = heatmap
        res["heatmap_sigmoid"] = torch.sigmoid(dense_heatmap)
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
