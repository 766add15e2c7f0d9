"""TransFusionHeadAM, the paper's anchor-matching TransFusion head — port
of findnpropagate_tpu/models/dense_heads/transfusion_head_am.py
(`DEFAULT_ANCHORS` :38, `hard_bin_vectors` :51, `TransFusionHeadAM`
:63-207).

The class space is the table of anchor sizes (ANCHOR_SIZES, the nuScenes
mean sizes by default): each class is the hard-binned vector of its log
(l, w, h) — per dimension the steps (value > edge) against the
ANCHOR_SIZE_BINS quantiles of all the log sizes. The dense head predicts a
3 * bins embedding per BEV cell, matched to the anchors' normalised vectors
by cosine similarity with a learned scale (exp) and bias
(``dense_match_scale`` / ``dense_match_bias``); the queries' class
embedding is a linear encoding of the matched anchor's vector
(``anchor_query_encoding``), and the per-query heatmap branch predicts an
embedding matched the same way (``logit_scale`` / ``logit_bias``).
Targets, loss and decode are TransFusionHead's over that class space, as
in the reference. Maps are NCHW.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..post_processing import top_k_lower_index_first
from .transfusion_head import SeparateHead, TransFusionHead

DEFAULT_ANCHORS = (
    (4.63, 1.97, 1.74),
    (6.93, 2.51, 2.84),
    (6.37, 2.85, 3.19),
    (10.5, 2.94, 3.47),
    (12.29, 2.90, 3.87),
    (0.50, 2.53, 0.98),
    (2.11, 0.77, 1.47),
    (1.70, 0.60, 1.28),
    (0.73, 0.67, 1.77),
    (0.41, 0.41, 1.07),
)


def hard_bin_vectors(log_anchors, num_bins: int):
    """(C, 3) log anchor sizes -> (C, 3 * num_bins) float32 {0, 1}: the bin
    edges are the num_bins quantiles of all the log sizes, and each
    (class, dimension) gives its steps value > edge."""
    qs = np.linspace(0.0, 1.0, num_bins)
    values = np.quantile(log_anchors.reshape(-1), qs)
    v = (log_anchors[:, :, None] - values[None, None, :]) > 0
    return v.reshape(log_anchors.shape[0], -1).astype(np.float32)


class TransFusionHeadAM(TransFusionHead):
    # own parameters that are leaves of the flax tree (utils/weights.py)
    FLAX_LEAVES = ("dense_match_bias", "dense_match_scale", "logit_scale",
                   "logit_bias")

    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 point_cloud_range, voxel_size, grid_size):
        anchors = np.asarray(model_cfg.get("ANCHOR_SIZES", DEFAULT_ANCHORS),
                             np.float32)
        cfg = dict(model_cfg)
        cfg["NUM_CLASSES"] = anchors.shape[0]
        super().__init__(cfg, input_channels, anchors.shape[0], class_names,
                         point_cloud_range, voxel_size, grid_size)
        self.model_cfg = model_cfg
        bins = int(model_cfg.get("ANCHOR_SIZE_BINS", 20))
        self.text_dim = anchors.shape[1] * bins
        vecs = hard_bin_vectors(np.log(anchors), bins)
        self.register_buffer("anchor_vecs", torch.from_numpy(vecs),
                             persistent=False)
        self.register_buffer("anchor_vecs_normed", torch.from_numpy(
            vecs / (1e-8 + np.linalg.norm(vecs, axis=1, keepdims=True))),
            persistent=False)
        h = self.hidden
        self.hm_out = nn.Conv2d(h, self.text_dim, 3, padding=1)
        del self.class_encoding
        self.anchor_query_encoding = nn.Linear(self.text_dim, h)
        heads = dict(model_cfg["SEPARATE_HEAD_CFG"]["HEAD_DICT"])
        heads["heatmap"] = {"out_channels": self.text_dim,
                            "num_conv": int(model_cfg.get("NUM_HM_CONV", 2))}
        self.prediction_head = SeparateHead(heads, h, use_bias=bool(
            model_cfg.get("USE_BIAS_BEFORE_NORM", False)))
        self.dense_match_bias = nn.Parameter(torch.full((1,), -10.0))
        self.dense_match_scale = nn.Parameter(torch.full((1,), float(
            np.log(10.0))))
        self.logit_scale = nn.Parameter(torch.full((1,), float(
            np.log(1 / 0.07))))
        self.logit_bias = nn.Parameter(torch.full((1,), -10.0))

    def _match(self, emb, scale, bias):
        """Cosine match of embeddings (..., text_dim) against the anchor
        vectors -> (..., C) logits."""
        emb = emb / (1e-8 + torch.linalg.norm(emb, dim=-1, keepdim=True))
        return emb @ self.anchor_vecs_normed.T * torch.exp(scale) + bias

    def _flat_kernel1_classes(self):
        if self.dataset_name == "nuScenes" and self.num_classes == 10:
            return (8, 9)
        if self.dataset_name == "Waymo":
            return (1, 2)
        return ()

    def forward(self, batch, generator=None):
        feats = batch["spatial_features_2d"]            # (B, Cin, H, W)
        b, _, h, w = feats.shape
        lidar_feat = self.shared_conv(feats)
        lidar_flat = lidar_feat.flatten(2).transpose(1, 2)
        hm = torch.relu(self.hm_block_bn(self.hm_block_conv(lidar_feat)))
        emb = self.hm_out(hm).permute(0, 2, 3, 1)       # (B, H, W, D)
        dense_heatmap = self._match(emb, self.dense_match_scale,
                                    self.dense_match_bias).permute(0, 3, 1, 2)

        heatmap = torch.sigmoid(dense_heatmap.detach())
        pad = self.nms_kernel_size // 2
        inner = F.max_pool2d(heatmap, self.nms_kernel_size, stride=1)
        local_max = F.pad(inner, (pad, pad, pad, pad))
        for ci in self._flat_kernel1_classes():
            local_max[:, ci] = heatmap[:, ci]
        heatmap = heatmap * (heatmap == local_max)

        _, top = top_k_lower_index_first(heatmap.reshape(b, -1),
                                         self.num_proposals)
        query_class = top // (h * w)
        query_index = top % (h * w)
        query_feat = torch.gather(
            lidar_flat, 1, query_index[..., None].expand(-1, -1, self.hidden))
        query_feat = query_feat + self.anchor_query_encoding(
            self.anchor_vecs[query_class])

        ys = (query_index // w).float() + 0.5
        xs = (query_index % w).float() + 0.5
        query_pos = torch.stack([xs, ys], dim=-1)
        yy, xx = torch.meshgrid(torch.arange(h, device=feats.device),
                                torch.arange(w, device=feats.device),
                                indexing="ij")
        bev_pos = torch.stack([xx.reshape(-1) + 0.5, yy.reshape(-1) + 0.5],
                              dim=-1).float()[None].expand(b, -1, -1)
        query_feat = self.decoder(query_feat, lidar_flat, query_pos, bev_pos,
                                  generator)
        res = self.prediction_head(query_feat)
        res["heatmap"] = self._match(res["heatmap"], self.logit_scale,
                                     self.logit_bias)
        res["center"] = res["center"] + query_pos
        res["query_heatmap_score"] = torch.gather(
            heatmap.reshape(b, self.num_classes, h * w), 2,
            query_index[:, None, :].expand(-1, self.num_classes, -1)
        ).transpose(1, 2)
        res["dense_heatmap"] = dense_heatmap
        res["query_labels"] = query_class.to(torch.int32)
        batch["transfusion_preds"] = res
        return batch
