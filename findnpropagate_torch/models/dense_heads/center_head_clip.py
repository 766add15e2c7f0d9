"""CenterHeadCLIP, the open-vocabulary CenterPoint head — port of
findnpropagate_tpu/models/dense_heads/center_head_clip.py (`CenterHeadCLIP`
:34-63, `CenterHeadCLIPTools` :66-182, `make_center_head_clip_tools`
:185-203).

A class-agnostic heatmap (one channel) beside an EMBED_DIM-wide embedding
branch; a box's class is the best match of its embedding against the class
text features. Training adds the cross-entropy of the embedding logits at
the ground truths' centre cells against their classes. The reference builds
the head inside ``@nn.compact``, so its submodules carry flax's automatic
names (``Conv_0``, ``BatchNorm_0``, ``clip_head``) and its BatchNorm
flax's default eps of 1e-5; the port names them the same, so that
utils/weights.py maps them. The text features are an argument; without one
they are the reference's deterministic placeholder,
``RandomState(0).standard_normal((num_class, EMBED_DIM))`` normalised, a
buffer outside the state dict (the real ones come from the CLIP text tower,
whose weights are not in the repository).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..blocks import BatchNorm2d
from .center_head import CenterHead, _gather_rows, _nms_detections
from .transfusion_head import SeparateHead


def placeholder_text_features(num_class, embed_dim):
    """The reference's stand-in class text features (num_class, E)."""
    t = np.random.RandomState(0).standard_normal(
        (num_class, embed_dim)).astype(np.float32)
    return t / np.linalg.norm(t, axis=-1, keepdims=True)


class CenterHeadCLIP(CenterHead):
    bn_eps = 1e-5          # flax's BatchNorm default
    logit_scale = 100.0

    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 point_cloud_range, voxel_size, grid_size,
                 predict_boxes_when_training=False, text_features=None):
        self.embed_dim = int(model_cfg.get("EMBED_DIM", 512))
        super().__init__(model_cfg, input_channels, num_class, class_names,
                         point_cloud_range, voxel_size, grid_size,
                         predict_boxes_when_training)
        if text_features is None:
            text_features = placeholder_text_features(num_class,
                                                      self.embed_dim)
        self.register_buffer("text_features", torch.as_tensor(
            np.asarray(text_features, np.float32)), persistent=False)

    def _build(self, input_channels):
        self.Conv_0 = nn.Conv2d(input_channels, self.shared_ch, 3, padding=1,
                                bias=self.use_bias)
        self.BatchNorm_0 = BatchNorm2d(self.shared_ch, eps=self.bn_eps)
        heads = self._head_dict(1)
        heads["emb"] = {"out_channels": self.embed_dim, "num_conv": 2}
        self.clip_head = SeparateHead(heads, self.shared_ch, self.shared_ch,
                                      use_bias=self.use_bias)

    def forward(self, batch, generator=None):
        """generator: unused (the head has no dropout)."""
        x = torch.relu(self.BatchNorm_0(self.Conv_0(
            batch["spatial_features_2d"])))
        b, c, h, w = x.shape
        preds = self.clip_head(x.flatten(2).transpose(1, 2))
        batch["center_clip_preds"] = {k: v.reshape(b, h, w, -1)
                                      for k, v in preds.items()}
        return batch

    def _sim_logits(self, emb):
        """(..., E) embeddings -> (..., C) scaled cosine logits."""
        emb = emb / (torch.linalg.norm(emb, dim=-1, keepdim=True) + 1e-8)
        return self.logit_scale * emb @ self.text_features.T

    def compute_loss(self, out_batch):
        """(total loss, tb dict of 0-d tensors): agnostic heatmap focal
        loss, regression L1 and the embedding cross-entropy."""
        preds = out_batch["center_clip_preds"]
        lw = self.model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        gt = out_batch["gt_boxes"]
        agn = torch.cat([gt[..., :-1], (gt[..., -1:] > 0).to(gt.dtype)], -1)
        heatmaps, target_boxes, inds, masks = self.assign(agn,
                                                          num_classes=1)
        hm_loss = self._hm_loss(preds["hm"], heatmaps, lw)
        loc_loss = self._reg_loss(preds, target_boxes, inds, masks, lw)
        b, h, w, _ = preds["emb"].shape
        logits = self._sim_logits(_gather_rows(
            preds["emb"].reshape(b, h * w, -1), inds))     # (B, M, C)
        labels = torch.clamp(gt[..., -1].to(torch.int64) - 1, min=0)
        ce = -torch.gather(F.log_softmax(logits, dim=-1), -1,
                           labels[..., None])[..., 0]
        m = masks.to(torch.float32)
        emb_loss = (ce * m).sum() / torch.clamp(m.sum(), min=1.0) \
            * float(lw.get("emb_weight", 1.0))
        total = hm_loss + loc_loss + emb_loss
        return total, {"hm_loss": hm_loss.detach(),
                       "loc_loss": loc_loss.detach(),
                       "emb_loss": emb_loss.detach(),
                       "rpn_loss": total.detach()}

    @torch.no_grad()
    def get_bboxes(self, out_batch, max_obj: int = 100):
        """Final detections: the agnostic top-k, classed by the embedding's
        text similarity, scored by heatmap score times that similarity."""
        preds = out_batch["center_clip_preds"]
        pp, score_thresh, post_range = self._post(preds["hm"].device)
        k = int(pp.get("MAX_OBJ_PER_SAMPLE", max_obj))
        scores, _, flat, boxes = self._decode_top(
            preds, k, ["center", "center_z", "dim", "rot"])
        b, h, w, _ = preds["emb"].shape
        sim = torch.softmax(self._sim_logits(_gather_rows(
            preds["emb"].reshape(b, h * w, -1), flat)), dim=-1)
        best, labels = sim.amax(dim=-1), torch.argmax(sim, dim=-1)
        ok = self._in_range(scores, boxes, score_thresh, post_range)
        final = torch.where(ok, scores * best, torch.zeros_like(scores))
        return _nms_detections(boxes, final, (labels + 1).to(torch.int32),
                               ok, pp.get("NMS_CONFIG", {}), 0.2, k, 83)
