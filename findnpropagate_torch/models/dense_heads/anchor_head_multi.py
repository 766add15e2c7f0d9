"""AnchorHeadMulti, the grouped anchor head — port of
findnpropagate_tpu/models/dense_heads/anchor_head_multi.py (:29-145).

A shared 3x3 conv + BN + ReLU (``shared_conv``, ``shared_bn``) feeds one
head per RPN_HEAD_CFGS group: NUM_MIDDLE_CONV 3x3 conv + BN + ReLU layers
(``h{i}_mid{j}``, ``h{i}_mid{j}_bn``) and 1x1 branches (``h{i}_cls``,
``h{i}_box``, ``h{i}_dir``) over the anchor slots of the group's classes.
Each head's logits go into one (B, N_anchors, num_class) tensor whose
off-head class columns hold NEG_FILL (sigmoid ~2e-9: no gradient, never
the argmax), so AnchorHeadSingle's tools (assignment, loss) and decode
apply unchanged. The BNs are flax's defaults (eps 1e-5, momentum 0.99).
The yamls' SEPARATE_REG_CONFIG, USE_MULTIHEAD and SEPARATE_MULTIHEAD are
not read (the reference's docstring claims SEPARATE_REG_CONFIG branches its
code does not have), and the coder ignores encode_angle_by_sincos.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..blocks import BatchNorm2d
from .anchor_head import decode_into, head_coder, make_anchor_head_tools

NEG_FILL = -20.0
BN_EPS = 1e-5            # flax nn.BatchNorm's default


def _conv_bn(cin, cout):
    return nn.Conv2d(cin, cout, 3, 1, 1, bias=False), \
        BatchNorm2d(cout, eps=BN_EPS)


class AnchorHeadMulti(nn.Module):
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
        self.box_coder = head_coder(cfg, sincos=False)
        code = self.box_coder.full_code_size
        self.use_dir = bool(cfg.get("USE_DIRECTION_CLASSIFIER", False))
        self.n_dir = int(cfg.get("NUM_DIR_BINS", 2))
        self.num_middle = int(cfg.get("NUM_MIDDLE_CONV", 1))
        shared = int(cfg.get("SHARED_CONV_NUM_FILTER", 64))
        self.shared_conv, self.shared_bn = _conv_bn(input_channels, shared)
        names = list(class_names)
        class_slots = self.tools.class_slots
        self.groups, self.slots = [], []
        for hi, rpn_cfg in enumerate(cfg["RPN_HEAD_CFGS"]):
            group = [names.index(n) for n in rpn_cfg["HEAD_CLS_NAME"]]
            slots = np.where(np.isin(class_slots, group))[0]
            self.groups.append(group)
            self.slots.append(slots)
            for li in range(self.num_middle):
                conv, bn = _conv_bn(shared, shared)
                self.add_module(f"h{hi}_mid{li}", conv)
                self.add_module(f"h{hi}_mid{li}_bn", bn)
            conv_cls = nn.Conv2d(shared, len(slots) * len(group), 1)
            nn.init.constant_(conv_cls.bias, -math.log((1 - 0.01) / 0.01))
            self.add_module(f"h{hi}_cls", conv_cls)
            conv_box = nn.Conv2d(shared, len(slots) * code, 1)
            nn.init.normal_(conv_box.weight, std=0.001)
            self.add_module(f"h{hi}_box", conv_box)
            if self.use_dir:
                self.add_module(f"h{hi}_dir", nn.Conv2d(
                    shared, len(slots) * self.n_dir, 1))

    def forward(self, batch, generator=None):
        x = batch["spatial_features_2d"]          # (B, C, H, W)
        b, _, h, w = x.shape
        x = torch.relu(self.shared_bn(self.shared_conv(x)))
        code = self.box_coder.full_code_size
        a = len(self.tools.class_slots)
        cls_full = x.new_full((b, h * w, a, self.num_class), NEG_FILL)
        box_full = x.new_zeros(b, h * w, a, code)
        dir_full = x.new_zeros(b, h * w, a, self.n_dir) if self.use_dir \
            else None

        def rows(t, n_slots):
            return t.permute(0, 2, 3, 1).reshape(b, h * w, n_slots, -1)

        for hi, (group, slots) in enumerate(zip(self.groups, self.slots)):
            y = x
            for li in range(self.num_middle):
                y = torch.relu(getattr(self, f"h{hi}_mid{li}_bn")(
                    getattr(self, f"h{hi}_mid{li}")(y)))
            s = torch.as_tensor(slots, device=x.device)
            g = torch.as_tensor(group, device=x.device)
            cls_full[:, :, s[:, None], g[None, :]] = rows(
                getattr(self, f"h{hi}_cls")(y), len(slots))
            box_full[:, :, s] = rows(getattr(self, f"h{hi}_box")(y),
                                     len(slots))
            if self.use_dir:
                dir_full[:, :, s] = rows(getattr(self, f"h{hi}_dir")(y),
                                         len(slots))
        batch["cls_preds"] = cls_full.reshape(b, -1, self.num_class)
        batch["box_preds"] = box_full.reshape(b, -1, code)
        dir_preds = None
        if self.use_dir:
            dir_preds = dir_full.reshape(b, -1, self.n_dir)
            batch["dir_cls_preds"] = dir_preds
        return decode_into(self, batch, dir_preds)

    def compute_loss(self, out_batch):
        return self.tools.compute_loss(out_batch)
