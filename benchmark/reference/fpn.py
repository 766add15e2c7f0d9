"""Frozen copy of the port's findnpropagate_torch/models/backbones_image/fpn.py, kept under the
benchmark so that a change to the program cannot move the yardstick.

GeneralizedLSSFPN image neck — port of
findnpropagate_tpu/models/backbones_image/fpn.py:18-50.

Top-down over the backbone's maps (NCHW): level i concatenates its map
with the output of level i + 1 resized to its size (nearest, half-pixel
centres as jax.image.resize: torch's "nearest-exact"), then a 1x1 lateral
conv + BN + ReLU and a 3x3 conv + BN + ReLU, both without bias, each BN
flax's (eps 1e-5). ``image_fpn`` holds every level's output. The input
widths are the backbone's (`in_channels`, else the yaml's IN_CHANNELS).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm2d

BN_EPS = 1e-5      # flax nn.BatchNorm's


class GeneralizedLSSFPN(nn.Module):
    def __init__(self, model_cfg, in_channels=None):
        super().__init__()
        cfg = model_cfg
        ins = [int(c) for c in (in_channels or cfg["IN_CHANNELS"])]
        out = int(cfg.get("OUT_CHANNELS", 256))
        self.num_levels = n = len(ins)
        self.out_channels = out
        for i in range(n):
            cin = ins[i] + (out if i < n - 1 else 0)
            self.add_module(f"lateral{i}", nn.Conv2d(cin, out, 1, bias=False))
            self.add_module(f"lateral{i}_bn", BatchNorm2d(out, eps=BN_EPS))
            self.add_module(f"fpn{i}", nn.Conv2d(out, out, 3, padding=1,
                                                 bias=False))
            self.add_module(f"fpn{i}_bn", BatchNorm2d(out, eps=BN_EPS))

    def forward(self, batch):
        feats = list(batch["image_features"])
        n = len(feats)
        outs = [None] * n
        prev = None
        for i in range(n - 1, -1, -1):
            x = feats[i]
            if prev is not None:
                up = F.interpolate(prev, size=tuple(x.shape[-2:]),
                                   mode="nearest-exact")
                x = torch.cat([x, up], dim=1)
            x = torch.relu(getattr(self, f"lateral{i}_bn")(
                getattr(self, f"lateral{i}")(x)))
            prev = outs[i] = torch.relu(getattr(self, f"fpn{i}_bn")(
                getattr(self, f"fpn{i}")(x)))
        batch["image_fpn"] = outs
        return batch
