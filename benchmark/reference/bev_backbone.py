"""Frozen copy of the port's findnpropagate_torch/models/backbones_2d/base_bev_backbone.py, kept under the
benchmark so that a change to the program cannot move the yardstick.

BaseBEVBackbone (BaseBEVBackboneV1 left out) — port of
findnpropagate_tpu/models/backbones_2d/base_bev_backbone.py:17-120.

Per level: a (strided) ConvBNReLU plus LAYER_NUMS[i] ConvBNReLUs, then a
DeconvBNReLU to a common stride (an upsample for UPSAMPLE_STRIDES >= 1, a
strided conv for strides < 1; the level itself where no upsample strides
are given); the levels concatenate on channels, and a last upsample stride
beyond the levels' adds one more DeconvBNReLU (``deblock_extra``). NCHW;
float32, or bf16 at eval under ``DTYPE: bf16`` (weights and BN statistics
stay float32), with the output cast back to float32.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import ConvBNReLU, DeconvBNReLU


class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels):
        super().__init__()
        cfg = model_cfg
        layer_nums = cfg.get("LAYER_NUMS", []) or []
        layer_strides = cfg.get("LAYER_STRIDES", []) or []
        num_filters = cfg.get("NUM_FILTERS", []) or []
        ups = cfg.get("UPSAMPLE_STRIDES", []) or []
        num_up = cfg.get("NUM_UPSAMPLE_FILTERS", []) or []
        self.bf16 = str(cfg.get("DTYPE", "f32")).lower() in ("bf16",
                                                              "bfloat16")
        self.layer_nums = [int(n) for n in layer_nums]
        self.upsample = bool(ups)
        self.strides = []
        c_in = int(input_channels)
        stride = 1
        for i, (n, s, f) in enumerate(zip(layer_nums, layer_strides,
                                          num_filters)):
            self.add_module(f"block{i}_down",
                            ConvBNReLU(c_in, int(f), int(s)))
            for k in range(int(n)):
                self.add_module(f"block{i}_conv{k}",
                                ConvBNReLU(int(f), int(f)))
            stride *= int(s)
            self.strides.append(stride)
            if ups:
                self.add_module(f"deblock{i}", DeconvBNReLU(
                    int(f), int(num_up[i]), stride=ups[i]))
            c_in = int(f)
        self.num_bev_features = sum(int(u) for u in num_up) if num_up \
            else int((num_filters or [input_channels])[-1])
        if len(ups) > len(layer_nums):
            self.deblock_extra = DeconvBNReLU(
                self.num_bev_features, self.num_bev_features,
                stride=ups[-1])

    def forward(self, batch):
        x = batch["spatial_features"]
        if self.bf16 and not self.training:
            x = x.to(torch.bfloat16)
        outs = []
        for i, n in enumerate(self.layer_nums):
            x = getattr(self, f"block{i}_down")(x)
            for k in range(n):
                x = getattr(self, f"block{i}_conv{k}")(x)
            batch[f"spatial_features_{self.strides[i]}x"] = x
            outs.append(getattr(self, f"deblock{i}")(x) if self.upsample
                        else x)
        x = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
        if hasattr(self, "deblock_extra"):
            x = self.deblock_extra(x)
        batch["spatial_features_2d"] = x.float()
        return batch
