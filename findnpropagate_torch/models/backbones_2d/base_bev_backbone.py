"""BaseBEVBackbone — port of
findnpropagate_tpu/models/backbones_2d/base_bev_backbone.py:17-85, eval.

Per level: a (strided) ConvBNReLU plus LAYER_NUMS[i] ConvBNReLUs, then a
DeconvBNReLU back to a common stride; the levels concatenate on channels.
NCHW, float32. Not ported (no TransFusion config uses them): the optional
bf16 ``DTYPE``, levels without upsampling, strides < 1 and deblock_extra.
"""

from __future__ import annotations

import torch
from torch import nn

from ..blocks import ConvBNReLU, DeconvBNReLU


class BaseBEVBackbone(nn.Module):
    def __init__(self, model_cfg, input_channels):
        super().__init__()
        cfg = model_cfg
        layer_nums = cfg.get("LAYER_NUMS", []) or []
        layer_strides = cfg.get("LAYER_STRIDES", []) or []
        num_filters = cfg.get("NUM_FILTERS", []) or []
        ups = cfg.get("UPSAMPLE_STRIDES", []) or []
        num_up = cfg.get("NUM_UPSAMPLE_FILTERS", []) or []
        if len(ups) != len(layer_nums) or any(float(u) < 1 for u in ups):
            raise NotImplementedError(
                "BaseBEVBackbone: one upsample stride >= 1 per level only")
        self.layer_nums = [int(n) for n in layer_nums]
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
            self.add_module(f"deblock{i}", DeconvBNReLU(
                int(f), int(num_up[i]), stride=int(ups[i])))
            c_in = int(f)
        self.num_bev_features = sum(int(u) for u in num_up)

    def forward(self, batch):
        x = batch["spatial_features"]
        outs = []
        for i, n in enumerate(self.layer_nums):
            x = getattr(self, f"block{i}_down")(x)
            for k in range(n):
                x = getattr(self, f"block{i}_conv{k}")(x)
            batch[f"spatial_features_{self.strides[i]}x"] = x
            outs.append(getattr(self, f"deblock{i}")(x))
        x = torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]
        batch["spatial_features_2d"] = x.float()
        return batch
