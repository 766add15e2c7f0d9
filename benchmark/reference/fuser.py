"""Frozen copy of the port's findnpropagate_torch/models/backbones_2d/fuser.py, kept under the
benchmark so that a change to the program cannot move the yardstick.

ConvFuser, BEVFusion's camera + lidar BEV fusion — port of
findnpropagate_tpu/models/backbones_2d/fuser.py:16-37.

The lidar BEV (``spatial_features``) and the camera BEV
(``spatial_features_img``, first resized to the lidar grid where the two
differ: bilinear with half-pixel centres, antialiased where it shrinks, as
jax.image.resize) concatenate on channels in that order, then a 3x3 conv
without bias, BN (flax's, eps 1e-5) and ReLU. NCHW.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .blocks import BatchNorm2d

BN_EPS = 1e-5      # flax nn.BatchNorm's


def resize_bilinear(x, size):
    """(B, C, H, W) -> (B, C, *size) as jax.image.resize(..., "bilinear")."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    shrink = size[0] < x.shape[-2] or size[1] < x.shape[-1]
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=shrink)


class ConvFuser(nn.Module):
    def __init__(self, model_cfg, in_channels=None):
        super().__init__()
        out = int(model_cfg["OUT_CHANNEL"])
        cin = int(in_channels or model_cfg["IN_CHANNEL"])
        self.num_bev_features = out
        self.Conv_0 = nn.Conv2d(cin, out, 3, padding=1, bias=False)
        self.BatchNorm_0 = BatchNorm2d(out, eps=BN_EPS)

    def forward(self, batch):
        lidar = batch["spatial_features"]
        img = resize_bilinear(batch["spatial_features_img"],
                              lidar.shape[-2:])
        x = torch.cat([lidar, img.to(lidar.dtype)], dim=1)
        batch["spatial_features"] = torch.relu(self.BatchNorm_0(
            self.Conv_0(x)))
        return batch

