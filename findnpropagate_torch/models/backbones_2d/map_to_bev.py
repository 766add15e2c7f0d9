"""HeightCompression — port of
findnpropagate_tpu/models/backbones_2d/map_to_bev.py:55-73.

Folds z into channels: (B, C, nz, ny, nx) -> (B, nz*C, ny, nx), channel
index z*C + c as in the reference's (B, ny, nx, nz*C).
"""

from __future__ import annotations

from torch import nn


class HeightCompression(nn.Module):
    def __init__(self, model_cfg):
        super().__init__()
        self.num_bev_features = int(model_cfg["NUM_BEV_FEATURES"])

    def forward(self, batch):
        dense = batch["encoded_spconv_tensor"]
        b, c, nz, ny, nx = dense.shape
        batch["spatial_features"] = dense.permute(0, 2, 1, 3, 4).reshape(
            b, nz * c, ny, nx)
        batch["spatial_features_stride"] = batch.get(
            "encoded_spconv_tensor_stride", 8)
        return batch
