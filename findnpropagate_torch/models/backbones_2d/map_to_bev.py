"""Sparse -> dense BEV projections — port of
findnpropagate_tpu/models/backbones_2d/map_to_bev.py
(`PointPillarScatter` :21-52, `HeightCompression` :55-73,
`Conv2DCollapse` :75-96).

PointPillarScatter writes each kept pillar's features into its (y, x)
cell of a zero canvas, one batched scatter with a dummy row for the
padding; HeightCompression folds z into channels: (B, C, nz, ny, nx) ->
(B, nz*C, ny, nx), channel index z*C + c as in the reference's
(B, ny, nx, nz*C). Both give the NCHW `spatial_features` the port's
BaseBEVBackbone reads (the reference's are NHWC).
"""

from __future__ import annotations

import torch
from torch import nn

from ..blocks import BatchNorm2d


class PointPillarScatter(nn.Module):
    def __init__(self, model_cfg, grid_size=()):
        super().__init__()
        self.num_bev_features = int(model_cfg["NUM_BEV_FEATURES"])
        self.nx, self.ny, nz = (int(g) for g in grid_size)
        if nz != 1:
            raise ValueError(f"PointPillarScatter needs nz == 1, not {nz}")

    def forward(self, batch):
        feats = batch["pillar_features"]          # (B, V, C)
        coords = batch["voxel_coords"]            # (B, V, 3) zyx, -1 pad
        mask = batch["voxel_mask"]                # (B, V)
        b, v, c = feats.shape
        cells = self.ny * self.nx
        flat = (coords[..., 1] * self.nx + coords[..., 2]).long()
        flat = flat.masked_fill(~mask, cells)     # the dummy row
        feats = feats.masked_fill(~mask[..., None], 0.0)
        canvas = feats.new_zeros(b, c, cells + 1).scatter(
            2, flat[:, None, :].expand(b, c, v), feats.transpose(1, 2))
        batch["spatial_features"] = canvas[..., :cells].reshape(
            b, c, self.ny, self.nx)
        return batch


class HeightCompression(nn.Module):
    def __init__(self, model_cfg, grid_size=()):
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


class Conv2DCollapse(nn.Module):
    """CaDDN's z-collapse (:75-96): the dense camera volume
    ``voxel_features_dense`` (B, C, nz, ny, nx) folds z into channels as
    z * C + c (the reference's (z, c) order), then a 1x1 conv without
    bias, BN (flax's, eps 1e-5) and ReLU to NUM_BEV_FEATURES. Its input
    width is the VFE's C times the grid's nz."""

    def __init__(self, model_cfg, grid_size, in_channels):
        super().__init__()
        self.num_bev_features = int(model_cfg["NUM_BEV_FEATURES"])
        self.Conv_0 = nn.Conv2d(int(in_channels) * int(grid_size[2]),
                                self.num_bev_features, 1, bias=False)
        self.BatchNorm_0 = BatchNorm2d(self.num_bev_features, eps=1e-5)

    def forward(self, batch):
        dense = batch["voxel_features_dense"]
        b, c, nz, ny, nx = dense.shape
        x = dense.permute(0, 2, 1, 3, 4).reshape(b, nz * c, ny, nx)
        batch["spatial_features"] = torch.relu(self.BatchNorm_0(
            self.Conv_0(x)))
        batch["spatial_features_stride"] = 1
        return batch
