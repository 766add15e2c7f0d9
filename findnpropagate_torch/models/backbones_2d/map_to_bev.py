"""Sparse -> dense BEV projections — port of
findnpropagate_tpu/models/backbones_2d/map_to_bev.py
(`PointPillarScatter` :21-52, `HeightCompression` :55-73).

PointPillarScatter writes each kept pillar's features into its (y, x)
cell of a zero canvas, one batched scatter with a dummy row for the
padding; HeightCompression folds z into channels: (B, C, nz, ny, nx) ->
(B, nz*C, ny, nx), channel index z*C + c as in the reference's
(B, ny, nx, nz*C). Both give the NCHW `spatial_features` the port's
BaseBEVBackbone reads (the reference's are NHWC).
"""

from __future__ import annotations

from torch import nn


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
