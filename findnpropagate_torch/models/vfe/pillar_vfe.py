"""PillarVFE, the PointPillars feature network — port of
findnpropagate_tpu/models/vfe/pillar_vfe.py (`PFNLayer` :23-48,
`PillarVFE` :51-114).

Each point of the (B, V, T, C) bucket gains its offset from the pillar's
mean (cluster) and from the pillar cell's centre, padded slots are zeroed,
then PFN layers run: Linear -> masked BN -> ReLU -> max over the T slots;
a layer that is not the last concatenates the pillar's max back onto each
point. The BN statistics cover all T slots of the real pillars, padded
slots included, and no padded pillar, as the reference's BatchNorm1d over
the ragged (N_real, C, T) tensor does; padded slots' outputs take part in
the max. Submodules carry the flax auto-names (``PFNLayer_{i}`` with
``Dense_0`` and ``MaskedBatchNorm_0``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..blocks import MaskedBatchNorm


def pillar_centers(coords, voxel_size, point_cloud_range, dtype):
    """(B, V, 3) zyx cells -> (B, V, 3) xyz centres of the cells."""
    vx, vy, vz = (float(v) for v in voxel_size)
    cf = coords.to(dtype)
    return torch.stack([cf[..., 2] * vx + (vx / 2 + float(point_cloud_range[0])),
                        cf[..., 1] * vy + (vy / 2 + float(point_cloud_range[1])),
                        cf[..., 0] * vz + (vz / 2 + float(point_cloud_range[2]))],
                       dim=-1)


def vfe_input_channels(model_cfg, num_point_features, offsets):
    """Point features (xyz dropped without USE_ABSLOTE_XYZ), the offset
    columns, and the distance with WITH_DISTANCE."""
    c = int(num_point_features)
    if not bool(model_cfg.get("USE_ABSLOTE_XYZ", True)):
        c -= 3
    return c + offsets + int(bool(model_cfg.get("WITH_DISTANCE", False)))


class PFNLayer(nn.Module):
    def __init__(self, in_channels, out_channels, last_layer=False,
                 use_norm=True):
        super().__init__()
        self.last_layer = last_layer
        out = out_channels if last_layer else out_channels // 2
        self.Dense_0 = nn.Linear(in_channels, out, bias=not use_norm)
        self.MaskedBatchNorm_0 = MaskedBatchNorm(out) if use_norm else None
        self.out_channels = out if last_layer else 2 * out

    def forward(self, x, pillar_valid):
        """x (B, V, T, C); pillar_valid (B, V) bool."""
        x = self.Dense_0(x)
        if self.MaskedBatchNorm_0 is not None:
            x = self.MaskedBatchNorm_0(
                x, pillar_valid[..., None].expand(x.shape[:-1]),
                channels_last=True)
        x = torch.relu(x)
        x_max = x.amax(dim=2, keepdim=True)
        if self.last_layer:
            return x_max[:, :, 0, :]
        return torch.cat([x, x_max.expand(x.shape)], dim=-1)


class PillarVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range, grid_size=()):
        super().__init__()
        cfg = model_cfg
        self.use_abs_xyz = bool(cfg.get("USE_ABSLOTE_XYZ", True))
        self.with_distance = bool(cfg.get("WITH_DISTANCE", False))
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        num_filters = [int(f) for f in cfg["NUM_FILTERS"]]
        self.output_dim = num_filters[-1]
        c = vfe_input_channels(cfg, num_point_features, 6)
        self.num_layers = len(num_filters)
        for i, nf in enumerate(num_filters):
            layer = PFNLayer(c, nf, last_layer=i == len(num_filters) - 1,
                             use_norm=bool(cfg.get("USE_NORM", True)))
            self.add_module(f"PFNLayer_{i}", layer)
            c = layer.out_channels

    def forward(self, batch):
        voxels = batch["voxels"]                 # (B, V, T, C)
        num_points = batch["voxel_num_points"]   # (B, V)
        t = voxels.shape[2]
        normalizer = torch.clamp(num_points[..., None, None].to(voxels.dtype),
                                 min=1.0)
        points_mean = voxels[..., :3].sum(dim=2, keepdim=True) / normalizer
        f_cluster = voxels[..., :3] - points_mean
        centers = pillar_centers(batch["voxel_coords"], self.voxel_size,
                                 self.point_cloud_range, voxels.dtype)
        f_center = voxels[..., :3] - centers[:, :, None, :]
        feats = [voxels if self.use_abs_xyz else voxels[..., 3:], f_cluster,
                 f_center]
        if self.with_distance:
            feats.append(torch.linalg.norm(voxels[..., :3], dim=-1,
                                           keepdim=True))
        features = torch.cat(feats, dim=-1)
        point_valid = torch.arange(t, device=voxels.device) \
            < num_points[..., None]
        features = features * point_valid[..., None].to(features.dtype)
        pillar_valid = num_points > 0
        for i in range(self.num_layers):
            features = getattr(self, f"PFNLayer_{i}")(features, pillar_valid)
        batch["pillar_features"] = features      # (B, V, C_out)
        return batch
