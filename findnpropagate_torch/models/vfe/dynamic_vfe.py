"""Dynamic VFEs, without a per-voxel point cap — port of
findnpropagate_tpu/models/vfe/dynamic_vfe.py (`_point_slots` :27-47,
`DynamicMeanVFE` :50-77, `DynamicPillarVFE` :80-163,
`DynamicPillarVFESimple2D` :166-238).

Every point of the raw (B, P, C) cloud is mapped to its voxel's slot
through the voxelizer's linear hash and a dense lin -> slot table (slot V:
no kept voxel), then per-point features are reduced into the slots with
segment sums (means) and segment maxima (the PFN layers: Linear without
bias, masked BN over the valid points, ReLU, max per pillar, the max
concatenated back onto each point but after the last layer). Submodules
carry the flax names ``pfn{i}_dense`` and ``pfn{i}_bn``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..blocks import MaskedBatchNorm
from .pillar_vfe import pillar_centers, vfe_input_channels


def point_slots(points, points_mask, coords, voxel_mask, voxel_size,
                point_cloud_range, grid_size):
    """(B, P) int64 slot of each point's voxel, V where the point lies
    outside the grid or its voxel was not kept. points (B, P, 3+),
    coords (B, V, 3) zyx."""
    nx, ny, nz = (int(g) for g in grid_size)
    b, v = coords.shape[:2]
    dev = points.device
    lo = torch.tensor(point_cloud_range[:3], dtype=points.dtype, device=dev)
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=dev)
    xyz = torch.floor((points[..., :3] - lo) / vs).to(torch.int64)
    grid = torch.tensor([nx, ny, nz], device=dev)
    inside = points_mask & ((xyz >= 0) & (xyz < grid)).all(-1)
    cells = nx * ny * nz
    lin_p = torch.where(inside, (xyz[..., 2] * ny + xyz[..., 1]) * nx
                        + xyz[..., 0], torch.full_like(xyz[..., 0], cells))
    c = coords.to(torch.int64)
    lin_v = torch.where(voxel_mask, (c[..., 0] * ny + c[..., 1]) * nx
                        + c[..., 2], torch.full_like(c[..., 0], cells))
    table = torch.full((b, cells + 1), v, dtype=torch.int64, device=dev)
    table.scatter_(1, lin_v, torch.where(
        voxel_mask, torch.arange(v, device=dev).expand(b, v),
        torch.full_like(lin_v, v)))
    slot = torch.gather(table, 1, lin_p)
    return torch.where(inside, slot, torch.full_like(slot, v))


def segment_sum(x, slot, v):
    """x (B, P, C) summed into V slots by slot (B, P); slot V is dropped."""
    out = x.new_zeros(x.shape[0], v + 1, x.shape[-1])
    return out.scatter_add(1, slot[..., None].expand(x.shape), x)[:, :v]


def segment_max(x, slot, valid, v):
    """Max of x (B, P, C) per slot over the valid points; 0 in a slot with
    none."""
    src = torch.where(valid[..., None], x, torch.full_like(x, -torch.inf))
    out = torch.full((x.shape[0], v + 1, x.shape[-1]), -torch.inf,
                     dtype=x.dtype, device=x.device)
    out = out.scatter_reduce(1, slot[..., None].expand(x.shape), src,
                             reduce="amax")[:, :v]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def take_rows(x, slot):
    """x (B, V, C) at slot (B, P), clipped into [0, V)."""
    idx = torch.clamp(slot, 0, x.shape[1] - 1)
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


class _DynamicVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range, grid_size=()):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_point_features = int(num_point_features)
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.grid_size = tuple(int(g) for g in grid_size)

    def slots(self, batch):
        return point_slots(batch["points"], batch["points_mask"],
                           batch["voxel_coords"], batch["voxel_mask"],
                           self.voxel_size, self.point_cloud_range,
                           self.grid_size)


class DynamicMeanVFE(_DynamicVFE):
    """The mean of all points of each voxel."""

    @property
    def output_dim(self):
        return self.num_point_features

    def forward(self, batch):
        points = batch["points"]
        v = batch["voxel_coords"].shape[1]
        slot = self.slots(batch)
        ssum = segment_sum(points, slot, v)
        cnt = segment_sum(points.new_ones(*points.shape[:2], 1), slot, v)
        batch["voxel_features"] = ssum / torch.clamp(cnt, min=1.0) \
            * batch["voxel_mask"][..., None].to(points.dtype)
        return batch


class _DynamicPFN(_DynamicVFE):
    """The PFN stack over per-point features `features(batch, slot)`."""

    offsets = 0

    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range, grid_size=()):
        super().__init__(model_cfg, num_point_features, voxel_size,
                         point_cloud_range, grid_size)
        self.use_abs = bool(model_cfg.get("USE_ABSLOTE_XYZ", True))
        self.with_dist = bool(model_cfg.get("WITH_DISTANCE", False))
        num_filters = [int(f) for f in model_cfg["NUM_FILTERS"]]
        self.output_dim = num_filters[-1]
        self.num_layers = len(num_filters)
        c = vfe_input_channels(model_cfg, num_point_features, self.offsets)
        for i, nf in enumerate(num_filters):
            self.add_module(f"pfn{i}_dense", nn.Linear(c, nf, bias=False))
            self.add_module(f"pfn{i}_bn", MaskedBatchNorm(nf))
            c = 2 * nf

    def point_features(self, points):
        feats = [points if self.use_abs else points[..., 3:]]
        if self.with_dist:
            feats.append(torch.linalg.norm(points[..., :3], dim=-1,
                                           keepdim=True))
        return feats

    def forward(self, batch):
        points = batch["points"]
        v = batch["voxel_coords"].shape[1]
        slot = self.slots(batch)
        x = torch.cat(self.features(batch, slot), dim=-1)
        pvalid = slot < v
        x = x * pvalid[..., None].to(x.dtype)
        for i in range(self.num_layers):
            x = getattr(self, f"pfn{i}_dense")(x)
            x = getattr(self, f"pfn{i}_bn")(x, pvalid, channels_last=True)
            x = torch.relu(x)
            x_max = segment_max(x, slot, pvalid, v)
            if i == self.num_layers - 1:
                batch["pillar_features"] = x_max * batch["voxel_mask"][
                    ..., None].to(points.dtype)
                return batch
            x = torch.cat([x, take_rows(x_max, slot)], dim=-1)
        return batch


class DynamicPillarVFE(_DynamicPFN):
    """PointPillars' PFN over all points of each pillar, with the cluster
    (pillar mean) and centre offsets."""

    offsets = 6

    def features(self, batch, slot):
        points = batch["points"]
        v = batch["voxel_coords"].shape[1]
        psum = segment_sum(points[..., :3], slot, v)
        cnt = segment_sum(points.new_ones(*points.shape[:2], 1), slot, v)
        mean = psum / torch.clamp(cnt, min=1.0)
        f_cluster = points[..., :3] - take_rows(mean, slot)
        centers = pillar_centers(batch["voxel_coords"], self.voxel_size,
                                 self.point_cloud_range, points.dtype)
        f_center = points[..., :3] - take_rows(centers, slot)
        feats = self.point_features(points)
        return feats[:1] + [f_cluster, f_center] + feats[1:]


class DynamicPillarVFESimple2D(_DynamicPFN):
    """PillarNet's VFE: the centre offsets only, z measured from the
    range's floor, ahead of the point features."""

    offsets = 3

    def features(self, batch, slot):
        points = batch["points"]
        centers = pillar_centers(batch["voxel_coords"], self.voxel_size,
                                 self.point_cloud_range, points.dtype)
        z_off = self.voxel_size[2] / 2 + self.point_cloud_range[2]
        f_center = torch.cat([points[..., 0:2] - take_rows(centers, slot)[
            ..., 0:2], points[..., 2:3] - z_off], dim=-1)
        return [f_center] + self.point_features(points)
