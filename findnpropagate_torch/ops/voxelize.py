"""Voxelization fused with the MeanVFE reduction — port of
findnpropagate_tpu/ops/voxelize.py (`_voxel_segments` :73-150,
`voxelize_mean` :202-260).

Same semantics, batched over a leading B axis: points are stably sorted by
their linear voxel hash, segment starts give each voxel's slot (ascending
hash order), the first MAX_VOXELS voxels are kept, and each voxel's feature
is the mean over its first <= T points in input order. The stable sort is
what makes "first <= T" well defined, as `jnp.argsort(stable=True)` does in
the reference. Plain PyTorch: the reference has no Pallas kernel here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VoxelMeanOutput(NamedTuple):
    means: torch.Tensor        # (B, V, C) mean of the first <=T points
    coords: torch.Tensor       # (B, V, 3) int32 zyx, -1 padding
    num_points: torch.Tensor   # (B, V) int32 points per voxel (clipped to T)
    voxel_mask: torch.Tensor   # (B, V) bool
    num_voxels: torch.Tensor   # (B,) int32


def compute_voxel_coords(points, point_cloud_range, voxel_size):
    """(B, P, >=3) -> (B, P, 3) int xyz voxel coords + (B, P) in-range mask,
    in float32 arithmetic exactly as the reference."""
    dev = points.device
    lo = torch.tensor(point_cloud_range[0:3], dtype=points.dtype, device=dev)
    hi = torch.tensor(point_cloud_range[3:6], dtype=points.dtype, device=dev)
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=dev)
    grid = torch.floor((hi - lo) / vs + 0.5).to(torch.int32)
    xyz = torch.floor((points[..., 0:3] - lo) / vs).to(torch.int32)
    in_range = ((points[..., 0:3] >= lo) & (points[..., 0:3] < hi)).all(-1)
    in_grid = ((xyz >= 0) & (xyz < grid)).all(-1)
    return xyz, in_range & in_grid


def voxelize_mean(points, points_mask, point_cloud_range, voxel_size,
                  grid_size, max_voxels: int,
                  max_points_per_voxel: int) -> VoxelMeanOutput:
    """points (B, P, C) float32; points_mask (B, P) bool."""
    b, p, c = points.shape
    v_cap, t_cap = int(max_voxels), int(max_points_per_voxel)
    nx, ny, nz = (int(g) for g in grid_size)
    dev = points.device

    xyz, in_range = compute_voxel_coords(points, point_cloud_range,
                                         voxel_size)
    valid = points_mask & in_range
    xyz = xyz.long()
    lin = (xyz[..., 2] * ny + xyz[..., 1]) * nx + xyz[..., 0]
    sentinel = nx * ny * nz
    lin = torch.where(valid, lin, torch.full_like(lin, sentinel))

    lin_sorted, order = torch.sort(lin, dim=1, stable=True)
    is_valid_sorted = lin_sorted < sentinel
    newseg = torch.cat(
        [is_valid_sorted[:, :1],
         (lin_sorted[:, 1:] != lin_sorted[:, :-1]) & is_valid_sorted[:, 1:]],
        dim=1)
    slot = torch.cumsum(newseg.to(torch.int64), dim=1) - 1
    slot = torch.where(is_valid_sorted, slot, torch.full_like(slot, v_cap))
    num_total = torch.where(is_valid_sorted, slot + 1,
                            torch.zeros_like(slot)).amax(dim=1)
    num_voxels = torch.clamp(num_total, max=v_cap)

    # rows 0..v_cap-1: kept-segment starts; row v_cap: start of the first
    # cut segment; row v_cap+1: dump for the non-start points
    total_valid = is_valid_sorted.sum(dim=1, keepdim=True)
    pos = torch.arange(p, device=dev).expand(b, p)
    seg_slot = torch.where(newseg, torch.clamp(slot, max=v_cap),
                           torch.full_like(slot, v_cap + 1))
    starts_ext = torch.full((b, v_cap + 2), p, dtype=torch.int64, device=dev)
    starts_ext = starts_ext.scatter_reduce(1, seg_slot, pos, reduce="amin")
    starts_ext = torch.minimum(starts_ext[:, :v_cap + 1], total_valid)
    starts = starts_ext[:, :v_cap]
    start_valid = (torch.arange(v_cap, device=dev)[None, :]
                   < num_voxels[:, None])

    counts = torch.where(start_valid, starts_ext[:, 1:] - starts,
                         torch.zeros_like(starts))
    num_points = torch.clamp(counts, max=t_cap)

    lin_at = torch.gather(lin_sorted, 1, torch.clamp(starts, max=p - 1))
    cx = lin_at % nx
    cy = (lin_at // nx) % ny
    cz = lin_at // (nx * ny)
    coords = torch.where(start_valid[..., None],
                         torch.stack([cz, cy, cx], dim=-1),
                         torch.full_like(lin_at, -1)[..., None])

    pts_sorted = torch.gather(points, 1, order[..., None].expand(b, p, c))
    pts_pad = torch.cat(
        [pts_sorted, points.new_zeros(b, t_cap, c)], dim=1)
    acc = points.new_zeros(b, v_cap, c)
    base = torch.clamp(starts, max=p - 1)
    for t in range(t_cap):
        row = torch.gather(pts_pad, 1, (base + t)[..., None].expand(
            b, v_cap, c))
        acc = acc + torch.where((t < num_points)[..., None], row,
                                torch.zeros_like(row))
    means = acc / torch.clamp(num_points.to(acc.dtype), min=1.0)[..., None]

    return VoxelMeanOutput(
        means=means,
        coords=coords.to(torch.int32),
        num_points=num_points.to(torch.int32),
        voxel_mask=start_valid,
        num_voxels=num_voxels.to(torch.int32),
    )
