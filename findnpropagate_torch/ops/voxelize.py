"""On-device voxelization — port of findnpropagate_tpu/ops/voxelize.py
(`_voxel_segments` :73-150, `voxelize` :152-199, `voxelize_mean`
:202-260, `dynamic_voxelize` :263-272).

Same semantics, batched over a leading B axis: points are stably sorted by
their linear voxel hash, segment starts give each voxel's slot (ascending
hash order, not spconv's first-appearance order: the pillar VFEs' BN
statistics and PointPillarScatter read the voxels as the reference lays
them out), the first MAX_VOXELS voxels are kept, and each keeps its first
<= T points in input order. The stable sort is what makes "first <= T"
well defined, as `jnp.argsort(stable=True)` does in the reference.
`voxelize` gathers those points into a zero-padded (V, T, C) bucket (the
pillar VFEs'); `voxelize_mean` folds MeanVFE's mean over them in instead.
Plain PyTorch: the reference has no Pallas kernel here.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class VoxelizationOutput(NamedTuple):
    voxels: torch.Tensor       # (B, V, T, C) first <=T points, zero padded
    coords: torch.Tensor       # (B, V, 3) int32 zyx, -1 padding
    num_points: torch.Tensor   # (B, V) int32 points per voxel (clipped to T)
    voxel_mask: torch.Tensor   # (B, V) bool
    num_voxels: torch.Tensor   # (B,) int32
    point_voxel_idx: torch.Tensor  # (B, P) int32 voxel slot, -1 = dropped


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


def _voxel_segments(points, points_mask, point_cloud_range, voxel_size,
                    grid_size, v_cap: int, t_cap: int):
    """The shared sort / segment core: per voxel its segment start in the
    hash-sorted points, its point count (clipped to T), zyx coords and
    mask, and per input point its voxel slot (-1: out of range or beyond
    MAX_VOXELS). points (B, P, C), points_mask (B, P) bool."""
    b, p, _ = points.shape
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

    keep = is_valid_sorted & (slot < v_cap)
    point_voxel_idx = torch.full((b, p), -1, dtype=torch.int64, device=dev)
    point_voxel_idx = point_voxel_idx.scatter(
        1, order, torch.where(keep, slot, torch.full_like(slot, -1)))
    return dict(order=order, starts=starts, num_points=num_points,
                coords=coords.to(torch.int32), voxel_mask=start_valid,
                num_voxels=num_voxels.to(torch.int32),
                point_voxel_idx=point_voxel_idx.to(torch.int32))


def _sorted_padded(points, order, t_cap):
    """The points in hash order with T zero rows behind them, so that a
    segment start near the end reads T rows in bounds."""
    b, p, c = points.shape
    pts_sorted = torch.gather(points, 1, order[..., None].expand(b, p, c))
    return torch.cat([pts_sorted, points.new_zeros(b, t_cap, c)], dim=1)


def voxelize(points, points_mask, point_cloud_range, voxel_size, grid_size,
             max_voxels: int, max_points_per_voxel: int
             ) -> VoxelizationOutput:
    """points (B, P, C) float32; points_mask (B, P) bool. The (V, T, C)
    bucket holds each voxel's first <= T points, zeros behind them."""
    b = points.shape[0]
    v_cap, t_cap = int(max_voxels), int(max_points_per_voxel)
    seg = _voxel_segments(points, points_mask, point_cloud_range,
                          voxel_size, grid_size, v_cap, t_cap)
    pts_pad = _sorted_padded(points, seg["order"], t_cap)
    t_slot = torch.arange(t_cap, device=points.device)
    rows = seg["starts"][..., None] + t_slot                  # (B, V, T)
    bucket = pts_pad[torch.arange(b, device=points.device)[:, None, None],
                     rows]
    within = t_slot < seg["num_points"][..., None]
    voxels = torch.where(within[..., None], bucket, torch.zeros_like(bucket))
    return VoxelizationOutput(
        voxels=voxels, coords=seg["coords"],
        num_points=seg["num_points"].to(torch.int32),
        voxel_mask=seg["voxel_mask"], num_voxels=seg["num_voxels"],
        point_voxel_idx=seg["point_voxel_idx"])


def voxelize_mean(points, points_mask, point_cloud_range, voxel_size,
                  grid_size, max_voxels: int,
                  max_points_per_voxel: int) -> VoxelMeanOutput:
    """points (B, P, C) float32; points_mask (B, P) bool."""
    b, p, c = points.shape
    v_cap, t_cap = int(max_voxels), int(max_points_per_voxel)
    seg = _voxel_segments(points, points_mask, point_cloud_range,
                          voxel_size, grid_size, v_cap, t_cap)
    num_points = seg["num_points"]
    pts_pad = _sorted_padded(points, seg["order"], t_cap)
    acc = points.new_zeros(b, v_cap, c)
    base = torch.clamp(seg["starts"], max=p - 1)
    for t in range(t_cap):
        row = torch.gather(pts_pad, 1, (base + t)[..., None].expand(
            b, v_cap, c))
        acc = acc + torch.where((t < num_points)[..., None], row,
                                torch.zeros_like(row))
    means = acc / torch.clamp(num_points.to(acc.dtype), min=1.0)[..., None]

    return VoxelMeanOutput(
        means=means,
        coords=seg["coords"],
        num_points=num_points.to(torch.int32),
        voxel_mask=seg["voxel_mask"],
        num_voxels=seg["num_voxels"],
    )


def dynamic_voxelize(points, points_mask, point_cloud_range, voxel_size,
                     grid_size, max_voxels: int):
    """No per-voxel point cap: (point_voxel_idx (B, P), coords (B, V, 3),
    voxel_mask (B, V), num_voxels (B,)), as `voxelize` with T = 1 gives
    them."""
    seg = _voxel_segments(points, points_mask, point_cloud_range,
                          voxel_size, grid_size, int(max_voxels), 1)
    return (seg["point_voxel_idx"], seg["coords"], seg["voxel_mask"],
            seg["num_voxels"])
