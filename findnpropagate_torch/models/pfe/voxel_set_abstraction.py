"""VoxelSetAbstraction — PV-RCNN's keypoint features — port of
findnpropagate_tpu/models/pfe/voxel_set_abstraction.py (`level_actives`
:29, `SALayer` :57, `VectorPoolLayer` :105,
`sectorized_proposal_centric_mask` :151, `sector_fps` :161,
`VoxelSetAbstraction` :177).

Keypoints are FPS-sampled from the raw points (or, for PV-RCNN++ with
``SAMPLE_METHOD: SPC`` and proposals in the batch, FPS per azimuth sector
over the points near a proposal). Each keypoint gathers, per source of
``FEATURES_SOURCE``: the BEV map bilinearly at its (x, y), and multi-scale
set abstraction (ball query + shared MLP + max over the ball) over the raw
points and over the backbone levels' active voxel centres; a level with a
``VECTOR_POOL`` dict takes VectorPool aggregation instead (the raw points
always take set abstraction, as in the reference). The sources are
concatenated (``point_features_before_fusion``) and fused by a Linear +
masked BN + ReLU (``point_features``).

A level reaches the set abstraction in the reference's order: a windowed
level as its sorted-id list, a gather-mode level as its active list, a
dense level (DENSE_FROM_LEVEL) compacted to at most 65536 cells, the
active ones first in flat (z, y, x) order — ball query keeps the first
in-radius sources, so the order is part of the result. The Linear and BN
layers carry the flax names (``sa_raw``, ``sa_x_conv3``, ``g0_fc0``,
``g0_bn0``, ``vp_x_conv3``, ``mix``, ``vsa_point_feature_fusion``,
``fusion_bn``), so utils/weights.py maps the JAX tree onto them.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ...ops.nms import _top_k
from ...ops.pointnet2 import farthest_point_sample, query_and_group
from ..blocks import MaskedBatchNorm

LEVEL_CAP = 65536


def level_actives(level, cap: int = LEVEL_CAP):
    """A backbone level -> (coords (B, V, 3) zyx, feats (B, V, C), valid
    (B, V)); a dense level compacted to V = min(cap, cells)."""
    kind, a, m = level
    if kind == "win":
        _, coords, valid, feats = a
        return coords, feats, valid
    if kind == "sparse":
        return a.coords, m, a.valid
    b, c, nz, ny, nx = a.shape
    key = m.reshape(b, -1).to(torch.float32)
    _, idx = _top_k(key, min(cap, key.shape[1]))     # actives first
    z = idx // (ny * nx)
    rem = idx % (ny * nx)
    coords = torch.stack([z, rem // nx, rem % nx], dim=-1).to(torch.int32)
    # gathered from the channels-first map: no channels-last copy of it
    feats = torch.gather(a.reshape(b, c, -1), 2, idx[:, None, :].expand(
        -1, c, -1)).transpose(1, 2)
    return coords, feats, torch.gather(m.reshape(b, -1), 1, idx)


def voxel_centers(coords, stride, voxel_size, pc_range):
    """zyx voxel coords (B, V, 3) of a level of `stride` -> xyz centres."""
    cf = coords.to(torch.float32)
    return torch.stack([
        (cf[..., 2] + 0.5) * voxel_size[0] * stride + pc_range[0],
        (cf[..., 1] + 0.5) * voxel_size[1] * stride + pc_range[1],
        (cf[..., 0] + 0.5) * voxel_size[2] * stride + pc_range[2],
    ], dim=-1)


class SALayer(nn.Module):
    """MSG set abstraction: per radius group a ball query, a shared MLP
    (Linear without bias + masked BN + ReLU per layer) over the grouped
    (relative xyz, features) and a max over the ball; empty balls give 0.
    `in_channels`: the source features' width (0 for none)."""

    def __init__(self, in_channels, mlps, radii, nsamples):
        super().__init__()
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(n) for n in nsamples)
        self.mlps = tuple(tuple(int(c) for c in m) for m in mlps)
        for gi, mlp in enumerate(self.mlps):
            cin = 3 + int(in_channels)
            for li, ch in enumerate(mlp):
                self.add_module(f"g{gi}_fc{li}", nn.Linear(cin, ch,
                                                           bias=False))
                self.add_module(f"g{gi}_bn{li}", MaskedBatchNorm(ch))
                cin = ch

    @property
    def out_channels(self):
        return sum(m[-1] for m in self.mlps)

    def forward(self, kp_xyz, kp_valid, src_xyz, src_valid, src_feats):
        """kp (B, K, 3); src (B, V, 3); src_feats (B, V, C) or None ->
        (B, K, out_channels)."""
        outs = []
        for gi, (mlp, radius, nsample) in enumerate(
                zip(self.mlps, self.radii, self.nsamples)):
            x, cnt = query_and_group(kp_xyz, kp_valid, src_xyz, src_valid,
                                     src_feats, radius, nsample)
            slot = torch.arange(nsample, device=cnt.device)
            gvalid = (cnt > 0)[..., None] & (
                slot < torch.clamp(cnt, min=1)[..., None])
            for li in range(len(mlp)):
                x = getattr(self, f"g{gi}_fc{li}")(x)
                x = torch.relu(getattr(self, f"g{gi}_bn{li}")(
                    x, gvalid, channels_last=True))
            x = x.amax(dim=2)
            outs.append(torch.where((cnt > 0)[..., None], x,
                                    torch.zeros_like(x)))
        return torch.cat(outs, dim=-1)


class VectorPoolLayer(nn.Module):
    """VectorPool aggregation (PV-RCNN++): the in-radius neighbours of a
    keypoint binned into a grid^3 local grid by their relative position,
    the mean (relative xyz, features) of each cell, all cells flattened
    through a Linear ``mix`` + masked BN + ReLU."""

    def __init__(self, in_channels, grid, radius, nsample, out_channels):
        super().__init__()
        self.grid, self.radius, self.nsample = int(grid), float(radius), \
            int(nsample)
        self.out_channels = int(out_channels)
        self.mix = nn.Linear(self.grid ** 3 * (3 + int(in_channels)),
                             self.out_channels, bias=False)
        self.mix_bn = MaskedBatchNorm(self.out_channels)

    def forward(self, kp_xyz, kp_valid, src_xyz, src_valid, src_feats):
        g = self.grid
        grouped, cnt = query_and_group(kp_xyz, kp_valid, src_xyz, src_valid,
                                       src_feats, self.radius, self.nsample)
        b, k, s, c = grouped.shape
        rel = grouped[..., :3]
        cell = torch.clamp(torch.floor((rel + self.radius)
                                       / (2 * self.radius / g)), 0, g - 1
                           ).to(torch.int64)
        flat = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
        slot_ok = (torch.arange(s, device=cnt.device)
                   < torch.clamp(cnt, min=0)[..., None]) & (cnt > 0)[..., None]
        flat = torch.where(slot_ok, flat, torch.full_like(flat, g ** 3))
        grouped = torch.where(slot_ok[..., None], grouped,
                              torch.zeros_like(grouped))
        acc = grouped.new_zeros(b, k, g ** 3 + 1, c).scatter_add_(
            2, flat[..., None].expand(-1, -1, -1, c), grouped)
        n = grouped.new_zeros(b, k, g ** 3 + 1).scatter_add_(
            2, flat, torch.ones_like(flat, dtype=grouped.dtype))
        cells = (acc[:, :, :-1] / torch.clamp(n[:, :, :-1, None], min=1.0)
                 ).reshape(b, k, -1)
        out = self.mix_bn(self.mix(cells), kp_valid, channels_last=True)
        return torch.relu(out)


def sectorized_proposal_centric_mask(points, pmask, rois, roi_valid,
                                     sample_radius_with_roi):
    """(B, P) candidate mask: valid points within a ROI's half diagonal +
    `sample_radius_with_roi` of its centre. points (B, P, 3+), rois
    (B, R, 7+)."""
    r = torch.sqrt((rois[..., 3:6] ** 2).sum(-1)) / 2 \
        + sample_radius_with_roi                          # (B, R)
    out = []
    for p, c, rr, rv in zip(points, rois, r, roi_valid):
        d = torch.sqrt(((p[:, None, :3] - c[None, :, :3]) ** 2).sum(-1))
        out.append(((d < rr[None]) & rv[None]).any(dim=1))
    return pmask & torch.stack(out)


def sector_fps(points, cand_mask, k: int, num_sectors: int):
    """FPS per azimuth sector: each of `num_sectors` sectors samples
    k // num_sectors of its candidates (the last also the remainder).
    points (B, P, 3+) -> (B, k) indices."""
    angles = torch.atan2(points[..., 1], points[..., 0]) + math.pi
    sector = torch.clamp((angles / (2 * math.pi / num_sectors)).to(
        torch.int32), 0, num_sectors - 1)
    per = k // num_sectors
    parts = []
    for s in range(num_sectors):
        take = per + (k - per * num_sectors if s == num_sectors - 1 else 0)
        parts.append(farthest_point_sample(points[..., :3],
                                           cand_mask & (sector == s), take))
    return torch.cat(parts, dim=1)


def bev_bilinear(bev, xf, yf):
    """bev (B, C, H, W); xf / yf (B, K) in BEV cells -> (B, K, C), zero
    outside the map."""
    b, c, h, w = bev.shape
    flat = bev.permute(0, 2, 3, 1).reshape(b, h * w, c)
    x0 = torch.floor(xf).to(torch.int64)
    y0 = torch.floor(yf).to(torch.int64)
    wx = xf - x0
    wy = yf - y0

    def tap(yi, xi):
        ok = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        lin = torch.clamp(yi, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
        v = torch.gather(flat, 1, lin[..., None].expand(-1, -1, c))
        return torch.where(ok[..., None], v, torch.zeros_like(v))

    return (tap(y0, x0) * ((1 - wx) * (1 - wy))[..., None]
            + tap(y0, x0 + 1) * (wx * (1 - wy))[..., None]
            + tap(y0 + 1, x0) * ((1 - wx) * wy)[..., None]
            + tap(y0 + 1, x0 + 1) * (wx * wy)[..., None])


class VoxelSetAbstraction(nn.Module):
    """model_cfg: the yaml's PFE. num_bev_features: the map-to-BEV's
    channels; level_channels: the backbone's channels by level name."""

    def __init__(self, model_cfg, voxel_size, point_cloud_range,
                 num_rawpoint_features=4, num_bev_features=0,
                 level_channels=None):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        self.num_raw = int(num_rawpoint_features) - 3
        self.sources = list(cfg["FEATURES_SOURCE"])
        sa_cfg = cfg["SA_LAYER"]
        level_channels = level_channels or {}
        width = 0
        for name in self.sources:
            if name == "bev":
                width += int(num_bev_features)
            elif name == "raw_points":
                self.sa_raw = self._sa(sa_cfg["raw_points"], self.num_raw)
                width += self.sa_raw.out_channels
            elif name.startswith("x_conv"):
                lc, vp = sa_cfg[name], sa_cfg[name].get("VECTOR_POOL")
                if vp:
                    mod = VectorPoolLayer(
                        level_channels[name], int(vp.get("GRID_SIZE", 3)),
                        float(vp.get("POOL_RADIUS", lc["POOL_RADIUS"][0])),
                        int(vp.get("NSAMPLE", lc["NSAMPLE"][0])),
                        int(vp.get("OUT_CHANNELS", 32)))
                    self.add_module(f"vp_{name}", mod)
                else:
                    mod = self._sa(lc, level_channels[name])
                    self.add_module(f"sa_{name}", mod)
                width += mod.out_channels
        self.num_point_features_before_fusion = width
        self.num_point_features = int(cfg["NUM_OUTPUT_FEATURES"])
        self.vsa_point_feature_fusion = nn.Linear(
            width, self.num_point_features, bias=False)
        self.fusion_bn = MaskedBatchNorm(self.num_point_features)

    @staticmethod
    def _sa(lc, in_channels):
        return SALayer(max(int(in_channels), 0), lc["MLPS"],
                       lc["POOL_RADIUS"], lc["NSAMPLE"])

    def keypoints(self, batch):
        """(B, K) keypoint indices into the points: FPS, or with SPC and
        proposals in the batch, sector FPS near the proposals."""
        cfg = self.model_cfg
        k = int(cfg["NUM_KEYPOINTS"])
        points, pmask = batch["points"], batch["points_mask"]
        if str(cfg.get("SAMPLE_METHOD", "FPS")).upper() == "SPC" \
                and "rois" in batch:
            spc = cfg.get("SPC_SAMPLING", {})
            cand = sectorized_proposal_centric_mask(
                points, pmask, batch["rois"][..., :7], batch["roi_valid"],
                float(spc.get("SAMPLE_RADIUS_WITH_ROI", 1.6)))
            return sector_fps(points[..., :3], cand, k,
                              int(spc.get("NUM_SECTORS", 6)))
        return farthest_point_sample(points[..., :3], pmask, k)

    def forward(self, batch):
        pcr = self.point_cloud_range
        vx, vy, _ = self.voxel_size
        points, pmask = batch["points"], batch["points_mask"]
        with torch.no_grad():
            kp_idx = self.keypoints(batch)
        kp_xyz = torch.gather(points[..., :3], 1,
                              kp_idx[..., None].expand(-1, -1, 3))
        kp_valid = torch.gather(pmask, 1, kp_idx)
        sa_cfg = self.model_cfg["SA_LAYER"]
        ms = batch.get("multi_scale_3d_features", {})
        feats = []
        for name in self.sources:
            if name == "bev":
                stride = int(batch.get("spatial_features_stride", 8))
                xs = (kp_xyz[..., 0] - pcr[0]) / vx / stride
                ys = (kp_xyz[..., 1] - pcr[1]) / vy / stride
                feats.append(bev_bilinear(batch["spatial_features"], xs, ys))
            elif name == "raw_points":
                raw = points[..., 3:3 + self.num_raw] if self.num_raw > 0 \
                    else None
                feats.append(self.sa_raw(kp_xyz, kp_valid, points[..., :3],
                                         pmask, raw))
            elif name.startswith("x_conv"):
                coords, lf, valid = level_actives(ms[name])
                centers = voxel_centers(
                    coords, int(sa_cfg[name].get("DOWNSAMPLE_FACTOR", 1)),
                    self.voxel_size, pcr)
                mod = self._modules.get(f"vp_{name}")
                if mod is None:
                    mod = self._modules[f"sa_{name}"]
                feats.append(mod(kp_xyz, kp_valid, centers, valid,
                                 lf.float()))
        fused = torch.cat(feats, dim=-1)
        batch["point_features_before_fusion"] = fused
        out = self.fusion_bn(self.vsa_point_feature_fusion(fused), kp_valid,
                             channels_last=True)
        batch["point_features"] = torch.relu(out)
        batch["point_coords"] = kp_xyz
        batch["point_valid"] = kp_valid
        return batch
