"""The lidar branch's plain reference: voxelization with MeanVFE, the
sparse VoxelResBackBone8x and HeightCompression, one scene at a time.

Written for the benchmark from the layer equations, not copied from the
port:
  * voxels: a point's cell is floor((p - range_lo) / voxel) in float32,
    kept where the point lies inside the range and the grid; voxels are
    numbered by ascending zyx linear id, the first MAX_VOXELS kept, and
    each averages its first MAX_POINTS_PER_VOXEL points in input order
    (MeanVFE);
  * a sparse convolution gathers, for every output cell and kernel tap,
    the input cell at (stride * o + tap - padding) through a dense table
    of the input level, and multiplies the rows by that tap's
    (Cin, Cout) weights: submanifold convolutions keep the input's active
    set, a strided one's output cell is active where its receptive field
    holds an active input (a max pool of the occupancy), cut to the
    level's capacity in ascending (y, x, z) order as the windowed mode
    keeps it (the capacity rounded up to WINDOWED_BLOCK);
  * BN at eval is the affine map of its statistics, zero off the active
    set; residual blocks add the block's input before the last ReLU;
  * the output conv (3, 1, 1) over z and HeightCompression's fold of z
    into channels (channel z * C + c).
Each convolution's rulebook is counted: the (output, tap) pairs that have
an input (`hits`), which the benchmark's work counters read.
"""

from __future__ import annotations

import types

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .precision import round_operand

BN_EPS = 1e-3


class SparseConvParam(nn.Module):
    """kernel (K, Cin, Cout), taps in zyx C-order."""

    def __init__(self, cin, cout, kernel=(3, 3, 3), use_bias=False):
        super().__init__()
        self.kernel_size = tuple(kernel)
        self.kernel = nn.Parameter(torch.zeros(int(np.prod(kernel)), cin,
                                               cout))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None


class MaskedBatchNorm(nn.Module):
    def __init__(self, features):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        k = torch.rsqrt(self.var + BN_EPS) * self.scale
        return x * k + (self.bias - self.mean * k)


def voxelize_mean(points, point_cloud_range, voxel_size, max_voxels,
                  max_points):
    """points (P, C) float32 of one scene -> (coords (V, 3) int64 zyx,
    means (V, C))."""
    dev = points.device
    lo = torch.tensor(point_cloud_range[:3], dtype=torch.float32, device=dev)
    hi = torch.tensor(point_cloud_range[3:], dtype=torch.float32, device=dev)
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    grid = torch.floor((hi - lo) / vs + 0.5).long()
    xyz = torch.floor((points[:, :3] - lo) / vs).long()
    keep = (((points[:, :3] >= lo) & (points[:, :3] < hi)).all(1)
            & ((xyz >= 0) & (xyz < grid)).all(1))
    pts, xyz = points[keep], xyz[keep]
    nx, ny = int(grid[0]), int(grid[1])
    lin = (xyz[:, 2] * ny + xyz[:, 1]) * nx + xyz[:, 0]
    lin_sorted, order = torch.sort(lin, stable=True)
    uniq, inverse, counts = torch.unique_consecutive(
        lin_sorted, return_inverse=True, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(lin_sorted.numel(), device=dev) - starts[inverse]
    take = (rank < max_points) & (inverse < max_voxels)
    n_vox = min(int(uniq.numel()), int(max_voxels))
    sums = points.new_zeros(n_vox, points.shape[1]).index_add_(
        0, inverse[take], pts[order][take])
    means = sums / torch.clamp(counts[:n_vox], max=max_points)[:, None].to(
        sums.dtype)
    u = uniq[:n_vox]
    coords = torch.stack([u // (nx * ny), (u // nx) % ny, u % nx], dim=1)
    return coords, means


def conv_out_dim(n, k, s, p):
    return (n + 2 * p - k) // s + 1


class Level:
    """One level of one scene: coords (N, 3) int64 zyx, feats (N, C), the
    grid shape (nz, ny, nx) and the lookup table from linear id to row."""

    def __init__(self, coords, feats, shape, table=None):
        self.coords, self.feats, self.shape = coords, feats, tuple(shape)
        if table is None:
            table = torch.full((int(np.prod(self.shape)),), -1,
                               dtype=torch.int32, device=coords.device)
            table[self._linear(coords)[0]] = torch.arange(
                coords.shape[0], dtype=torch.int32, device=coords.device)
        self.table = table

    def with_feats(self, feats):
        """The same active set with other features."""
        return Level(self.coords, feats, self.shape, self.table)

    def _linear(self, cells):
        nz, ny, nx = self.shape
        inside = ((cells >= 0) & (cells < torch.tensor(
            self.shape, device=cells.device))).all(-1)
        lin = (cells[..., 0] * ny + cells[..., 1]) * nx + cells[..., 2]
        return torch.where(inside, lin, torch.zeros_like(lin)), inside

    def rows(self, cells):
        """The row of each cell, -1 where it is empty or off the grid."""
        lin, inside = self._linear(cells)
        return torch.where(inside, self.table[lin].long(),
                           torch.full_like(lin, -1))


def tap_offsets(kernel):
    kz, ky, kx = kernel
    g = np.stack(np.meshgrid(np.arange(kz), np.arange(ky), np.arange(kx),
                             indexing="ij"), -1).reshape(-1, 3)
    return torch.from_numpy(g.astype(np.int64))


def sparse_conv(src: Level, out_coords, wmod, stride, padding, fmt,
                rulebook):
    """One sparse conv of `src` onto `out_coords`: (N_out, Cout) float32."""
    dev = out_coords.device
    taps = tap_offsets(wmod.kernel_size).to(dev)
    base = out_coords * torch.tensor(stride, device=dev) \
        - torch.tensor(padding, device=dev)
    feats = round_operand(src.feats, fmt)
    kernel = round_operand(wmod.kernel, fmt)
    out = torch.zeros(out_coords.shape[0], kernel.shape[2],
                      dtype=torch.float32, device=dev)
    hits = 0
    for t in range(taps.shape[0]):
        rows = src.rows(base + taps[t])
        have = rows >= 0
        if not bool(have.any()):
            continue
        out[have] += feats[rows[have]] @ kernel[t]
        hits += int(have.sum())
    rulebook.append({"hits": hits, "cin": int(kernel.shape[1]),
                     "cout": int(kernel.shape[2]), "taps": int(taps.shape[0]),
                     "n_in": int(src.coords.shape[0]),
                     "n_out": int(out_coords.shape[0])})
    if wmod.bias is not None:
        out = out + wmod.bias
    return out


def strided_active_set(src: Level, out_shape, kernel, stride, padding, cap):
    """Output cells whose receptive field holds an active input, at most
    `cap` of them in ascending (y, x, z) order (None: no cap). Returns
    (coords (N, 3) int64 zyx, whether the cap cut cells)."""
    occ = torch.zeros(src.shape, dtype=torch.float32,
                      device=src.coords.device)
    occ[tuple(src.coords.T)] = 1.0
    out = F.max_pool3d(occ[None, None], kernel, stride, padding)[0, 0]
    if tuple(out.shape) != tuple(out_shape):
        raise AssertionError(f"active set {tuple(out.shape)} vs {out_shape}")
    coords = torch.nonzero(out > 0)
    cut = cap is not None and coords.shape[0] > cap
    if cut:
        nz, ny, nx = out_shape
        key = (coords[:, 1] * nx + coords[:, 2]) * nz + coords[:, 0]
        coords = coords[torch.sort(torch.argsort(key)[:cap]).values]
    return coords, cut


class VoxelResBackBone8x(nn.Module):
    """The residual 8x stack with the port's parameter names."""

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__()
        cfg = model_cfg
        nx, ny, nz = (int(g) for g in grid_size)
        s1 = (nz + 1, ny, nx)
        s2 = tuple(conv_out_dim(n, 3, 2, 1) for n in s1)
        s3 = tuple(conv_out_dim(n, 3, 2, 1) for n in s2)
        s4 = (conv_out_dim(s3[0], 3, 2, 0), conv_out_dim(s3[1], 3, 2, 1),
              conv_out_dim(s3[2], 3, 2, 1))
        s_out = (conv_out_dim(s4[0], 3, 2, 0), s4[1], s4[2])
        self.level_shapes = [s1, s2, s3, s4, s_out]
        _, c1, c2, c3, c4 = (int(c) for c in cfg.get(
            "CHANNELS", [16, 16, 32, 64, 128]))
        self.out_channels = int(cfg.get("OUT_CHANNELS", 128))
        use_bias = bool(cfg.get("USE_BIAS", True))
        c0 = int(cfg.get("MAX_VOXELS", 60000))
        caps = cfg.get("LEVEL_CAPACITIES") or [c0, c0, c0 // 2, c0 // 4,
                                                 c0 // 8]
        block = int(cfg.get("WINDOWED_BLOCK", 640)) \
            if str(cfg.get("SUBM_MODE", "gather")) == "windowed" else 1
        self.caps = [-(-int(c) // block) * block for c in caps]
        self.w_input = SparseConvParam(input_channels, c1)
        self.bn_input = MaskedBatchNorm(c1)
        self.stages = []
        for s, (cin, cout, down) in enumerate(
                [(c1, c1, False), (c1, c2, True), (c2, c3, True),
                 (c3, c4, True)], start=1):
            if down:
                self.add_module(f"blocks{s}_down",
                                SparseConvParam(cin, cout))
                self.add_module(f"blocks{s}_down_bn", MaskedBatchNorm(cout))
            for b in range(2):
                self.add_module(f"blocks{s}_res{b}_conv1", SparseConvParam(
                    cin if (b == 0 and not down) else cout, cout,
                    use_bias=use_bias))
                self.add_module(f"blocks{s}_res{b}_bn1",
                                MaskedBatchNorm(cout))
                self.add_module(f"blocks{s}_res{b}_conv2", SparseConvParam(
                    cout, cout, use_bias=use_bias))
                self.add_module(f"blocks{s}_res{b}_bn2",
                                MaskedBatchNorm(cout))
        self.w_out = SparseConvParam(c4, self.out_channels, kernel=(3, 1, 1))
        self.bn_out = MaskedBatchNorm(self.out_channels)

    def _subm(self, lv, wmod, bnmod, relu, fmt, rulebook):
        out = bnmod(sparse_conv(lv, lv.coords, wmod, (1, 1, 1), (1, 1, 1),
                                fmt, rulebook))
        return torch.relu(out) if relu else out

    def _down(self, lv, wmod, bnmod, out_shape, cap, stride, padding, fmt,
              rulebook, cuts):
        coords, cut = strided_active_set(lv, out_shape, wmod.kernel_size,
                                         stride, padding, cap)
        cuts.append(cut)
        out = sparse_conv(lv, coords, wmod, stride, padding, fmt, rulebook)
        return Level(coords, torch.relu(bnmod(out)), out_shape)

    def _blocks(self, s, lv, fmt, rulebook):
        for b in range(2):
            x = self._subm(lv, getattr(self, f"blocks{s}_res{b}_conv1"),
                           getattr(self, f"blocks{s}_res{b}_bn1"), True, fmt,
                           rulebook)
            y = self._subm(lv.with_feats(x),
                           getattr(self, f"blocks{s}_res{b}_conv2"),
                           getattr(self, f"blocks{s}_res{b}_bn2"), False, fmt,
                           rulebook)
            lv = lv.with_feats(torch.relu(y + lv.feats))
        return lv

    def forward(self, coords, feats, fmt=None):
        """One scene's voxels -> (encoded (C, nz_out, ny, nx), active
        counts of levels 1-4, rulebook, whether a capacity cut cells)."""
        s1, s2, s3, s4, s_out = self.level_shapes
        rulebook, cuts, counts = [], [], []

        def level(n, start):
            for conv in rulebook[start:]:
                conv["level"] = n

        lv = Level(coords, feats.float(), s1)
        lv = lv.with_feats(self._subm(lv, self.w_input, self.bn_input, True,
                                      fmt, rulebook))
        lv = self._blocks(1, lv, fmt, rulebook)
        level(1, 0)
        counts.append(lv.coords.shape[0])
        for s, shape, cap, pad in ((2, s2, self.caps[2], (1, 1, 1)),
                                   (3, s3, self.caps[3], (1, 1, 1)),
                                   (4, s4, self.caps[4], (0, 1, 1))):
            start = len(rulebook)
            lv = self._down(lv, getattr(self, f"blocks{s}_down"),
                            getattr(self, f"blocks{s}_down_bn"), shape, cap,
                            (2, 2, 2), pad, fmt, rulebook, cuts)
            lv = self._blocks(s, lv, fmt, rulebook)
            level(s, start)
            counts.append(lv.coords.shape[0])
        start = len(rulebook)
        lv = self._down(lv, self.w_out, self.bn_out, s_out, None, (2, 1, 1),
                        (0, 0, 0), fmt, rulebook, cuts)
        level(5, start)
        dense = torch.zeros((self.out_channels,) + tuple(s_out),
                            dtype=torch.float32, device=coords.device)
        dense[(slice(None),) + tuple(lv.coords.T)] = lv.feats.T
        return dense, counts, rulebook, any(cuts)


    def active_counts(self, coords):
        """The active voxels of levels 1-4 of one scene, as `forward`
        counts them, from the active sets alone (no convolution)."""
        s1, s2, s3, s4, _ = self.level_shapes
        counts, lv = [coords.shape[0]], types.SimpleNamespace(
            coords=coords, shape=s1)
        for s, shape, pad in ((2, s2, (1, 1, 1)), (3, s3, (1, 1, 1)),
                              (4, s4, (0, 1, 1))):
            c, _ = strided_active_set(
                lv, shape, getattr(self, f"blocks{s}_down").kernel_size,
                (2, 2, 2), pad, self.caps[s])
            lv = types.SimpleNamespace(coords=c, shape=shape)
            counts.append(c.shape[0])
        return counts


def height_compression(dense):
    """(C, nz, ny, nx) -> (nz * C, ny, nx), channel z * C + c."""
    c, nz, ny, nx = dense.shape
    return dense.permute(1, 0, 2, 3).reshape(nz * c, ny, nx)
