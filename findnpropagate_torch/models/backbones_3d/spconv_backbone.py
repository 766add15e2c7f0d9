"""VoxelResBackBone8x and VoxelBackBone8x, eval and training forward — port
of findnpropagate_tpu/models/backbones_3d/spconv_backbone.py (:84-323,
:373-802) in every mode of the reference. The two differ in their stages
only: two SparseBasicBlocks each (``blocks{s}_res{b}_conv1`` ...) in the
residual variant, two submanifold conv + BN + ReLU layers each
(``blocks{s}_conv{b}``, ``blocks{s}_bn{b}``, no bias) in the plain one;
``USE_BIAS`` (the residual blocks' conv bias) defaults to the variant's
residual switch, as in the reference.

The stages are built by `_make_stage` (per-stage kernels, block counts
and down kernels), which the VoxelNeXt, VoxelNeXt2D and PillarNet
backbones share; the posgather kernels take only 3-deep kernels, and the
submanifold convs only where the caller passes a positions cache, as in
the reference.

A level is one of
  ("sparse", grid, feats) — gather mode (``SUBM_MODE: gather``, the
      default): the active list in the voxelizer's order with its lookup
      table (ops/sparse_ops.py::SparseGrid, built once per level), feats
      (B, V, C);
  ("win", (ids, coords, valid, feats), shape) — windowed mode: the active
      list of each sample sorted by guard-banded (y, x, z) id (skipped
      under ``ASSUME_SORTED``), padded to a block multiple with ids in
      sentinel space; feats (B, V, C) float32;
  ("dense", x (B, C, nz, ny, nx), mask (B, nz, ny, nx)) — from
      DENSE_FROM_LEVEL on, in DENSE_DTYPE (bf16 at eval only).

Gather mode: every sparse conv gathers its 27 neighbours through the
level's table (`subm_conv`, `strided_conv`), strided convs first build the
next level's active set (`downsample_active_set`), then bias, masked BN
and ReLU; training differentiates through it with autograd.

Windowed mode, by ``SUBM_IMPL``:
  * ``xla``: the reference's XLA windowed conv (`sparse_ops.windowed_conv`)
    for every sparse conv, in eval and training, with the unfused tail;
  * ``posgather``: at eval the two posgather kernels (ops/posgather.py),
    one positions computation per level shared by its submanifold convs
    (`_level_ctx`) and one per strided conv; in training the
    differentiable posgather conv (`posgather_subm_diff`) for submanifold
    convs and the differentiable windowed conv (`windowed_conv_diff`) for
    strided ones;
  * ``pallas``: the union-window kernel (ops/windowed_sparse.py) for every
    sparse conv, differentiable in training.
At eval the kernels take bias + BN (+ReLU) in their epilogue (eval BN is an
affine map) unless ``FUSE_BN_EPILOGUE: False``; otherwise, and in
training, bias, padding mask, BN (batch statistics in training) and ReLU
follow the conv. The strided active sets are built by
``DOWNSAMPLE_IMPL``: ``dense`` (occupancy grid), ``sort``, ``scatter``, or
``auto`` (dense at batch <= 2, sort above). Dense levels use F.conv3d, as
the reference left them to XLA; at eval its mask, BN, the block's residual
and ReLU are one fused pass in place (ops/dense_epilogue.py).
``DENSE_CHUNK`` runs the dense tail at eval over that many batch chunks
(windowed mode, DENSE_FROM_LEVEL 2).

Outputs the four stages' levels as ``multi_scale_3d_features``
(``x_conv1`` ... ``x_conv4``, each in its mode's form above, its active
list in the reference's order), and keep the reference's telemetry in
every mode:
``sparse_active_counts`` (actives per level over the batch) and
``sparse_window_overflow`` (dropped-neighbour conditions; 0 = exact, and
always 0 in gather mode).

The yaml's per-tap sub-windows (TAP_WINDOW, STRIDED_TAP_WINDOW), sub-blocks
and WINDOWED_PRECISION are not read: they shape the TPU kernel's compare
plane, while the port's windowed convs search the whole union window in
float32. So the port ranks over the union window only, which also removes
the tap overflow the reference reports on the batch-8 nuScenes-scale
scenes (15 dropped (block, group) spans at the L0->L1 strided conv of one
scene). The dense output ``encoded_spconv_tensor`` is channels-first
(B, C, nz, ny, nx).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops import sparse_ops
from ...ops.dense_epilogue import dense_epilogue
from ...ops.posgather import (
    compute_positions,
    posgather_conv,
    posgather_subm_diff,
)
from ...ops.sparse_ops import (
    build_grid,
    coords_to_dense,
    downsample_active_set,
    sparse_to_dense,
    strided_base_ids,
    strided_conv,
    strided_deltas,
    strided_sentinel_start,
    subm_conv,
    win_downsample,
    win_downsample_dense,
    win_downsample_scatter,
    yxz_linear_ids,
    yxz_offset_deltas,
    yxz_sentinel_start,
)
from ...ops.windowed_sparse import windowed_conv, windowed_conv_diff
from ...utils import trace
from ..blocks import MaskedBatchNorm

IMPLS = ("xla", "posgather", "pallas")
DOWNSAMPLE = {"dense": win_downsample_dense, "sort": win_downsample,
              "scatter": win_downsample_scatter}


def conv_out_dim(n, k, s, p):
    return (n + 2 * p - k) // s + 1


def _dense_bn_act(y, mask, bnmod, relu, identity=None):
    """A dense conv's tail: zero outside `mask`, masked BN, the residual
    `identity` if given, ReLU (after the residual), zero outside `mask`
    again. At eval without autograd it is the fused epilogue
    (ops/dense_epilogue.py), in place on the conv's fresh output;
    otherwise PyTorch's operations."""
    if not (torch.is_grad_enabled() or bnmod.training):
        scale, shift = bnmod.affine()
        return dense_epilogue(y, mask, scale, shift, relu, identity)
    m = mask[:, None]
    y = bnmod(torch.where(m, y, torch.zeros_like(y)), mask)
    if identity is None:
        return torch.relu(y) if relu else y
    y = y + identity
    y = torch.relu(y) if relu else y
    return torch.where(m, y, torch.zeros_like(y))


class SparseConvParam(nn.Module):
    """One sparse conv's weights: kernel (K, Cin, Cout) zyx C-order."""

    def __init__(self, in_ch, out_ch, kernel=(3, 3, 3), use_bias=False):
        super().__init__()
        self.kernel_size = tuple(kernel)
        k = int(np.prod(kernel))
        self.kernel = nn.Parameter(torch.zeros(k, in_ch, out_ch))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def dense_weight(self, dtype):
        """(Cout, Cin, kz, ky, kx) for F.conv3d."""
        kz, ky, kx = self.kernel_size
        k, cin, cout = self.kernel.shape
        return self.kernel.reshape(kz, ky, kx, cin, cout).permute(
            4, 3, 0, 1, 2).to(dtype)


class _SparseStack(nn.Module):
    """What both backbone variants share; `residual` picks the stages,
    `block_counts` their blocks (the focal backbone's first stage has
    one)."""

    residual = True
    block_counts = (2, 2, 2, 2)

    def __init__(self, model_cfg, input_channels, grid_size, voxel_size=None,
                 point_cloud_range=None):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        # the grid's geometry (UNetV2 gives its voxel centres as points)
        self.voxel_size, self.point_cloud_range = (
            None if g is None else tuple(float(v) for v in g)
            for g in (voxel_size, point_cloud_range))
        self.windowed = str(cfg.get("SUBM_MODE", "gather")) == "windowed"
        self.impl = str(cfg.get("SUBM_IMPL", "xla")).lower()
        self.downsample = str(cfg.get("DOWNSAMPLE_IMPL", "auto")).lower()
        if self.impl not in IMPLS:
            raise ValueError(f"SUBM_IMPL {self.impl!r}: one of {IMPLS}")
        if self.downsample not in ("auto", *DOWNSAMPLE):
            raise ValueError(f"DOWNSAMPLE_IMPL {self.downsample!r}")
        self.fuse = bool(cfg.get("FUSE_BN_EPILOGUE", True))
        self.stage_blocks = {}
        self._build(int(input_channels), tuple(int(g) for g in grid_size))

    def _make_stage(self, s, cin, cout, down, num_blocks=2,
                    kernel=(3, 3, 3), down_kernel=None, use_bias=False):
        """Stage `s`'s modules under the reference's names: an opening
        strided conv ``blocks{s}_down`` (+ BN) when `down`, then
        `num_blocks` SparseBasicBlocks (residual) or conv + BN layers."""
        if down:
            self.add_module(f"blocks{s}_down", SparseConvParam(
                cin, cout, kernel=down_kernel or kernel))
            self.add_module(f"blocks{s}_down_bn", MaskedBatchNorm(cout))
            cin = cout
        for b in range(num_blocks):
            if not self.residual:
                self.add_module(f"blocks{s}_conv{b}", SparseConvParam(
                    cin if b == 0 else cout, cout, kernel=kernel))
                self.add_module(f"blocks{s}_bn{b}", MaskedBatchNorm(cout))
                continue
            self.add_module(f"blocks{s}_res{b}_conv1", SparseConvParam(
                cin, cout, kernel=kernel, use_bias=use_bias))
            self.add_module(f"blocks{s}_res{b}_bn1", MaskedBatchNorm(cout))
            self.add_module(f"blocks{s}_res{b}_conv2", SparseConvParam(
                cout, cout, kernel=kernel, use_bias=use_bias))
            self.add_module(f"blocks{s}_res{b}_bn2", MaskedBatchNorm(cout))
        self.stage_blocks[s] = num_blocks

    def _build(self, input_channels, grid_size):
        """The 8x stack: input conv, four stages, the (3, 1, 1) output
        conv over z."""
        cfg = self.model_cfg
        nx, ny, nz = grid_size
        s1 = (nz + 1, ny, nx)
        s2 = tuple(conv_out_dim(n, 3, 2, 1) for n in s1)
        s3 = tuple(conv_out_dim(n, 3, 2, 1) for n in s2)
        s4 = (conv_out_dim(s3[0], 3, 2, 0), conv_out_dim(s3[1], 3, 2, 1),
              conv_out_dim(s3[2], 3, 2, 1))
        s_out = (conv_out_dim(s4[0], 3, 2, 0), s4[1], s4[2])
        self.level_shapes = [s1, s2, s3, s4, s_out]
        chans = [int(c) for c in cfg.get("CHANNELS", [16, 16, 32, 64, 128])]
        self.out_channels = int(cfg.get("OUT_CHANNELS", 128))
        use_bias = bool(cfg.get("USE_BIAS", self.residual))
        c0 = int(cfg.get("MAX_VOXELS", 60000))
        caps = cfg.get("LEVEL_CAPACITIES", None) or [
            c0, c0, c0 // 2, c0 // 4, c0 // 8]
        self.caps = [int(c) for c in caps]

        _, c1, c2, c3, c4 = chans
        self.level_channels = {"x_conv1": c1, "x_conv2": c2, "x_conv3": c3,
                               "x_conv4": c4}
        self.w_input = SparseConvParam(input_channels, c1)
        self.bn_input = MaskedBatchNorm(c1)
        for s, (cin, cout, down) in enumerate(
                [(c1, c1, False), (c1, c2, True), (c2, c3, True),
                 (c3, c4, True)], start=1):
            self._make_stage(s, cin, cout, down,
                             num_blocks=self.block_counts[s - 1],
                             use_bias=use_bias)
        self.w_out = SparseConvParam(c4, self.out_channels, kernel=(3, 1, 1))
        self.bn_out = MaskedBatchNorm(self.out_channels)

    @property
    def num_point_features(self):
        return self.out_channels

    # ---- config knobs --------------------------------------------------

    @staticmethod
    def _per_level(val, level, default=None):
        if val is None:
            return default
        if isinstance(val, (list, tuple)):
            val = val[min(level, len(val) - 1)]
        val = int(val)
        return val if val > 0 else default

    def _level_index(self, shape):
        for i, s in enumerate(self.level_shapes):
            if tuple(s) == tuple(shape):
                return i
        return 0

    def _win_cfg(self, level=0):
        cfg = self.model_cfg
        block = int(cfg.get("WINDOWED_BLOCK", 640))
        window = self._per_level(cfg.get("WINDOWED_WINDOW", 1024), level)
        swindow = self._per_level(cfg.get("WINDOWED_STRIDED_WINDOW", None),
                                  level, 4 * window)
        return block, window, swindow

    def _dense_dtype(self):
        name = str(self.model_cfg.get("DENSE_DTYPE", "f32")).lower()
        if name in ("bf16", "bfloat16") and not self.training:
            return torch.bfloat16
        return torch.float32

    # ---- levels ----------------------------------------------------------

    @trace.spanned("active_set")
    def _win_entry(self, coords, valid, feats, shape):
        block = self._win_cfg()[0]
        ids = yxz_linear_ids(coords, valid, shape)
        if not bool(self.model_cfg.get("ASSUME_SORTED", False)):
            ids, order = torch.sort(ids, dim=1, stable=True)
            coords = torch.gather(coords, 1,
                                  order[..., None].expand(-1, -1, 3))
            valid = torch.gather(valid, 1, order)
            feats = torch.gather(feats, 1, order[..., None].expand(
                -1, -1, feats.shape[2]))
        pad = (-ids.shape[1]) % block
        if pad:
            start = torch.clamp(ids[:, -1:] + 1,
                                min=yxz_sentinel_start(shape))
            ids = torch.cat([ids, start + torch.arange(
                pad, dtype=ids.dtype, device=ids.device)], dim=1)
            coords = F.pad(coords, (0, 0, 0, pad), value=-1)
            valid = F.pad(valid, (0, pad))
            feats = F.pad(feats, (0, 0, 0, pad))
        return ("win", (ids, coords, valid, feats.float()), shape)

    def _to_dense(self, level):
        kind, a, m = level
        if kind == "dense":
            return level
        dtype = self._dense_dtype()
        if kind == "win":
            ids, coords, valid, feats = a
            x = coords_to_dense(coords, valid, feats.to(dtype), m)
            ones = feats.new_ones(feats.shape[0], feats.shape[1], 1)
            mask = coords_to_dense(coords, valid, ones, m)[:, 0] > 0
            return ("dense", x, mask)
        x = sparse_to_dense(a, m.to(dtype))
        ones = m.new_ones(m.shape[0], m.shape[1], 1)
        return ("dense", x, sparse_to_dense(a, ones)[:, 0] > 0)

    def _posgather_ctx(self, ctx_cache, kernel):
        """Whether a submanifold conv runs on the posgather kernels: in
        posgather mode, for a 3-deep kernel, where the caller shares a
        positions cache (VoxelNeXt's convs pass none) — the reference's
        dispatch."""
        return (self.impl == "posgather" and ctx_cache is not None
                and kernel[0] == 3)

    def _level_ctx(self, ctx_cache, ids, shape, lvl_i, kernel, ovf_acc):
        key = (id(ids), tuple(kernel))
        if key not in ctx_cache:
            block, window, _ = self._win_cfg(lvl_i)
            ctx = compute_positions(
                ids, ids, yxz_offset_deltas(kernel, shape), block=block,
                window=window,
                sentinel_start=yxz_sentinel_start(shape))
            ovf_acc.append(ctx.overflow.sum())
            ctx_cache[key] = (ctx, ids)
        return ctx_cache[key][0]

    def _tail(self, out, wmod, bnmod, valid, relu):
        """The unfused tail of a sparse conv: bias, padding mask, BN
        (batch statistics in training), ReLU."""
        if wmod.bias is not None:
            out = out + wmod.bias
        out = torch.where(valid[..., None], out, torch.zeros_like(out))
        out = bnmod(out, valid, channels_last=True)
        return torch.relu(out) if relu else out

    def _sparse_conv(self, src_ids, feats, tgt_ids, wmod, bnmod, ctx, deltas,
                     window, sent, relu, tgt_valid, ovf_acc):
        """One windowed-mode sparse conv + bias + BN (+ReLU) over a
        (source, target) id pair. `ctx`: the posgather positions (posgather
        eval, and its training submanifold convs), else None."""
        block = self._win_cfg()[0]
        kernel = wmod.kernel
        if self.impl == "xla":
            out, ovf = sparse_ops.windowed_conv(
                src_ids, feats, tgt_ids, kernel, deltas, block=block,
                window=window, sentinel_start=sent)
            ovf_acc.append(ovf.sum())
        elif self.training:
            if ctx is not None:
                out = posgather_subm_diff(src_ids, feats, kernel, deltas,
                                          ctx, dw_block=block,
                                          dw_window=window)
            else:
                out, ovf = windowed_conv_diff(src_ids, feats, tgt_ids,
                                              kernel, deltas, block=block,
                                              window=window,
                                              sentinel_start=sent)
                ovf_acc.append(ovf.sum())
        else:
            epi = {}
            if self.fuse:
                scale, shift = bnmod.affine()
                if wmod.bias is not None:
                    shift = shift + scale * wmod.bias
                epi = dict(scale=scale, shift=shift, relu=relu)
            if ctx is not None:
                out = posgather_conv(src_ids, feats, tgt_ids, kernel, ctx,
                                     sentinel_start=sent, **epi)
            else:
                out, ovf = windowed_conv(src_ids, feats, tgt_ids, kernel,
                                         deltas, block=block, window=window,
                                         sentinel_start=sent, **epi)
                ovf_acc.append(ovf.sum())
            if epi:
                return out
        return self._tail(out, wmod, bnmod, tgt_valid, relu)

    def _subm(self, level, wmod, bnmod, ovf_acc, ctx_cache, relu=True,
              identity=None):
        """One submanifold conv + BN (+ReLU). `identity`: a dense level's
        residual, added before the ReLU."""
        kind, a, m = level
        kernel = wmod.kernel_size
        if kind == "sparse":
            out = subm_conv(a, m, wmod.kernel, wmod.bias, kernel_size=kernel)
            out = bnmod(out, a.valid, channels_last=True)
            return ("sparse", a, torch.relu(out) if relu else out)
        if kind == "win":
            ids, coords, valid, feats = a
            lvl_i = self._level_index(m)
            ctx = self._level_ctx(ctx_cache, ids, m, lvl_i, kernel, ovf_acc) \
                if self._posgather_ctx(ctx_cache, kernel) else None
            out = self._sparse_conv(
                ids, feats, ids, wmod, bnmod, ctx,
                yxz_offset_deltas(kernel, m), self._win_cfg(lvl_i)[1],
                yxz_sentinel_start(m), relu, valid, ovf_acc)
            return ("win", (ids, coords, valid, out), m)
        with trace.span("dense_conv"):
            w = wmod.dense_weight(a.dtype)
            b = wmod.bias.to(a.dtype) if wmod.bias is not None else None
            y = F.conv3d(a, w, b,
                         padding=tuple((k - 1) // 2 for k in kernel))
            return ("dense", _dense_bn_act(y, m, bnmod, relu, identity), m)

    def _down(self, level, wmod, bnmod, out_shape, cap, ovf_acc,
              stride=(2, 2, 2), padding=(1, 1, 1), dense_out=False):
        kind, a, m = level
        kernel = wmod.kernel_size
        if kind == "sparse":
            with torch.no_grad(), trace.span("active_set"):
                oc, ov = downsample_active_set(a, out_shape, cap,
                                               kernel_size=kernel,
                                               stride=stride, padding=padding)
                grid = build_grid(oc, ov, out_shape)
            out = strided_conv(a, m, grid, wmod.kernel, wmod.bias,
                               kernel_size=kernel, stride=stride,
                               padding=padding)
            out = torch.relu(bnmod(out, grid.valid, channels_last=True))
            level = ("sparse", grid, out)
            return self._to_dense(level) \
                if dense_out else level
        if kind == "win":
            ids, coords, valid, feats = a
            in_shape = m
            lvl_i = self._level_index(in_shape)
            block, _, swindow = self._win_cfg(lvl_i)
            cap = -(-cap // block) * block
            ds = self.downsample
            if ds == "auto":
                # the dense occupancy grid is fastest at small batch and
                # costs a grid per sample; the sort scales with the actives
                ds = "dense" if coords.shape[0] <= 2 else "sort"
            with torch.no_grad(), trace.span("active_set"):
                oi, oc, ov = DOWNSAMPLE[ds](
                    coords, valid, in_shape, out_shape, cap,
                    kernel_size=kernel, stride=stride, padding=padding)
                base = strided_base_ids(oc, ov, stride, in_shape, out_shape)
            sent = strided_sentinel_start(in_shape)
            deltas = strided_deltas(kernel, stride, padding, in_shape)
            ctx = None
            if self.impl == "posgather" and not self.training \
                    and kernel[0] == 3:
                ctx = compute_positions(ids, base, deltas, block=block,
                                        window=swindow, sentinel_start=sent)
                ovf_acc.append(ctx.overflow.sum())
            out = self._sparse_conv(ids, feats, base, wmod, bnmod, ctx,
                                    deltas, swindow, sent, True, ov, ovf_acc)
            level = ("win", (oi, oc, ov, out), out_shape)
            return self._to_dense(level) \
                if dense_out else level
        with trace.span("dense_conv"):
            w = wmod.dense_weight(a.dtype)
            b = wmod.bias.to(a.dtype) if wmod.bias is not None else None
            y = F.conv3d(a, w, b, stride=stride, padding=padding)
            new_mask = F.max_pool3d(m[:, None].float(), kernel, stride,
                                    padding)[:, 0] > 0
            return ("dense", _dense_bn_act(y, new_mask, bnmod, True),
                    new_mask)

    def _blocks(self, stage, level, ovf_acc, ctx_cache):
        n_blocks = self.stage_blocks[stage]
        if not self.residual:
            for blk in range(n_blocks):
                level = self._subm(level,
                                   getattr(self, f"blocks{stage}_conv{blk}"),
                                   getattr(self, f"blocks{stage}_bn{blk}"),
                                   ovf_acc, ctx_cache)
            return level
        for blk in range(n_blocks):
            kind, a, m = level
            identity = a[3] if kind == "win" else m if kind == "sparse" \
                else a
            level = self._subm(level, getattr(self, f"blocks{stage}_res{blk}"
                                                    "_conv1"),
                               getattr(self, f"blocks{stage}_res{blk}_bn1"),
                               ovf_acc, ctx_cache)
            # a dense level's residual and ReLU are the conv's tail
            dense = kind == "dense"
            level = self._subm(level, getattr(self, f"blocks{stage}_res{blk}"
                                                    "_conv2"),
                               getattr(self, f"blocks{stage}_res{blk}_bn2"),
                               ovf_acc, ctx_cache, relu=dense,
                               identity=identity if dense else None)
            kind, a, m = level
            if kind == "win":
                ids, coords, valid, feats = a
                out = torch.relu(feats + identity)
                out = torch.where(valid[..., None], out,
                                  torch.zeros_like(out))
                level = ("win", (ids, coords, valid, out), m)
            elif kind == "sparse":
                out = torch.relu(m + identity)
                level = ("sparse", a, torch.where(
                    a.valid[..., None], out, torch.zeros_like(out)))
        return level

    def _dense_tail(self, level, ovf_acc, ctx_cache, dense_from):
        """Levels 3, 4 and the output conv: (lvl3, lvl4, dense output)."""
        _, _, s3, s4, s_out = self.level_shapes
        level = self._down(level, self.blocks3_down, self.blocks3_down_bn,
                           s3, self.caps[3], ovf_acc,
                           dense_out=dense_from <= 2)
        lvl3 = level = self._blocks(3, level, ovf_acc, ctx_cache)
        level = self._down(level, self.blocks4_down, self.blocks4_down_bn,
                           s4, self.caps[4], ovf_acc, padding=(0, 1, 1),
                           dense_out=dense_from <= 3)
        lvl4 = level = self._blocks(4, level, ovf_acc, ctx_cache)
        level = self._down(level, self.w_out, self.bn_out, s_out,
                           self.caps[4], ovf_acc, stride=(2, 1, 1),
                           padding=(0, 0, 0), dense_out=dense_from <= 4)
        return lvl3, lvl4, self._to_dense(level)

    def _chunked_tail(self, level, chunks, ovf_acc, ctx_cache, dense_from):
        """DENSE_CHUNK: the dense tail over `chunks` batch chunks in turn,
        so its dense temporaries peak at chunk/B of their size."""
        _, arrs, shape = level
        split = [t.chunk(chunks) for t in arrs]
        parts = [self._dense_tail(("win", tuple(c[i] for c in split), shape),
                                  ovf_acc, ctx_cache, dense_from)
                 for i in range(chunks)]

        def cat(j):
            return ("dense", torch.cat([p[j][1] for p in parts]),
                    torch.cat([p[j][2] for p in parts]))
        return cat(0), cat(1), cat(2)

    def forward(self, batch):
        feats = batch["voxel_features"]
        coords = batch["voxel_coords"]
        valid = batch["voxel_mask"]
        s1, s2, s3, s4, s_out = self.level_shapes
        dense_from = int(self.model_cfg.get("DENSE_FROM_LEVEL", 1))
        ovf_acc, ctx_cache = [], {}

        if self.windowed:
            level = self._win_entry(coords, valid, feats, s1)
        else:
            with torch.no_grad(), trace.span("active_set"):
                grid = build_grid(coords, valid, s1)
            level = ("sparse", grid, feats.float())
        if dense_from <= 0:
            level = self._to_dense(level)
        level = self._subm(level, self.w_input, self.bn_input, ovf_acc,
                           ctx_cache)
        lvl1 = level = self._blocks(1, level, ovf_acc, ctx_cache)
        level = self._down(level, self.blocks2_down, self.blocks2_down_bn,
                           s2, self.caps[2], ovf_acc,
                           dense_out=dense_from <= 1)
        lvl2 = level = self._blocks(2, level, ovf_acc, ctx_cache)
        chunks = int(self.model_cfg.get("DENSE_CHUNK", 1))
        if (chunks > 1 and not self.training and dense_from == 2
                and level[0] == "win" and feats.shape[0] % chunks == 0):
            lvl3, lvl4, level = self._chunked_tail(level, chunks, ovf_acc,
                                                   ctx_cache, dense_from)
        else:
            lvl3, lvl4, level = self._dense_tail(level, ovf_acc, ctx_cache,
                                                 dense_from)

        batch["encoded_spconv_tensor"] = level[1].float()
        batch["encoded_spconv_tensor_stride"] = 8
        batch["multi_scale_3d_features"] = {
            "x_conv1": lvl1, "x_conv2": lvl2, "x_conv3": lvl3,
            "x_conv4": lvl4}

        def count(lv):
            kind, a, m = lv
            return (a[2] if kind == "win" else a.valid if kind == "sparse"
                    else m).sum()

        batch["sparse_active_counts"] = torch.stack(
            [count(lv) for lv in (lvl1, lvl2, lvl3, lvl4)])
        batch["sparse_window_overflow"] = torch.stack(ovf_acc).sum() \
            if ovf_acc else torch.zeros((), dtype=torch.int64,
                                        device=feats.device)
        return batch


class VoxelResBackBone8x(_SparseStack):
    """Residual variant (two SparseBasicBlocks per stage), TransFusion's
    and CenterPoint's."""

    residual = True


class VoxelBackBone8x(_SparseStack):
    """Plain variant (two submanifold conv layers per stage), SECOND's and
    CenterPoint's."""

    residual = False
