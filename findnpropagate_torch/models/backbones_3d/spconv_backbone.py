"""VoxelResBackBone8x, eval and training forward — port of
findnpropagate_tpu/models/backbones_3d/spconv_backbone.py (:84-323,
:373-782) on its windowed branches (``SUBM_MODE: windowed`` with
``SUBM_IMPL: posgather`` or ``pallas``).

A level is either
  ("win", (ids, coords, valid, feats), shape) — the active list of each
      sample sorted by guard-banded (y, x, z) id, padded to a block
      multiple with ids in sentinel space; feats (B, V, C) float32; or
  ("dense", x (B, C, nz, ny, nx), mask (B, nz, ny, nx)) — from
      DENSE_FROM_LEVEL on, in DENSE_DTYPE (bf16 at eval only).

Eval, ``posgather``: sparse levels run the two posgather kernels
(ops/posgather.py): one positions computation per level shared by its
submanifold convs (`_level_ctx`), one per strided conv, and every conv with
bias + BN (+ReLU) fused into the kernel's epilogue. Eval, ``pallas``: every
sparse conv runs the union-window kernel (ops/windowed_sparse.py) with the
same fused epilogue. Training (``self.training``): submanifold convs run
the differentiable posgather conv (`posgather_subm_diff`; the windowed one
under ``pallas``), strided convs the differentiable windowed conv
(`windowed_conv_diff`), each followed by bias, padding mask, batch-statistic
BN and ReLU unfused, and the dense tail stays float32. Dense levels use
F.conv3d, as the reference left them to XLA. Outputs keep the reference's
telemetry:
``sparse_active_counts`` (actives per level over the batch) and
``sparse_window_overflow`` (dropped-neighbour conditions; 0 = exact).

The yaml's per-tap sub-windows (TAP_WINDOW, STRIDED_TAP_WINDOW) are not
read: they narrow the TPU kernel's compare plane, while the CUDA positions
kernel binary-searches the whole union window in about one more step. So
the port ranks over the union window only, which also removes the tap
overflow the reference reports on the batch-8 nuScenes-scale scenes (15
dropped (block, group) spans at the L0->L1 strided conv of one scene).
The dense output ``encoded_spconv_tensor`` is channels-first
(B, C, nz, ny, nx).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.posgather import (
    compute_positions,
    posgather_conv,
    posgather_subm_diff,
)
from ...ops.sparse_ops import (
    coords_to_dense,
    strided_base_ids,
    strided_deltas,
    strided_sentinel_start,
    win_downsample,
    win_downsample_dense,
    yxz_linear_ids,
    yxz_offset_deltas,
    yxz_sentinel_start,
)
from ...ops.windowed_sparse import windowed_conv, windowed_conv_diff
from ..blocks import MaskedBatchNorm


def conv_out_dim(n, k, s, p):
    return (n + 2 * p - k) // s + 1


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


class VoxelResBackBone8x(nn.Module):
    """Residual sparse backbone (two SparseBasicBlocks per stage)."""

    def __init__(self, model_cfg, input_channels, grid_size):
        super().__init__()
        cfg = model_cfg
        self.model_cfg = cfg
        self.impl = str(cfg.get("SUBM_IMPL", "xla")).lower()
        if str(cfg.get("SUBM_MODE", "gather")) != "windowed" \
                or self.impl not in ("posgather", "pallas"):
            raise NotImplementedError(
                "the port runs the SUBM_MODE: windowed backbone with "
                "SUBM_IMPL: posgather or pallas only; the gather / XLA "
                "backbone modes are ROADMAP.md queue 1 item 15")
        nx, ny, nz = (int(g) for g in grid_size)
        s1 = (nz + 1, ny, nx)
        s2 = tuple(conv_out_dim(n, 3, 2, 1) for n in s1)
        s3 = tuple(conv_out_dim(n, 3, 2, 1) for n in s2)
        s4 = (conv_out_dim(s3[0], 3, 2, 0), conv_out_dim(s3[1], 3, 2, 1),
              conv_out_dim(s3[2], 3, 2, 1))
        s_out = (conv_out_dim(s4[0], 3, 2, 0), s4[1], s4[2])
        self.level_shapes = [s1, s2, s3, s4, s_out]
        chans = [int(c) for c in cfg.get("CHANNELS", [16, 16, 32, 64, 128])]
        self.out_channels = int(cfg.get("OUT_CHANNELS", 128))
        use_bias = bool(cfg.get("USE_BIAS", True))
        c0 = int(cfg.get("MAX_VOXELS", 60000))
        caps = cfg.get("LEVEL_CAPACITIES", None) or [
            c0, c0, c0 // 2, c0 // 4, c0 // 8]
        self.caps = [int(c) for c in caps]

        _, c1, c2, c3, c4 = chans
        self.w_input = SparseConvParam(input_channels, c1)
        self.bn_input = MaskedBatchNorm(c1)
        for s, (cin, cout, down) in enumerate(
                [(c1, c1, False), (c1, c2, True), (c2, c3, True),
                 (c3, c4, True)], start=1):
            if down:
                self.add_module(f"blocks{s}_down", SparseConvParam(cin, cout))
                self.add_module(f"blocks{s}_down_bn", MaskedBatchNorm(cout))
                cin = cout
            for b in range(2):
                self.add_module(f"blocks{s}_res{b}_conv1", SparseConvParam(
                    cin, cout, use_bias=use_bias))
                self.add_module(f"blocks{s}_res{b}_bn1", MaskedBatchNorm(cout))
                self.add_module(f"blocks{s}_res{b}_conv2", SparseConvParam(
                    cout, cout, use_bias=use_bias))
                self.add_module(f"blocks{s}_res{b}_bn2", MaskedBatchNorm(cout))
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

    def _win_entry(self, coords, valid, feats, shape):
        block = self._win_cfg()[0]
        ids = yxz_linear_ids(coords, valid, shape)
        ids, order = torch.sort(ids, dim=1, stable=True)
        coords = torch.gather(coords, 1, order[..., None].expand(-1, -1, 3))
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

    def _to_dense(self, level, dtype):
        kind, a, shape = level
        if kind == "dense":
            return level
        ids, coords, valid, feats = a
        x = coords_to_dense(coords, valid, feats.to(dtype), shape)
        ones = feats.new_ones(feats.shape[0], feats.shape[1], 1)
        mask = coords_to_dense(coords, valid, ones, shape)[:, 0] > 0
        return ("dense", x, mask)

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

    def _sparse_conv(self, src_ids, feats, tgt_ids, wmod, bnmod, ctx, deltas,
                     window, sent, relu, tgt_valid, ovf_acc):
        """One sparse conv + bias + BN (+ReLU) over a (source, target) id
        pair. Eval: fused into the kernel's epilogue (eval BN is an affine
        map) — the posgather kernel over `ctx`, or the windowed kernel when
        ctx is None. Training: the differentiable conv, then the unfused
        tail with batch statistics."""
        block = self._win_cfg()[0]
        if not self.training:
            scale, shift = bnmod.affine()
            if wmod.bias is not None:
                shift = shift + scale * wmod.bias
            if ctx is not None:
                return posgather_conv(src_ids, feats, tgt_ids, wmod.kernel,
                                      ctx, scale=scale, shift=shift,
                                      relu=relu, sentinel_start=sent)
            out, ovf = windowed_conv(src_ids, feats, tgt_ids, wmod.kernel,
                                     deltas, block=block, window=window,
                                     sentinel_start=sent, scale=scale,
                                     shift=shift, relu=relu)
            ovf_acc.append(ovf.sum())
            return out
        if ctx is not None:
            out = posgather_subm_diff(src_ids, feats, wmod.kernel, deltas,
                                      ctx, dw_block=block, dw_window=window)
        else:
            out, ovf = windowed_conv_diff(src_ids, feats, tgt_ids,
                                          wmod.kernel, deltas, block=block,
                                          window=window, sentinel_start=sent)
            ovf_acc.append(ovf.sum())
        if wmod.bias is not None:
            out = out + wmod.bias
        out = torch.where(tgt_valid[..., None], out, torch.zeros_like(out))
        out = bnmod(out, tgt_valid, channels_last=True)
        return torch.relu(out) if relu else out

    def _subm(self, level, wmod, bnmod, ovf_acc, ctx_cache, relu=True):
        kind, a, m = level
        if kind == "win":
            ids, coords, valid, feats = a
            kernel = wmod.kernel_size
            lvl_i = self._level_index(m)
            ctx = self._level_ctx(ctx_cache, ids, m, lvl_i, kernel, ovf_acc) \
                if self.impl == "posgather" else None
            out = self._sparse_conv(
                ids, feats, ids, wmod, bnmod, ctx,
                yxz_offset_deltas(kernel, m), self._win_cfg(lvl_i)[1],
                yxz_sentinel_start(m), relu, valid, ovf_acc)
            return ("win", (ids, coords, valid, out), m)
        w = wmod.dense_weight(a.dtype)
        b = wmod.bias.to(a.dtype) if wmod.bias is not None else None
        y = F.conv3d(a, w, b, padding=tuple(
            (k - 1) // 2 for k in wmod.kernel_size))
        y = torch.where(m[:, None], y, torch.zeros_like(y))
        y = bnmod(y, m)
        return ("dense", torch.relu(y) if relu else y, m)

    def _down(self, level, wmod, bnmod, out_shape, cap, ovf_acc,
              stride=(2, 2, 2), padding=(1, 1, 1), dense_out=False):
        kind, a, m = level
        kernel = wmod.kernel_size
        if kind == "win":
            ids, coords, valid, feats = a
            in_shape = m
            lvl_i = self._level_index(in_shape)
            block, _, swindow = self._win_cfg(lvl_i)
            cap = -(-cap // block) * block
            # the dense occupancy grid is fastest at small batch and costs
            # a grid per sample; the sort scales with the actives
            ds_fn = win_downsample_dense if coords.shape[0] <= 2 \
                else win_downsample
            with torch.no_grad():
                oi, oc, ov = ds_fn(coords, valid, in_shape, out_shape, cap,
                                   kernel_size=kernel, stride=stride,
                                   padding=padding)
                base = strided_base_ids(oc, ov, stride, in_shape, out_shape)
            sent = strided_sentinel_start(in_shape)
            deltas = strided_deltas(kernel, stride, padding, in_shape)
            ctx = None
            if self.impl == "posgather" and not self.training:
                ctx = compute_positions(ids, base, deltas, block=block,
                                        window=swindow, sentinel_start=sent)
                ovf_acc.append(ctx.overflow.sum())
            out = self._sparse_conv(ids, feats, base, wmod, bnmod, ctx,
                                    deltas, swindow, sent, True, ov, ovf_acc)
            level = ("win", (oi, oc, ov, out), out_shape)
            return self._to_dense(level, self._dense_dtype()) \
                if dense_out else level
        w = wmod.dense_weight(a.dtype)
        b = wmod.bias.to(a.dtype) if wmod.bias is not None else None
        y = F.conv3d(a, w, b, stride=stride, padding=padding)
        new_mask = F.max_pool3d(m[:, None].float(), kernel, stride,
                                padding)[:, 0] > 0
        y = torch.where(new_mask[:, None], y, torch.zeros_like(y))
        y = torch.relu(bnmod(y, new_mask))
        return ("dense", y, new_mask)

    def _blocks(self, stage, level, ovf_acc, ctx_cache):
        for blk in range(2):
            kind, a, m = level
            identity = a[3] if kind == "win" else a
            level = self._subm(level, getattr(self, f"blocks{stage}_res{blk}"
                                                    "_conv1"),
                               getattr(self, f"blocks{stage}_res{blk}_bn1"),
                               ovf_acc, ctx_cache)
            level = self._subm(level, getattr(self, f"blocks{stage}_res{blk}"
                                                    "_conv2"),
                               getattr(self, f"blocks{stage}_res{blk}_bn2"),
                               ovf_acc, ctx_cache, relu=False)
            kind, a, m = level
            if kind == "win":
                ids, coords, valid, feats = a
                out = torch.relu(feats + identity)
                out = torch.where(valid[..., None], out,
                                  torch.zeros_like(out))
                level = ("win", (ids, coords, valid, out), m)
            else:
                out = torch.relu(a + identity)
                level = ("dense", torch.where(m[:, None], out,
                                              torch.zeros_like(out)), m)
        return level

    def forward(self, batch):
        feats = batch["voxel_features"]
        coords = batch["voxel_coords"]
        valid = batch["voxel_mask"]
        s1, s2, s3, s4, s_out = self.level_shapes
        dense_from = int(self.model_cfg.get("DENSE_FROM_LEVEL", 1))
        dt = self._dense_dtype()
        ovf_acc, ctx_cache = [], {}

        level = self._win_entry(coords, valid, feats, s1)
        level = self._subm(level, self.w_input, self.bn_input, ovf_acc,
                           ctx_cache)
        level = self._blocks(1, level, ovf_acc, ctx_cache)
        lvl1 = level
        level = self._down(level, self.blocks2_down, self.blocks2_down_bn,
                           s2, self.caps[2], ovf_acc,
                           dense_out=dense_from <= 1)
        level = self._blocks(2, level, ovf_acc, ctx_cache)
        lvl2 = level
        level = self._down(level, self.blocks3_down, self.blocks3_down_bn,
                           s3, self.caps[3], ovf_acc,
                           dense_out=dense_from <= 2)
        level = self._blocks(3, level, ovf_acc, ctx_cache)
        lvl3 = level
        level = self._down(level, self.blocks4_down, self.blocks4_down_bn,
                           s4, self.caps[4], ovf_acc, padding=(0, 1, 1),
                           dense_out=dense_from <= 3)
        level = self._blocks(4, level, ovf_acc, ctx_cache)
        lvl4 = level
        level = self._down(level, self.w_out, self.bn_out, s_out,
                           self.caps[4], ovf_acc, stride=(2, 1, 1),
                           padding=(0, 0, 0), dense_out=dense_from <= 4)
        level = self._to_dense(level, dt)

        batch["encoded_spconv_tensor"] = level[1].float()
        batch["encoded_spconv_tensor_stride"] = 8

        def count(lv):
            return lv[1][2].sum() if lv[0] == "win" else lv[2].sum()

        batch["sparse_active_counts"] = torch.stack(
            [count(lv) for lv in (lvl1, lvl2, lvl3, lvl4)])
        batch["sparse_window_overflow"] = torch.stack(ovf_acc).sum()
        return batch
