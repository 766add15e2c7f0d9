"""VoxelResBackBone8xVoxelNeXt, VoxelNeXt's fully sparse backbone — port of
findnpropagate_tpu/models/backbones_3d/spconv_backbone_voxelnext.py
(:31-173).

The residual 8x stack of spconv_backbone.py extended to six stages: stage
k >= 2 opens with a stride-2 conv whose kernel is SPCONV_KERNEL_SIZES[k-2]
(3, or 5 in the Waymo large yaml, padding k // 2, which keeps the shapes of
the 3x3x3 case; stage 6's is 3). The active cells of stages 5 and 6 are
scaled (x2, x4) into the stride-8 grid of stage 4 and the three levels
collapse over z onto one sorted (1, ny, nx) list, coinciding cells summed
(`sparse_ops.bev_merge`, MAX_BEV_VOXELS cells), padded to a block multiple;
then a dilating (1, 3, 3) sparse conv (stride 1: its output capacity is the
BEV list's length) and a submanifold (1, 3, 3) shared conv with bias. No
dense map is built: the head reads ``encoded_sparse_bev``.

The windowed pipeline only (SUBM_MODE windowed), in each SUBM_IMPL of the
reference: the submanifold convs are given no positions cache, as the
reference gives none, so in posgather mode they run on K3 (union-window)
and only the 3x3x3 strided convs at eval on K1 + K2; the 5x5x5 and (1, 3,
3) convs take K3 with tap groups of five and of one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.sparse_ops import bev_merge
from ..blocks import MaskedBatchNorm
from .spconv_backbone import SparseConvParam, _SparseStack, conv_out_dim

K2D = (1, 3, 3)


def collect(level):
    """(coords, valid, feats) of a windowed level."""
    _, (_, coords, valid, feats), _ = level
    return coords, valid, feats


def sparse_bev_out(bb, levels, ovf_acc):
    """The BEV stage both VoxelNeXt backbones share: levels 4, 5, 6 merged
    into the stride-8 (1, ny, nx) list, padded to the block with ascending
    ids above the last, the dilating conv_out and the submanifold
    shared_conv. Returns the final windowed level."""
    parts = [collect(lv) for lv in levels]
    ids, coords, valid, feats = bev_merge(
        [p[0] for p in parts], [p[1] for p in parts], [p[2] for p in parts],
        (1, 2, 4), bb.bev_shape, bb.max_bev)
    block = bb._win_cfg()[0]
    pad = (-ids.shape[1]) % block
    if pad:
        ids = torch.cat([ids, ids[:, -1:] + 1 + torch.arange(
            pad, dtype=ids.dtype, device=ids.device)], dim=1)
        coords = F.pad(coords, (0, 0, 0, pad), value=-1)
        valid = F.pad(valid, (0, pad))
        feats = F.pad(feats, (0, 0, 0, pad))
    shape2d = (1,) + tuple(bb.bev_shape)
    level = ("win", (ids, coords, valid, feats), shape2d)
    level = bb._down(level, bb.w_out, bb.bn_out, shape2d, ids.shape[1],
                     ovf_acc, stride=(1, 1, 1), padding=(0, 1, 1))
    return bb._subm(level, bb.w_shared, bb.bn_shared, ovf_acc, None)


def sparse_bev_outputs(bb, batch, level, ovf_acc, feats):
    """The batch keys of the sparse BEV output."""
    ids, coords, valid, out = level[1]
    batch["encoded_sparse_bev"] = {"ids": ids, "coords": coords,
                                   "valid": valid, "features": out}
    batch["encoded_sparse_bev_shape"] = tuple(bb.bev_shape)
    batch["encoded_spconv_tensor_stride"] = 8
    batch["sparse_window_overflow"] = torch.stack(ovf_acc).sum() \
        if ovf_acc else torch.zeros((), dtype=torch.int64,
                                    device=feats.device)
    return batch


class VoxelResBackBone8xVoxelNeXt(_SparseStack):
    residual = True

    def _build(self, input_channels, grid_size):
        cfg = self.model_cfg
        nx, ny, nz = grid_size
        chans = [int(c) for c in cfg.get("CHANNELS", [16, 32, 64, 128, 128])]
        self.chans = chans
        self.out_channels = int(cfg.get("OUT_CHANNEL", 128))
        use_bias = bool(cfg.get("USE_BIAS", True))
        c0 = int(cfg.get("MAX_VOXELS", 60000))
        caps = cfg.get("LEVEL_CAPACITIES", None) or [
            c0, c0, c0 // 2, c0 // 4, c0 // 8, c0 // 16, c0 // 32]
        self.caps = [int(c) for c in caps]
        self.max_bev = int(cfg.get("MAX_BEV_VOXELS", self.caps[4] * 2))
        if chans[3] != chans[4]:
            raise ValueError("VoxelNeXt sums conv4/conv5/conv6 rows, so "
                             "CHANNELS[3] must equal CHANNELS[4]")
        ks = [int(v) for v in cfg.get("SPCONV_KERNEL_SIZES", [3, 3, 3, 3])]
        self.down_kernels = ks + [3]                     # stages 2..6
        shapes = [(nz + 1, ny, nx)]
        for _ in range(5):
            shapes.append(tuple(conv_out_dim(n, 3, 2, 1)
                                for n in shapes[-1]))
        self.level_shapes = shapes
        self.bev_shape = (shapes[3][1], shapes[3][2])
        c1, c2, c3, c4, c5 = chans
        self.w_input = SparseConvParam(input_channels, c1)
        self.bn_input = MaskedBatchNorm(c1)
        for s, (cin, cout) in enumerate(
                [(c1, c1), (c1, c2), (c2, c3), (c3, c4), (c4, c5), (c5, c5)],
                start=1):
            k = self.down_kernels[s - 2] if s >= 2 else 3
            self._make_stage(s, cin, cout, s >= 2, down_kernel=(k, k, k),
                             use_bias=use_bias)
        self.w_out = SparseConvParam(c4, self.out_channels, kernel=K2D)
        self.bn_out = MaskedBatchNorm(self.out_channels)
        self.w_shared = SparseConvParam(self.out_channels, self.out_channels,
                                        kernel=K2D, use_bias=True)
        self.bn_shared = MaskedBatchNorm(self.out_channels)

    @property
    def num_bev_features(self):
        return self.out_channels

    def forward(self, batch):
        if not self.windowed:
            raise ValueError("VoxelNeXt runs on the windowed sparse "
                             "pipeline only (SUBM_MODE: windowed)")
        feats = batch["voxel_features"]
        s = self.level_shapes
        ovf_acc = []
        level = self._win_entry(batch["voxel_coords"], batch["voxel_mask"],
                                feats, s[0])
        level = self._subm(level, self.w_input, self.bn_input, ovf_acc, None)
        level = self._blocks(1, level, ovf_acc, None)
        multi = {"x_conv1": level}
        levels = {}
        for li in range(2, 7):
            k = self.down_kernels[li - 2]
            level = self._down(level, getattr(self, f"blocks{li}_down"),
                               getattr(self, f"blocks{li}_down_bn"),
                               s[li - 1], self.caps[min(li, len(self.caps)
                                                        - 1)], ovf_acc,
                               padding=(k // 2,) * 3)
            levels[li] = level = self._blocks(li, level, ovf_acc, None)
            if li <= 4:
                multi[f"x_conv{li}"] = level
        level = sparse_bev_out(self, [levels[4], levels[5], levels[6]],
                               ovf_acc)
        batch["multi_scale_3d_features"] = multi
        return sparse_bev_outputs(self, batch, level, ovf_acc, feats)
