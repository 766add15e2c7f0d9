"""UNetV2, Part-A2's sparse U-Net — port of
findnpropagate_tpu/models/backbones_3d/spconv_unet.py (:33-212).

The 8x encoder of spconv_backbone.py (input conv, stages of one and two
submanifold conv + BN + ReLU layers opened by stride-2 convs, padding
(0, 1, 1) at the fourth level) with the (3, 1, 1) stride-(2, 1, 1)
``conv_out`` to the dense map HeightCompression reads; then a decoder from
level 4 up to level 1: at each level a SparseBasicBlock over the encoder's
(lateral) features, the bottom-up features and those concatenated (bottom
first), a submanifold merge conv, plus the channel reduction of the
concatenation — adjacent pairs of its channels summed, the reference's
``reshape(c_out, -1).sum(-1)`` — and, above level 1, an inverse conv
(`sparse_ops.win_inverse_conv`) back onto the finer level's active list;
at level 1 a last submanifold conv. ``point_features`` are the level-1
voxels' features and ``point_coords`` their centres.

Windowed pipeline only (SUBM_MODE windowed, the reference's assertion),
in each SUBM_IMPL of the reference's dispatch: its convs get no positions
cache, so in posgather mode the 3-deep strided convs at eval (the three
stage openers and ``conv_out``, a single tap group) run on K1 + K2 and
every submanifold and merge conv on K3; in pallas mode every conv on K3;
training takes K3 (forward and transposed) and K4; the inverse convs stay
plain PyTorch in every mode, as the reference calls its XLA windowed conv
for them. Parameters keep the flax names (``w_input``, ``enc1_0_0``,
``down2_0``, ``dec_t4_conv1``, ...).
"""

from __future__ import annotations

import torch

from ...ops.sparse_ops import win_inverse_conv
from ..blocks import MaskedBatchNorm
from .spconv_backbone import SparseConvParam, _SparseStack, conv_out_dim

LEVELS = (1, 2, 3, 4)


class UNetV2(_SparseStack):
    """Built with the grid's voxel_size and point_cloud_range: its points
    are the level-1 voxels' centres."""

    def _pair(self, name, cin, cout, kernel=(3, 3, 3)):
        """A conv + BN under the flax names ``{name}_0`` / ``{name}_1``."""
        self.add_module(f"{name}_0", SparseConvParam(cin, cout, kernel))
        self.add_module(f"{name}_1", MaskedBatchNorm(cout))

    def _build(self, input_channels, grid_size):
        cfg = self.model_cfg
        nx, ny, nz = grid_size
        s1 = (nz + 1, ny, nx)
        s2 = tuple(conv_out_dim(n, 3, 2, 1) for n in s1)
        s3 = tuple(conv_out_dim(n, 3, 2, 1) for n in s2)
        s4 = (conv_out_dim(s3[0], 3, 2, 0), conv_out_dim(s3[1], 3, 2, 1),
              conv_out_dim(s3[2], 3, 2, 1))
        s_out = (conv_out_dim(s4[0], 3, 2, 0), s4[1], s4[2])
        self.level_shapes = [s1, s2, s3, s4, s_out]
        self.stage_paddings = [None, (1, 1, 1), (1, 1, 1), (0, 1, 1)]
        chans = [int(c) for c in cfg.get("CHANNELS", [16, 32, 64, 64])]
        self.out_channels = int(cfg.get("OUT_CHANNEL", 128))
        c0 = int(cfg.get("MAX_VOXELS", 60000))
        caps = cfg.get("LEVEL_CAPACITIES", None) or [
            c0, c0, c0 // 2, c0 // 4, c0 // 8]
        self.caps = [int(c) for c in caps]
        lat = dict(zip(LEVELS, chans))
        self.level_channels = {f"x_conv{L}": lat[L] for L in LEVELS}
        self.w_input = SparseConvParam(input_channels, lat[1])
        self.bn_input = MaskedBatchNorm(lat[1])
        self.enc_depth = {1: 1, 2: 2, 3: 2, 4: 2}
        for L in LEVELS:
            if L > 1:
                self._pair(f"down{L}", lat[L - 1], lat[L])
            for i in range(self.enc_depth[L]):
                self._pair(f"enc{L}_{i}", lat[L], lat[L])
        self.w_out = SparseConvParam(lat[4], self.out_channels,
                                     kernel=(3, 1, 1))
        self.bn_out = MaskedBatchNorm(self.out_channels)
        # the decoder: the inverse conv of level L emits level L-1's
        # channels, so the bottom-up input of each level has its lateral
        # width
        for L in LEVELS:
            cl = lat[L]
            for j in (1, 2):
                self.add_module(f"dec_t{L}_conv{j}", SparseConvParam(cl, cl))
                self.add_module(f"dec_t{L}_bn{j}", MaskedBatchNorm(cl))
            self.add_module(f"dec_m{L}_conv", SparseConvParam(2 * cl, cl))
            self.add_module(f"dec_m{L}_bn", MaskedBatchNorm(cl))
            if L > 1:
                self.add_module(f"dec_inv{L}_conv",
                                SparseConvParam(cl, lat[L - 1]))
                self.add_module(f"dec_inv{L}_bn", MaskedBatchNorm(lat[L - 1]))
        self.dec_conv5 = SparseConvParam(lat[1], lat[1])
        self.dec_conv5_bn = MaskedBatchNorm(lat[1])
        self.lateral_channels = lat

    @property
    def num_point_features(self):
        return self.lateral_channels[1]

    @property
    def num_bev_features(self):
        return self.out_channels

    def _basic_block(self, level, L, ovf_acc):
        """SparseBasicBlock: conv-BN-ReLU, conv-BN, plus the input, ReLU."""
        identity = level[1][3]
        level = self._subm(level, getattr(self, f"dec_t{L}_conv1"),
                           getattr(self, f"dec_t{L}_bn1"), ovf_acc, None)
        level = self._subm(level, getattr(self, f"dec_t{L}_conv2"),
                           getattr(self, f"dec_t{L}_bn2"), ovf_acc, None,
                           relu=False)
        ids, coords, valid, feats = level[1]
        out = torch.relu(feats + identity)
        out = torch.where(valid[..., None], out, torch.zeros_like(out))
        return ("win", (ids, coords, valid, out), level[2])

    def forward(self, batch):
        if str(self.model_cfg.get("SUBM_MODE", "windowed")) != "windowed":
            raise ValueError("UNetV2 runs on the windowed sparse pipeline "
                             "only (SUBM_MODE: windowed)")
        feats = batch["voxel_features"]
        s = self.level_shapes
        ovf_acc = []
        level = self._win_entry(batch["voxel_coords"], batch["voxel_mask"],
                                feats, s[0])
        level = self._subm(level, self.w_input, self.bn_input, ovf_acc, None)
        levels = {}
        for L in LEVELS:
            if L > 1:
                level = self._down(level, getattr(self, f"down{L}_0"),
                                   getattr(self, f"down{L}_1"), s[L - 1],
                                   self.caps[min(L, len(self.caps) - 1)],
                                   ovf_acc, padding=self.stage_paddings[L - 1])
            for i in range(self.enc_depth[L]):
                level = self._subm(level, getattr(self, f"enc{L}_{i}_0"),
                                   getattr(self, f"enc{L}_{i}_1"), ovf_acc,
                                   None)
            levels[L] = level

        # the detection path: conv_out to the dense map of HeightCompression
        out_level = self._down(level, self.w_out, self.bn_out, s[4],
                               self.caps[4], ovf_acc, stride=(2, 1, 1),
                               padding=(0, 0, 0), dense_out=True)
        batch["encoded_spconv_tensor"] = out_level[1].float()
        batch["encoded_spconv_tensor_stride"] = 8

        block, _, swindow = self._win_cfg()
        x_bottom = levels[4]
        for L in (4, 3, 2, 1):
            x_trans = self._basic_block(levels[L], L, ovf_acc)
            ids, coords, valid, tr_f = x_trans[1]
            cat = torch.cat([x_bottom[1][3], tr_f], dim=-1)
            x_m = self._subm(("win", (ids, coords, valid, cat), x_trans[2]),
                             getattr(self, f"dec_m{L}_conv"),
                             getattr(self, f"dec_m{L}_bn"), ovf_acc, None)
            xm_f = x_m[1][3]
            red = cat.reshape(*cat.shape[:-1], xm_f.shape[-1], -1).sum(-1)
            merged = xm_f + red
            merged = torch.where(valid[..., None], merged,
                                 torch.zeros_like(merged))
            if L == 1:
                x_bottom = self._subm(
                    ("win", (ids, coords, valid, merged), x_trans[2]),
                    self.dec_conv5, self.dec_conv5_bn, ovf_acc, None)
                break
            fine = levels[L - 1]
            f_ids, f_coords, f_valid, _ = fine[1]
            out, ovf = win_inverse_conv(
                coords, valid, merged, f_ids, f_valid, fine[2], x_trans[2],
                getattr(self, f"dec_inv{L}_conv").kernel,
                padding=self.stage_paddings[L - 1], block=block,
                window=swindow)
            ovf_acc.append(ovf.sum())
            out = torch.relu(getattr(self, f"dec_inv{L}_bn")(
                out, f_valid, channels_last=True))
            out = torch.where(f_valid[..., None], out, torch.zeros_like(out))
            x_bottom = ("win", (f_ids, f_coords, f_valid, out), fine[2])

        _, f_coords, f_valid, f_feats = x_bottom[1]
        batch["point_features"] = f_feats
        vs, pcr = self.voxel_size, self.point_cloud_range
        c = f_coords.float()
        centers = torch.stack([(c[..., 2] + 0.5) * vs[0] + pcr[0],
                               (c[..., 1] + 0.5) * vs[1] + pcr[1],
                               (c[..., 0] + 0.5) * vs[2] + pcr[2]], dim=-1)
        batch["point_coords"] = torch.where(f_valid[..., None], centers,
                                            torch.zeros_like(centers))
        batch["point_valid"] = f_valid
        batch["multi_scale_3d_features"] = {f"x_conv{L}": levels[L]
                                            for L in LEVELS}
        batch["sparse_window_overflow"] = torch.stack(ovf_acc).sum() \
            if ovf_acc else torch.zeros((), dtype=torch.int64,
                                        device=feats.device)
        return batch
