"""PillarRes18BackBone8x and PillarBackBone8x, PillarNet's sparse 2D
backbones — port of
findnpropagate_tpu/models/backbones_3d/spconv_backbone_2d.py (:31-127).

Four sparse 2D stages over the pillar BEV grid on the windowed pipeline,
shape (1, ny, nx) and (1, 3, 3) kernels (tap groups of one in K3 / K4),
the pillars' z set to 0: stage 1 two blocks at stride 1, stages 2-4 a
(1, 2, 2)-strided conv (padding (0, 1, 1)) and two blocks (SparseBasicBlocks
in the Res18 variant, conv + BN layers in the plain one). The stride-8
level is made dense (``x_conv4_dense``, also ``spatial_features``), then a
dense stride-16 stage: a 3x3 stride-2 conv with flax's SAME padding (the
bottom and right edges), BN, ReLU and two residual blocks of two 3x3 convs
(``x_conv5``) — in both variants, as in the reference. Maps are NCHW.
"""

from __future__ import annotations

import torch
from torch import nn

from ..blocks import BN_EPS, BatchNorm2d, same_pad
from .spconv_backbone import _SparseStack, conv_out_dim

K2D = (1, 3, 3)


class PillarRes18BackBone8x(_SparseStack):
    residual = True

    def _build(self, input_channels, grid_size):
        cfg = self.model_cfg
        nx, ny, _ = grid_size
        use_bias = bool(cfg.get("USE_BIAS", self.residual))
        chans = [int(c) for c in cfg.get("CHANNELS", [32, 64, 128, 256, 256])]
        self.chans = chans
        c0 = int(cfg.get("MAX_VOXELS", 60000))
        caps = cfg.get("LEVEL_CAPACITIES", None) or [c0, c0, c0 // 2,
                                                     c0 // 4]
        self.caps = [int(c) for c in caps]
        shapes = [(1, ny, nx)]
        for _ in range(3):
            p = shapes[-1]
            shapes.append((1, conv_out_dim(p[1], 3, 2, 1),
                           conv_out_dim(p[2], 3, 2, 1)))
        self.level_shapes = shapes
        c1, c2, c3, c4, c5 = chans
        for s, (cin, cout) in enumerate([(c1, c1), (c1, c2), (c2, c3),
                                         (c3, c4)], start=1):
            self._make_stage(s, cin, cout, s >= 2, kernel=K2D,
                             use_bias=use_bias)
        self.conv5_down = nn.Conv2d(c4, c5, 3, 2, bias=False)
        self.conv5_bn = BatchNorm2d(c5, eps=BN_EPS)
        for i in range(2):
            for j, mod in enumerate((
                    nn.Conv2d(c5, c5, 3, 1, bias=False),
                    BatchNorm2d(c5, eps=BN_EPS),
                    nn.Conv2d(c5, c5, 3, 1, bias=False),
                    BatchNorm2d(c5, eps=BN_EPS))):
                self.add_module(f"conv5_res_{i}_{j}", mod)
        self.out_channels = c5
        self.multi_scale_channels = (c4, c5)

    @property
    def num_bev_features(self):
        return self.chans[4]

    def _conv5(self, x):
        """The dense stride-16 stage over the (B, C, ny8, nx8) map."""
        x = torch.relu(self.conv5_bn(self.conv5_down(same_pad(x, 3, 2))))
        for i in range(2):
            c1, b1, c2, b2 = (getattr(self, f"conv5_res_{i}_{j}")
                              for j in range(4))
            y = torch.relu(b1(c1(same_pad(x, 3, 1))))
            x = torch.relu(b2(c2(same_pad(y, 3, 1))) + x)
        return x

    def forward(self, batch):
        if not self.windowed:
            raise ValueError("PillarNet's backbone runs on the windowed "
                             "sparse pipeline only (SUBM_MODE: windowed)")
        feats = batch["pillar_features"]
        coords = batch["voxel_coords"].clone()
        coords[..., 0] = 0
        s = self.level_shapes
        ovf_acc = []
        level = self._win_entry(coords, batch["voxel_mask"], feats, s[0])
        level = self._blocks(1, level, ovf_acc, None)
        multi = {"x_conv1": level}
        for li in (2, 3, 4):
            level = self._down(level, getattr(self, f"blocks{li}_down"),
                               getattr(self, f"blocks{li}_down_bn"),
                               s[li - 1], self.caps[min(li, len(self.caps)
                                                        - 1)], ovf_acc,
                               stride=(1, 2, 2), padding=(0, 1, 1))
            multi[f"x_conv{li}"] = level = self._blocks(li, level, ovf_acc,
                                                        None)
        x4 = self._to_dense(level)[1][:, :, 0]          # (B, C, ny8, nx8)
        batch["multi_scale_2d_features"] = {
            **multi, "x_conv4_dense": x4, "x_conv5": self._conv5(x4)}
        batch["spatial_features"] = x4
        batch["spatial_features_stride"] = 8
        batch["sparse_window_overflow"] = torch.stack(ovf_acc).sum() \
            if ovf_acc else torch.zeros((), dtype=torch.int64,
                                        device=feats.device)
        return batch


class PillarBackBone8x(PillarRes18BackBone8x):
    """The plain variant: conv + BN layers in the sparse stages."""

    residual = False
