"""VoxelResBackBone8xVoxelNeXt2D, VoxelNeXt over pillars — port of
findnpropagate_tpu/models/backbones_3d/spconv_backbone_voxelnext2d.py
(:35-175).

Six sparse 2D stages over the pillar BEV grid, shape (1, ny, nx) and
(1, 3, 3) kernels throughout (tap groups of one in K3 / K4): stage 1 is
BLOCKS_PER_STAGE[0] residual blocks at stride 1, stages 2-6 open with a
(1, 2, 2)-strided conv (padding (0, 1, 1)) and add their blocks (default
3, 4, 6, 3, 3, 3). The pillars' z is set to 0 (their features,
``pillar_features``, must have CHANNELS[0] channels). Stages 4, 5 and 6
merge into the stride-8 BEV list and pass conv_out and shared_conv exactly
as in the 3D VoxelNeXt (spconv_backbone_voxelnext.py); the strided levels
are also given as ``multi_scale_2d_features`` with their strides.
"""

from __future__ import annotations

from ..blocks import MaskedBatchNorm
from .spconv_backbone import SparseConvParam, _SparseStack, conv_out_dim
from .spconv_backbone_voxelnext import K2D, sparse_bev_out, sparse_bev_outputs


class VoxelResBackBone8xVoxelNeXt2D(_SparseStack):
    residual = True

    def _build(self, input_channels, grid_size):
        cfg = self.model_cfg
        nx, ny, _ = grid_size
        chans = [int(c) for c in
                 cfg.get("CHANNELS", [32, 64, 128, 256, 256, 256])]
        self.chans = chans
        self.out_channels = int(cfg.get("OUT_CHANNEL", chans[3]))
        use_bias = bool(cfg.get("USE_BIAS", True))
        c0 = int(cfg.get("MAX_VOXELS", 60000))
        caps = cfg.get("LEVEL_CAPACITIES", None) or [
            c0, c0, c0 // 2, c0 // 4, c0 // 8, c0 // 16, c0 // 32]
        self.caps = [int(c) for c in caps]
        self.max_bev = int(cfg.get("MAX_BEV_VOXELS", self.caps[4] * 2))
        if not chans[3] == chans[4] == chans[5]:
            raise ValueError("conv4/5/6 channel counts must match for the "
                             "multi-scale sum")
        shapes = [(1, ny, nx)]
        for _ in range(5):
            p = shapes[-1]
            shapes.append((1, conv_out_dim(p[1], 3, 2, 1),
                           conv_out_dim(p[2], 3, 2, 1)))
        self.level_shapes = shapes
        self.bev_shape = (shapes[3][1], shapes[3][2])
        nb = [int(x) for x in cfg.get("BLOCKS_PER_STAGE", [3, 4, 6, 3, 3, 3])]
        c1, c2, c3, c4, c5, c6 = chans
        for s, (cin, cout) in enumerate(
                [(c1, c1), (c1, c2), (c2, c3), (c3, c4), (c4, c5), (c5, c6)],
                start=1):
            self._make_stage(s, cin, cout, s >= 2, num_blocks=nb[s - 1],
                             kernel=K2D, use_bias=use_bias)
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
            raise ValueError("VoxelNeXt2D runs on the windowed sparse "
                             "pipeline only (SUBM_MODE: windowed)")
        feats = batch.get("pillar_features", batch.get("voxel_features"))
        if feats.shape[-1] != self.chans[0]:
            raise ValueError("the pillar VFE's output must have "
                             "CHANNELS[0] channels")
        coords = batch["voxel_coords"].clone()
        coords[..., 0] = 0
        s = self.level_shapes
        ovf_acc = []
        level = self._win_entry(coords, batch["voxel_mask"], feats, s[0])
        level = self._blocks(1, level, ovf_acc, None)
        multi = {"x_conv1": level}
        levels = {}
        for li in range(2, 7):
            level = self._down(level, getattr(self, f"blocks{li}_down"),
                               getattr(self, f"blocks{li}_down_bn"),
                               s[li - 1], self.caps[min(li, len(self.caps)
                                                        - 1)], ovf_acc,
                               stride=(1, 2, 2), padding=(0, 1, 1))
            levels[li] = level = self._blocks(li, level, ovf_acc, None)
            if li <= 5:
                multi[f"x_conv{li}"] = level
        level = sparse_bev_out(self, [levels[4], levels[5], levels[6]],
                               ovf_acc)
        batch["multi_scale_2d_features"] = multi
        batch["multi_scale_2d_strides"] = {
            "x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8,
            "x_conv5": 16}
        return sparse_bev_outputs(self, batch, level, ovf_acc, feats)
