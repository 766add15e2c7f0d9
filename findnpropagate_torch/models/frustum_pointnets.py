"""Frustum PointNets v1: the instance-segmentation network — port of
`PointNetInstanceSeg` of findnpropagate_tpu/models/frustum_pointnets.py
:27-58 (the SEG seeker's foreground filter).

Conv1d(k=1) is a Linear over the point axis; points are (B, N, C) with a
validity mask, every BatchNorm a MaskedBatchNorm over the valid points.
Layer names are the flax tree's (``enc0_fc0``, ``enc0_bn0``, ...,
``seg_out``), so utils/weights.py carries a flax variables tree across.
"""

from __future__ import annotations

import torch
from torch import nn

from .blocks import MaskedBatchNorm

NEG_INF = -1e9


class PointNetInstanceSeg(nn.Module):
    """Per-point FG/BG segmentation: encoder 64-64-64-128-1024, global max
    and the class one-hot, skip from the 2nd layer, decoder
    512-256-128-128-2. Dropout(0.5) before the last layer, in training
    only."""

    STACKS = (("enc0", (64,)), ("enc1", (64,)), ("enc2", (64, 128, 1024)),
              ("dec", (512, 256, 128, 128)))

    def __init__(self, n_classes: int = 3):
        super().__init__()
        self.n_classes = n_classes
        cin = {"enc0": 3, "enc1": 64, "enc2": 64, "dec": 64 + 1024 + n_classes}
        for prefix, dims in self.STACKS:
            c = cin[prefix]
            for i, d in enumerate(dims):
                setattr(self, f"{prefix}_fc{i}", nn.Linear(c, d))
                setattr(self, f"{prefix}_bn{i}", MaskedBatchNorm(d))
                c = d
        self.dropout = nn.Dropout(0.5)
        self.seg_out = nn.Linear(128, 2)

    def _stack(self, x, valid, prefix):
        dims = dict(self.STACKS)[prefix]
        for i in range(len(dims)):
            x = getattr(self, f"{prefix}_fc{i}")(x)
            x = getattr(self, f"{prefix}_bn{i}")(x, valid, channels_last=True)
            x = torch.relu(x)
        return x

    def forward(self, pts, one_hot, valid):
        """pts (B, N, 3); one_hot (B, C); valid (B, N) -> logits (B, N, 2)."""
        out2 = self._stack(self._stack(pts, valid, "enc0"), valid, "enc1")
        x = self._stack(out2, valid, "enc2")
        global_feat = torch.where(valid[..., None], x,
                                  torch.full_like(x, NEG_INF)).amax(-2)
        glob = torch.cat([global_feat, one_hot.to(x.dtype)], dim=-1)
        x = torch.cat([out2, glob[:, None, :].expand(
            *out2.shape[:-1], glob.shape[-1])], dim=-1)
        x = self.dropout(self._stack(x, valid, "dec"))
        return self.seg_out(x)
