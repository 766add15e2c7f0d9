"""Image ResNets — port of findnpropagate_tpu/models/backbones_image/
resnet.py (`BasicBlock` :20, `ResNet18` :41, `Bottleneck` :68,
`CLIPResNet` :99).

NCHW, flax's SAME padding on every conv and on the stem's max pool
(`blocks.same_pad`: a stride-2 conv over an even size pads the bottom and
right only), VALID average pools, BN flax's (eps 1e-5). ResNet18: a 7x7
stride-2 stem, a 3x3 stride-2 max pool, four stages of two BasicBlocks
(64, 128, 256, 512 channels; a 1x1 projection where the stride or width
changes). CLIPResNet: a three-conv stem and a 2x2 average pool, then
stages of Bottlenecks (LAYERS, WIDTH) whose stride is a 2x2 average pool
before their last 1x1 conv and on the projection. ``image_features``
holds the OUT_INDICES stages' outputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..blocks import BatchNorm2d, same_pad

BN_EPS = 1e-5      # flax nn.BatchNorm's


def _conv(x, conv):
    """A conv with flax's SAME padding for its kernel and stride."""
    return conv(same_pad(x, conv.kernel_size[0], conv.stride[0]))


def _camera_nchw(batch):
    x = batch["camera_imgs"].float()
    return x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)


class _Named(nn.Module):
    """Conv_{i} / BatchNorm_{i} pairs under flax's auto-names."""

    def _pair(self, i, cin, cout, k, stride=1):
        self.add_module(f"Conv_{i}", nn.Conv2d(cin, cout, k, stride,
                                               bias=False))
        self.add_module(f"BatchNorm_{i}", BatchNorm2d(cout, eps=BN_EPS))

    def _cbr(self, i, x, relu=True):
        y = getattr(self, f"BatchNorm_{i}")(_conv(x, getattr(self,
                                                             f"Conv_{i}")))
        return torch.relu(y) if relu else y


class BasicBlock(_Named):
    def __init__(self, cin, channels, stride=1):
        super().__init__()
        self._pair(0, cin, channels, 3, stride)
        self._pair(1, channels, channels, 3)
        self.project = stride != 1 or cin != channels
        if self.project:
            self._pair(2, cin, channels, 1, stride)

    def forward(self, x):
        y = self._cbr(1, self._cbr(0, x), relu=False)
        identity = self._cbr(2, x, relu=False) if self.project else x
        return torch.relu(y + identity)


class ResNet18(_Named):
    """Four stages of two BasicBlocks, returning the OUT_INDICES stages."""

    def __init__(self, model_cfg):
        super().__init__()
        self.out_indices = tuple(int(i) for i in model_cfg.get(
            "OUT_INDICES", (0, 1, 2, 3)))
        self._pair(0, 3, 64, 7, 2)
        cin, k = 64, 0
        self.out_channels = []
        for si, (ch, stride) in enumerate([(64, 1), (128, 2), (256, 2),
                                           (512, 2)]):
            for s in (stride, 1):
                self.add_module(f"BasicBlock_{k}", BasicBlock(cin, ch, s))
                cin, k = ch, k + 1
            if si in self.out_indices:
                self.out_channels.append(ch)

    def forward(self, batch):
        x = self._cbr(0, _camera_nchw(batch))
        x = F.max_pool2d(same_pad(x, 3, 2, value=-float("inf")), 3, 2)
        outs = []
        for si in range(4):
            for j in range(2):
                x = getattr(self, f"BasicBlock_{2 * si + j}")(x)
            if si in self.out_indices:
                outs.append(x)
        batch["image_features"] = outs
        return batch


class Bottleneck(_Named):
    """CLIP's bottleneck: its stride an average pool before the last 1x1
    conv, and before the projection."""

    expansion = 4

    def __init__(self, cin, channels, stride=1):
        super().__init__()
        out = channels * self.expansion
        self.stride = stride
        self._pair(0, cin, channels, 1)
        self._pair(1, channels, channels, 3)
        self._pair(2, channels, out, 1)
        self.project = stride > 1 or cin != out
        if self.project:
            self._pair(3, cin, out, 1)

    def forward(self, x):
        y = self._cbr(1, self._cbr(0, x))
        if self.stride > 1:
            y = F.avg_pool2d(y, self.stride)
        y = self._cbr(2, y, relu=False)
        identity = x
        if self.project:
            if self.stride > 1:
                identity = F.avg_pool2d(identity, self.stride)
            identity = self._cbr(3, identity, relu=False)
        return torch.relu(y + identity)


class CLIPResNet(_Named):
    """CLIP's modified ResNet: three-conv stem + average pool, Bottleneck
    stages of LAYERS blocks from WIDTH channels."""

    def __init__(self, model_cfg):
        super().__init__()
        layers = [int(n) for n in model_cfg.get("LAYERS", (3, 4, 6, 3))]
        width = int(model_cfg.get("WIDTH", 64))
        self.out_indices = tuple(int(i) for i in model_cfg.get(
            "OUT_INDICES", (0, 1, 2, 3)))
        cin = 3
        for i, (ch, st) in enumerate([(width // 2, 2), (width // 2, 1),
                                      (width, 1)]):
            self._pair(i, cin, ch, 3, st)
            cin = ch
        self.layers, k, ch = layers, 0, width
        self.out_channels = []
        for si, n_blocks in enumerate(layers):
            for j in range(n_blocks):
                stride = 2 if si > 0 and j == 0 else 1
                self.add_module(f"Bottleneck_{k}", Bottleneck(cin, ch,
                                                              stride))
                cin, k = ch * Bottleneck.expansion, k + 1
            if si in self.out_indices:
                self.out_channels.append(cin)
            ch *= 2

    def forward(self, batch):
        x = _camera_nchw(batch)
        for i in range(3):
            x = self._cbr(i, x)
        x = F.avg_pool2d(x, 2)
        outs, k = [], 0
        for si, n_blocks in enumerate(self.layers):
            for _ in range(n_blocks):
                x = getattr(self, f"Bottleneck_{k}")(x)
                k += 1
            if si in self.out_indices:
                outs.append(x)
        batch["image_features"] = outs
        return batch
