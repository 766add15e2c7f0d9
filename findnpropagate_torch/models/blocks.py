"""Shared building blocks — port of findnpropagate_tpu/models/blocks.py
:20-116, eval form.

Submodule and parameter names follow the flax tree of the reference
(``Conv_0``, ``BatchNorm_0``, ``scale``/``bias``/``mean``/``var``), so
utils/weights.py maps a flax variable tree onto the port by path. Layouts
are PyTorch's: 2D maps are NCHW, conv weights OIHW. BatchNorm uses the
reference's eps=1e-3.
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-3


class MaskedBatchNorm(nn.Module):
    """Eval-mode BatchNorm of a channels-first dense level with the padding
    mask applied: y = x * scale' + shift' (`affine`) where valid, 0
    elsewhere, cast back to x's dtype (bf16 dense levels stay bf16). Sparse
    levels fold `affine()` into the conv kernel's epilogue instead."""

    def __init__(self, features: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def affine(self):
        """(scale, shift) with y = x * scale + shift, for a fused epilogue."""
        k = torch.rsqrt(self.var + self.eps) * self.scale
        return k, self.bias - self.mean * k

    def forward(self, x, valid):
        """x (B, C, *spatial); valid (B, *spatial) bool."""
        k, s = self.affine()
        shape = [1, -1] + [1] * (x.ndim - 2)
        y = x.float() * k.view(shape) + s.view(shape)
        m = valid.unsqueeze(1)
        return torch.where(m, y, torch.zeros_like(y)).to(x.dtype)


class ConvBNReLU(nn.Module):
    """3x3 conv (pad 1), no bias, BatchNorm, ReLU; NCHW."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class DeconvBNReLU(nn.Module):
    """Transposed-conv upsample (kernel = stride), no bias, BatchNorm, ReLU;
    NCHW. (The reference's stride < 1 downsample form is not ported.)"""

    def __init__(self, cin: int, features: int, stride: int = 2):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(cin, features, stride,
                                                  stride, bias=False)
        self.BatchNorm_0 = nn.BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.ConvTranspose_0(x)))
