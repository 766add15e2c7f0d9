"""Shared building blocks — port of findnpropagate_tpu/models/blocks.py
:20-116, eval and training form.

Submodule and parameter names follow the flax tree of the reference
(``Conv_0``, ``BatchNorm_0``, ``scale``/``bias``/``mean``/``var``), so
utils/weights.py maps a flax variable tree onto the port by path. Layouts
are PyTorch's: 2D maps are NCHW, conv weights OIHW. BatchNorm uses the
reference's eps=1e-3 and, in training, stores what flax stores: running
averages with momentum 0.99 (torch's 0.01) of the batch mean and of the
*biased* batch variance (torch.nn.BatchNorm stores the unbiased one).
"""

from __future__ import annotations

import torch
from torch import nn

BN_EPS = 1e-3
BN_MOMENTUM = 0.99      # flax convention: new = m * old + (1 - m) * batch


class _FlaxBatchNorm:
    """Training forward of flax's nn.BatchNorm for torch's BatchNorm1d/2d
    (channels at dim 1): batch mean and biased variance E[x^2] - E[x]^2,
    running averages of exactly those two with BN_MOMENTUM."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        axes = [0] + list(range(2, x.ndim))
        shape = [1, -1] + [1] * (x.ndim - 2)
        mean = x.mean(axes)
        var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(BN_MOMENTUM).add_(
                mean, alpha=1 - BN_MOMENTUM)
            self.running_var.mul_(BN_MOMENTUM).add_(
                var, alpha=1 - BN_MOMENTUM)
        k = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * k.view(shape) + self.bias.view(shape)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid cells only, zero elsewhere, cast back to
    x's dtype (bf16 dense levels stay bf16). Eval: y = x * scale' + shift'
    (`affine`); sparse eval levels fold `affine()` into the conv kernel's
    epilogue instead. Training: mean and biased variance over the valid
    cells of the batch, and the running averages updated with them."""

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

    def forward(self, x, valid, channels_last=False):
        """x (B, C, *spatial) with valid (B, *spatial) bool, or, with
        channels_last, x (B, V, C) with valid (B, V)."""
        cdim = x.ndim - 1 if channels_last else 1
        shape = [1] * x.ndim
        shape[cdim] = -1
        m = valid.unsqueeze(cdim)
        if self.training:
            axes = [d for d in range(x.ndim) if d != cdim]
            mf = m.to(x.dtype)
            n = torch.clamp(valid.sum().to(x.dtype), min=1.0)
            mean = (x * mf).sum(axes) / n
            var = (((x - mean.view(shape)) ** 2) * mf).sum(axes) / n
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
                self.var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
            y = (x - mean.view(shape)) * (
                torch.rsqrt(var + self.eps) * self.scale).view(shape) \
                + self.bias.view(shape)
        else:
            k, s = self.affine()
            y = x.float() * k.view(shape) + s.view(shape)
        return torch.where(m, y, torch.zeros_like(y)).to(x.dtype)


class ConvBNReLU(nn.Module):
    """3x3 conv (pad 1), no bias, BatchNorm, ReLU; NCHW."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.BatchNorm_0 = BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class DeconvBNReLU(nn.Module):
    """Transposed-conv upsample (kernel = stride), no bias, BatchNorm, ReLU;
    NCHW. (The reference's stride < 1 downsample form is not ported.)"""

    def __init__(self, cin: int, features: int, stride: int = 2):
        super().__init__()
        self.ConvTranspose_0 = nn.ConvTranspose2d(cin, features, stride,
                                                  stride, bias=False)
        self.BatchNorm_0 = BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x):
        return torch.relu(self.BatchNorm_0(self.ConvTranspose_0(x)))
