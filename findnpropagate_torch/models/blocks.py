"""Shared building blocks — port of findnpropagate_tpu/models/blocks.py
:20-116, eval and training form.

Submodule and parameter names follow the flax tree of the reference
(``Conv_0``, ``BatchNorm_0``, ``scale``/``bias``/``mean``/``var``), so
utils/weights.py maps a flax variable tree onto the port by path. Layouts
are PyTorch's: 2D maps are NCHW, conv weights OIHW. BatchNorm uses the
reference's eps=1e-3 and, in training, stores what flax stores: running
averages with momentum 0.99 (torch's 0.01) of the batch mean and of the
*biased* batch variance (torch.nn.BatchNorm stores the unbiased one).
Inside a data-parallel training step (parallel/mesh.py::global_batch) the
statistics are those of the global batch, as the reference's one program
computes them, so the running averages agree on every process.
"""

from __future__ import annotations

import torch
from torch import nn

from ..parallel.mesh import all_sum

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
        # the (global) batch's moments: sums of x and x^2 and the count
        s1, s2, n = all_sum(x.sum(axes), (x * x).sum(axes),
                            x.new_tensor(float(x.numel() // x.shape[1])))
        mean = s1 / n
        var = torch.clamp(s2 / n - mean * mean, min=0.0)
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

    def forward(self, x, valid, channels_last=False, inplace=False):
        """x (B, C, *spatial) with valid (B, *spatial) bool, or, with
        channels_last, x (B, V, C) with valid (B, V). `inplace` (eval, no
        autograd): a float32 x is overwritten with the result."""
        cdim = x.ndim - 1 if channels_last else 1
        shape = [1] * x.ndim
        shape[cdim] = -1
        m = valid.unsqueeze(cdim)
        if self.training:
            axes = [d for d in range(x.ndim) if d != cdim]
            mf = m.to(x.dtype)
            # two passes over the valid cells of the global batch
            total, n = all_sum((x * mf).sum(axes), valid.sum().to(x.dtype))
            n = torch.clamp(n, min=1.0)
            mean = total / n
            var = all_sum((((x - mean.view(shape)) ** 2) * mf).sum(axes)) / n
            with torch.no_grad():
                self.mean.mul_(BN_MOMENTUM).add_(mean, alpha=1 - BN_MOMENTUM)
                self.var.mul_(BN_MOMENTUM).add_(var, alpha=1 - BN_MOMENTUM)
            y = (x - mean.view(shape)) * (
                torch.rsqrt(var + self.eps) * self.scale).view(shape) \
                + self.bias.view(shape)
        else:
            k, s = self.affine()
            if inplace and x.dtype == torch.float32 and not self.training:
                return x.mul_(k.view(shape)).add_(s.view(shape)) \
                    .masked_fill_(~m, 0)
            y = x.float() * k.view(shape) + s.view(shape)
        return torch.where(m, y, torch.zeros_like(y)).to(x.dtype)


def _bn_relu(bn, x):
    """BN then ReLU; a bf16 input (the BEV backbone's eval DTYPE) is
    normalised in float32 from the float32 statistics and cast back, as
    flax's BatchNorm(dtype=bf16) does."""
    if x.dtype == torch.bfloat16 and not bn.training:
        k = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        shift = bn.bias - bn.running_mean * k
        y = x.float() * k[:, None, None] + shift[:, None, None]
        return torch.relu(y).to(x.dtype)
    return torch.relu(bn(x))


def _conv_in(conv, x):
    """A conv in x's dtype (bf16 on the BEV eval path; weights stay
    float32 and are cast)."""
    if x.dtype == conv.weight.dtype:
        return conv(x)
    return torch.nn.functional.conv2d(x, conv.weight.to(x.dtype), None,
                                      conv.stride, conv.padding)


def same_pad(x, kernel: int, stride: int):
    """x (..., H, W) padded as flax's ``padding="SAME"`` pads a conv of
    that kernel and stride: out = ceil(n / stride) and the total padding
    split with its smaller half before, so a stride-2 3x3 conv over an even
    size pads the bottom and right edges only."""
    pads = []
    for n in (x.shape[-1], x.shape[-2]):
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return torch.nn.functional.pad(x, pads)


class ConvBNReLU(nn.Module):
    """3x3 conv (pad 1), no bias, BatchNorm, ReLU; NCHW, in the input's
    dtype (float32, or bf16 at eval)."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.BatchNorm_0 = BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x):
        return _bn_relu(self.BatchNorm_0, _conv_in(self.Conv_0, x))


class DeconvBNReLU(nn.Module):
    """BatchNorm and ReLU after a resampling conv without bias, NCHW, in
    the input's dtype: for stride >= 1 a transposed-conv upsample (kernel =
    stride), for stride < 1 a conv downsample by 1/stride (kernel = stride,
    flax's SAME padding: the right and bottom edges padded to a multiple)."""

    def __init__(self, cin: int, features: int, stride: float = 2):
        super().__init__()
        self.up = float(stride) >= 1
        if self.up:
            s = int(round(float(stride)))
            self.ConvTranspose_0 = nn.ConvTranspose2d(cin, features, s, s,
                                                      bias=False)
        else:
            s = int(round(1 / float(stride)))
            self.Conv_0 = nn.Conv2d(cin, features, s, s, bias=False)
        self.s = s
        self.BatchNorm_0 = BatchNorm2d(features, eps=BN_EPS)

    def forward(self, x):
        if self.up:
            conv = self.ConvTranspose_0
            y = conv(x) if x.dtype == conv.weight.dtype else \
                torch.nn.functional.conv_transpose2d(
                    x, conv.weight.to(x.dtype), None, self.s)
        else:
            h, w = x.shape[-2:]
            x = torch.nn.functional.pad(x, (0, -w % self.s, 0, -h % self.s))
            y = _conv_in(self.Conv_0, x)
        return _bn_relu(self.BatchNorm_0, y)
