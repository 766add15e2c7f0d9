"""The reference's arithmetic: float32 with TF32 off, and the control's
lower-precision operands.

The configuration computes its 3D convolutions on bf16 operands (float32
accumulation), its dense 2D convolutions in TF32 (cuDNN's default) and its
matrix products and linear layers in float32. The control is the reference
one step below each: float8 e4m3 operands (per-tensor scale, float32
accumulation) in every 3D convolution, bf16 operands in every dense conv
and transposed conv, and TF32 operands (a 10-bit mantissa, rounded to
nearest even) in every linear layer. `round_operand` rounds a tensor as
such an operand; `lower_dense_operands` rounds a module's weights in place
and hooks its dense layers so that their inputs are rounded too.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

FP8_MAX = 448.0          # the largest finite float8 e4m3 value
FORMATS = (None, "tf32", "bf16", "fp8")


def round_operand(x, fmt):
    """x rounded to `fmt` (None: as it is) and returned in x's dtype."""
    if fmt is None:
        return x
    if fmt == "tf32":
        i = x.float().view(torch.int32)
        # round the 13 dropped mantissa bits to nearest, ties to even
        i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
        return i.view(torch.float32).to(x.dtype)
    if fmt == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    if fmt == "fp8":
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    raise ValueError(f"operand format {fmt!r}: one of {FORMATS}")


# the control's operand format of each kind of dense layer
CONTROL_DENSE = {nn.Conv2d: "bf16", nn.ConvTranspose2d: "bf16",
                 nn.Linear: "tf32"}


def lower_dense_operands(module, formats):
    """Round every dense layer's weight to its format in `formats` ({layer
    class: format}) in place and round its input on each call. Returns the
    hook handles."""
    handles = []
    for m in module.modules():
        fmt = formats.get(type(m))
        if fmt is None:
            continue
        with torch.no_grad():
            m.weight.copy_(round_operand(m.weight, fmt))
        handles.append(m.register_forward_pre_hook(
            lambda _m, args, fmt=fmt: (round_operand(args[0], fmt),)
            + args[1:]))
    return handles


@contextlib.contextmanager
def exact_float32():
    """float32 matmuls and convolutions without TF32 for the block, the
    earlier settings restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
