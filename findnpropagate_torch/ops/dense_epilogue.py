"""The dense levels' epilogue: mask, eval BatchNorm, residual and ReLU in
one pass over a dense conv's fresh output, in place.

It replaces no TPU kernel: the JAX package leaves the sparse backbone's
dense levels (DENSE_FROM_LEVEL on) to XLA, which fuses this tail; in
PyTorch it was a chain of elementwise passes over maps of up to
64 x 128 x 5 x 180 x 180 bf16. F.conv3d stays as it is; the kernel
(ops/csrc/dense_epilogue.cu) is everything after it:

    out = m ? act(r(r(y * k + s) + identity)) : 0     (with an identity)
    out = m ? act(r(y * k + s)) : 0                   (without)

written over y (B, C, *spatial), channels-first and contiguous, with the
level's mask m (B, *spatial) bool, eval BN's scale k and shift s
(`MaskedBatchNorm.affine()`), r the rounding to y's type (bf16 or
float32) and act ReLU or nothing. The kernel computes what the PyTorch
chain computes, element for element: a float32 multiply, then a float32
add, one rounding, the residual added in float32 and rounded again.

`dense_epilogue_plain` is that chain; the wrapper takes it for a tensor on
the CPU, for a CUDA tensor it launches the kernel or raises.
`LAUNCHES["dense_epilogue"]` counts launches; under a profiler the wrapper
records the span `dense_epilogue` (utils/trace.py).
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..utils import trace
from . import _build
from .posgather import _check_device, _ptr, _stream

LAUNCHES = {"dense_epilogue": 0}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VECTOR_BYTES = 16        # one access of the kernel's vector path


def reset_launches():
    LAUNCHES["dense_epilogue"] = 0


def _lib():
    lib = _build.load("dense_epilogue")
    if lib.fp_dense_epilogue.argtypes is None:
        lib.fp_dense_epilogue.argtypes = [ctypes.c_void_p] * 5 \
            + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 4 \
            + [ctypes.c_void_p]
        lib.fp_dense_epilogue.restype = ctypes.c_int
    return lib


def dense_epilogue_plain(y, mask, scale, shift, relu=True, identity=None):
    """The epilogue as PyTorch operations, in place on y: the mask, then
    BN (in place for float32; bf16 through a float32 copy), then the
    identity added in y's type, then ReLU and the mask again."""
    m = mask.unsqueeze(1)
    shape = [1, -1] + [1] * (y.ndim - 2)
    k, s = scale.view(shape), shift.view(shape)
    y.masked_fill_(~m, 0)
    if y.dtype == torch.float32:
        y.mul_(k).add_(s).masked_fill_(~m, 0)
    else:
        t = y.float() * k + s
        y.copy_(torch.where(m, t, torch.zeros_like(t)))
    if identity is None:
        return y.relu_() if relu else y
    y.add_(identity)
    if relu:
        y.relu_()
    return y.masked_fill_(~m, 0)


def _aligned(t, nbytes):
    return t.data_ptr() % nbytes == 0


@trace.spanned("dense_epilogue")
def dense_epilogue(y, mask, scale, shift, relu=True, identity=None):
    """The epilogue over y (B, C, *spatial), in place; returns y. The
    kernel for CUDA tensors (bf16 or float32, y and identity contiguous
    channels-first: a channels_last_3d map raises, nothing is copied), the
    plain version for CPU tensors."""
    extra = () if identity is None else (identity,)
    if not _check_device(y, mask, scale, shift, *extra):
        return dense_epilogue_plain(y, mask, scale, shift, relu, identity)
    if y.dtype not in DTYPES:
        raise ValueError(f"dense epilogue: dtype {y.dtype}, want float32 "
                         "or bfloat16")
    b, c, spatial = y.shape[0], y.shape[1], tuple(y.shape[2:])
    if not y.is_contiguous():
        raise ValueError("dense epilogue: y must be channels-first "
                         "contiguous (channels_last_3d is not taken)")
    if mask.dtype != torch.bool or tuple(mask.shape) != (b, *spatial) \
            or not mask.is_contiguous():
        raise ValueError(f"dense epilogue: mask {tuple(mask.shape)} "
                         f"{mask.dtype}, want contiguous bool "
                         f"{(b, *spatial)}")
    if identity is not None and (identity.dtype != y.dtype
                                 or identity.shape != y.shape
                                 or not identity.is_contiguous()):
        raise ValueError("dense epilogue: identity must be a contiguous "
                         "tensor of y's shape and dtype")
    if tuple(scale.shape) != (c,) or tuple(shift.shape) != (c,):
        raise ValueError(f"dense epilogue: scale / shift {tuple(scale.shape)}"
                         f" / {tuple(shift.shape)}, want ({c},)")
    if y.numel() == 0:
        return y
    n = math.prod(spatial)
    width = VECTOR_BYTES // y.element_size()
    vector = n % width == 0 and _aligned(y, VECTOR_BYTES) \
        and _aligned(mask, width) \
        and all(_aligned(t, VECTOR_BYTES) for t in extra)
    scale = scale.float().contiguous()
    shift = shift.float().contiguous()
    _build.check(_lib().fp_dense_epilogue(
        _ptr(y), None if identity is None else _ptr(identity), _ptr(mask),
        _ptr(scale), _ptr(shift), b * c, n, c, DTYPES[y.dtype], int(vector),
        int(relu), _stream()), "fp_dense_epilogue")
    LAUNCHES["dense_epilogue"] += 1
    return y
