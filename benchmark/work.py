"""The work a scene needs, counted by the benchmark from shapes and data,
and the chip's published peaks.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, no sparsity):
989 TFLOP/s in bf16, 3.35 TB/s of HBM. Every share of a roofline or of the
peak here is against those, whatever precision a layer runs in, so a
layer that moves to a faster format shows as a larger share.

  * A sparse convolution needs 2 x hits x Cin x Cout operations, its
    hits the (output, tap) pairs of the reference's rulebook, and reads its
    input rows and weights and writes its output rows once, each at the
    width the configuration states: bf16 operands (2 bytes a value), and
    float32 output (4 bytes) on the sparse levels, bf16 (2) on the dense
    levels, those above DENSE_FROM_LEVEL. Its bound is the larger of
    operations / peak and bytes / bandwidth.
  * A dense layer's matrix products and convolutions (aten mm, addmm,
    bmm, baddbmm, convolution) are counted by `WorkCounter` from their
    shapes as they run in the reference: 2 x M x N x K operations, inputs
    and output read and written once each.
A layer's bound is the sum of its operations' bounds.
"""

from __future__ import annotations

import collections
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

PEAK_FLOPS = 989e12     # bf16 dense, H100 SXM
PEAK_BYTES = 3.35e12    # HBM3, H100 SXM
aten = torch.ops.aten


def bound_s(flops, nbytes):
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


OPERAND_BYTES = 2       # bf16 inputs and weights of every 3D convolution
SPARSE_OUT_BYTES = 4    # float32 output of a sparse level's convolution
DENSE_OUT_BYTES = 2     # bf16 output of a dense level's


def sparse_work(rulebook, dense_from):
    """(operations, bound seconds) of the sparse convolutions of a scene;
    a convolution onto a level above `dense_from` (the configuration's
    DENSE_FROM_LEVEL) runs dense, in bf16."""
    flops = bound = 0.0
    for c in rulebook:
        f = 2.0 * c["hits"] * c["cin"] * c["cout"]
        out = DENSE_OUT_BYTES if c["level"] > dense_from \
            else SPARSE_OUT_BYTES
        nbytes = (OPERAND_BYTES * (c["n_in"] * c["cin"]
                                   + c["taps"] * c["cin"] * c["cout"])
                  + out * c["n_out"] * c["cout"])
        flops += f
        bound += bound_s(f, nbytes)
    return flops, bound


def _nbytes(x):
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _conv_flops(args, out):
    """A convolution's weight is (Cout, Cin / groups, *kernel), a
    transposed one's (Cin, Cout / groups, *kernel): each output (each
    input, transposed) value meets w.shape[1] x kernel weights."""
    x, w, transposed = args[0], args[1], bool(args[6])
    per = w.shape[1] * math.prod(w.shape[2:])
    return 2 * (x.numel() if transposed else out.numel()) * per


def _mm_flops(op, args):
    """2 x (batch x) M x K x N of a product; addmm's and baddbmm's first
    argument is the term added."""
    a, b = args[:2] if op in (aten.mm.default, aten.bmm.default) \
        else args[1:3]
    return 2 * a.numel() * b.shape[-1]


MM_OPS = (aten.mm.default, aten.addmm.default, aten.bmm.default,
          aten.baddbmm.default)


class WorkCounter(TorchDispatchMode):
    """Operations and bound seconds of the matrix products and
    convolutions run under it, by `layer` (set by the caller)."""

    def __init__(self):
        super().__init__()
        self.layer = "other"
        self.flops = collections.defaultdict(float)
        self.bound = collections.defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in MM_OPS:
            f = _mm_flops(func, args)
        elif func is aten.convolution.default:
            f = _conv_flops(args, out)
        else:
            return out
        nbytes = sum(_nbytes(a) for a in args) + _nbytes(out)
        self.flops[self.layer] += f
        self.bound[self.layer] += bound_s(f, nbytes)
        return out
