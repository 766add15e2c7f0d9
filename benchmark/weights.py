"""Random weights from the seed, made on the device in one draw.

The state dict is laid out from the reference's modules (which carry the
port's names), so the same tensors load into the port and the reference.
Every floating tensor takes a slice of one `torch.randn` of a generator
seeded with the run's seed, in the order of its sorted name, scaled so
that activations keep their size through the network: dense, transposed
and sparse convolution kernels and linear layers by sqrt(2 / fan_in) (He),
norm scales 1 + 0.05 n, biases and all other parameters 0.05 n; BN
statistics are mean 0 and variance 1.

The TransFusion decoder's attention query and key projections are drawn
ATTN_QK times smaller. At He scale their inputs (the head's BEV features,
of norm about 1600 a query) give logits whose spread is in the thousands:
the softmax over the 32400 BEV cells is one-hot for 98 % of (query, head)
pairs, and a near-tie between two keys flips a query's whole output under
any rounding. At 0.03 the cross-attention's largest weight is 0.03 for the
median query and 0.11 at the 90th percentile, as a trained head attends.
"""

from __future__ import annotations

import math

import torch
from torch import nn

NORMS = (nn.BatchNorm1d, nn.BatchNorm2d, nn.LayerNorm)
ATTN_QK = 0.03


def _kinds(model):
    """{state-dict name: (how it is drawn, fan-in, scale)}."""
    kinds = {}
    for mname, mod in model.named_modules():
        pre = f"{mname}." if mname else ""
        path = mname.split(".")
        qk = path[-1] in ("query", "key") and path[-2:-1] in (
            ["self_attn"], ["cross_attn"])
        for pname, p in mod.named_parameters(recurse=False):
            name = pre + pname
            is_norm = isinstance(mod, NORMS) or type(mod).__name__ == \
                "MaskedBatchNorm"
            if is_norm and pname in ("weight", "scale"):
                kinds[name] = ("norm_scale",)
            elif pname == "bias":
                kinds[name] = ("small",)
            elif isinstance(mod, nn.ConvTranspose2d):
                kinds[name] = ("he", p.shape[0], 1.0)
            elif isinstance(mod, (nn.Conv2d, nn.Linear)):
                kinds[name] = ("he", math.prod(p.shape[1:]),
                               ATTN_QK if qk else 1.0)
            elif pname == "kernel" and p.ndim == 3:
                kinds[name] = ("he", p.shape[0] * p.shape[1], 1.0)
            else:
                kinds[name] = ("small",)
        for bname, b in mod.named_buffers(recurse=False):
            if bname in ("running_mean", "mean"):
                kinds[pre + bname] = ("zeros",)
            elif bname in ("running_var", "var"):
                kinds[pre + bname] = ("ones",)
    return kinds


def random_state(model, seed, device):
    """The state dict of `model`'s shape drawn from `seed` on `device`."""
    shapes = {k: v for k, v in model.state_dict().items()}
    kinds = _kinds(model)
    drawn = sorted(k for k, v in shapes.items()
                   if v.is_floating_point() and kinds.get(k, ("small",))[0]
                   in ("he", "norm_scale", "small"))
    total = sum(shapes[k].numel() for k in drawn)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(total, generator=gen, device=device)
    state, at = {}, 0
    for k in drawn:
        n = shapes[k].numel()
        x = flat[at:at + n].view(shapes[k].shape)
        at += n
        kind = kinds.get(k, ("small",))
        if kind[0] == "he":
            x = x * (kind[2] * math.sqrt(2.0 / kind[1]))
        elif kind[0] == "norm_scale":
            x = 1.0 + 0.05 * x
        else:
            x = 0.05 * x
        state[k] = x
    for k, v in shapes.items():
        if k in state:
            continue
        kind = kinds.get(k, ("zeros",))[0]
        state[k] = (torch.ones if kind == "ones" else torch.zeros)(
            v.shape, dtype=v.dtype, device=device)
    return state
