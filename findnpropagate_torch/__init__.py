"""findnpropagate_torch — the PyTorch / CUDA (H100) port of findnpropagate_tpu.

The JAX package beside this one is the reference; every module here mirrors
its counterpart's path (``findnpropagate_tpu/ops/voxelize.py`` ->
``findnpropagate_torch/ops/voxelize.py``). This package imports torch and
never jax, nor anything of the JAX package.

Entry points run on CUDA unless the caller names another device
(``device="cpu"``, as the tests do); with no CUDA and no device named they
raise instead of carrying on on the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one named, else CUDA.

    Raises when no device is named and CUDA is missing — the port never
    falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "findnpropagate_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU explicitly")
    return torch.device("cuda")
