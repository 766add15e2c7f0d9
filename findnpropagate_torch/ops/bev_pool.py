"""bev_pool, the LSS frustum-to-BEV splat — port of
findnpropagate_tpu/ops/bev_pool.py:16-34.

A masked scatter-add into the dense BEV grid: each frustum point's
features add into its (y, x, z) cell, the points outside the grid or
masked off into a dummy row that is dropped. `index_add` keeps the
gradient (each point's gradient is its cell's). On CUDA the sums run as
float32 atomics in no fixed order, so a cell's sum may differ from run to
run and from the CPU's in its last bits: hold it to 1e-5 of the output's
scale. Under a profiler a call records the span `bev_pool`
(utils/trace.py).
"""

from __future__ import annotations

import torch

from ..utils import trace


@trace.spanned("bev_pool")
def bev_pool(feats, coords, valid, nx: int, ny: int, nz: int):
    """feats (B, N, C); coords (B, N, 3) int (x, y, z) cells; valid (B, N).
    Returns (B, nz * C, ny, nx): z folded into the channels as z * C + c
    (the reference's (ny, nx, nz * C) per sample, channels first)."""
    b, n, c = feats.shape
    x, y, z = coords.long().unbind(-1)
    inside = (valid & (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0)
              & (z < nz))
    cells = nx * ny * nz
    flat = (y * nx + x) * nz + z
    flat = torch.where(inside, flat, torch.full_like(flat, cells))
    flat = flat + (cells + 1) * torch.arange(b, device=feats.device)[:, None]
    grid = feats.new_zeros(b * (cells + 1), c).index_add(
        0, flat.reshape(-1), torch.where(inside[..., None], feats,
                                         torch.zeros_like(feats)).reshape(
            -1, c))
    grid = grid.reshape(b, cells + 1, c)[:, :cells]
    return grid.reshape(b, ny, nx, nz * c).permute(0, 3, 1, 2)
