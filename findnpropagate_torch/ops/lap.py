"""Linear assignment (Jonker-Volgenant shortest augmenting path) — port of
findnpropagate_tpu/ops/lap.py:25-97.

The reference runs the serial augmenting-path program on the device as one
fixed-shape lax loop. As a chain of tiny CUDA launches the same loop would
crawl, so the port runs it on the host: `solve_lap` takes the cost on any
device, copies it to the CPU once (one synchronisation per call, all
samples of a batch together) and solves each sample in numpy, every step
vectorised over the columns. The steps, the float32 arithmetic and the tie
rules (first minimum) are the reference's, so equal costs give the same
assignment, not only the same total.

Convention: cost (..., N_ROWS, N_COLS) with rows the scarce side (ground
truths) and columns the abundant side (proposals), #valid rows <= N_COLS.
Invalid rows are skipped. Returns, per column, the matched row or -1.
"""

from __future__ import annotations

import numpy as np
import torch

INF = np.float32(1e18)


def _solve_one(cost, row_valid):
    n, m = cost.shape
    if int(row_valid.sum()) > m:
        raise ValueError(f"{int(row_valid.sum())} valid rows cannot all be "
                         f"matched to {m} columns")
    u = np.zeros(n + 1, np.float32)
    v = np.zeros(m + 1, np.float32)
    p = np.zeros(m + 1, np.int64)     # p[j]: 1-indexed row of column j
    for i in np.flatnonzero(row_valid):
        minv = np.full(m + 1, INF, np.float32)
        used = np.zeros(m + 1, bool)
        way = np.zeros(m + 1, np.int64)
        p[0] = i + 1
        j0 = 0
        while p[j0] != 0:
            used[j0] = True
            i0 = p[j0]
            cur = cost[i0 - 1] - u[i0] - v[1:]
            cur[used[1:]] = INF
            better = cur < minv[1:]
            minv[1:][better] = cur[better]
            way[1:][better] = j0
            masked = np.where(used[1:], INF, minv[1:])
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            u[p[used]] += delta
            v[used] -= delta
            free = ~used
            free[0] = False
            minv[free] -= delta
            j0 = j1
        while j0 != 0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    return (p[1:] - 1).astype(np.int32)


def solve_lap(cost, row_valid):
    """cost (N, M) or (B, N, M) float; row_valid (N,) / (B, N) bool.
    Optimal min-cost matching of every valid row to a distinct column.
    Returns col_to_row (M,) / (B, M) int32 on cost's device, -1 where
    unmatched."""
    dev = cost.device
    c = cost.detach().to("cpu", torch.float32).numpy()
    rv = row_valid.detach().to("cpu").numpy().astype(bool)
    if c.ndim == 2:
        out = _solve_one(c, rv)
    else:
        out = np.stack([_solve_one(ci, ri) for ci, ri in zip(c, rv)])
    return torch.from_numpy(out).to(dev)
