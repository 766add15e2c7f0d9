"""Each position-gather conv of the flagship backbone's levels, alone, at
full size on the card — the port of tools/probe_posgather3.py.

    python -m findnpropagate_torch.tools.probe_posgather3 [case]
        [--device cpu] [--max-v N] [--reps 3]

Cases (transfusion_lidar.yaml): subm L0 (16 channels), strided L0->L1
(16 -> 32), subm L1 (32), strided L1->L2 (32 -> 64), subm L2 (64), strided
L2->L3 (64 -> 64), each over synthetic sorted ids of its level (a strided
case takes every other id as its targets, with the submanifold deltas, as
the probe does), through compute_positions (K1) + posgather_conv (K2).
The TPU probe hunted a compile that hung; here a case prints the time of
its first call (the nvcc builds of the kernels made in the run are printed
at the end) and the run time (CUDA events around `reps` calls of prelude +
conv), and checks the conv against the windowed conv (K3) over the same
window: relative error below 1e-3. The TPU's `band` and `tap_window` are
knobs of its compare volume with no counterpart here: they are listed with
each case and ignored. --max-v caps the ids of each case (for a small run
on the CPU). Exits non-zero on a failed or wrong case, and without CUDA unless --device
cpu is given (then nothing is timed).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from ..ops import _build
from ..ops import posgather as tp
from ..ops import sparse_ops as so
from ..ops import windowed_sparse as ws
from ._common import Probe, device_of, parser
from .probe_posgather2 import rel_err

CASES = {
    # key: (name, v, shape, cin, cout, window, band, tap_window, block,
    #       targets, strided)
    "l0subm": ("subm L0 c16 w3584", 121856, (41, 1440, 1440), 16, 16,
               3584, 3, 1792, 1024, None, False),
    "l01down": ("strided L0->L1 w4608", 121856, (41, 1440, 1440), 16,
                32, 4608, 6, 2816, 1024, 131072, True),
    "l1subm": ("subm L1 c32 w3584", 131072, (21, 720, 720), 32, 32,
               3584, 3, 1792, 1024, None, False),
    "l12down": ("strided L1->L2 w7168", 131072, (21, 720, 720), 32, 64,
                7168, 6, 5120, 1024, 49152, True),
    "l2subm": ("subm L2 c64 w3584", 49152, (11, 360, 360), 64, 64,
               3584, 3, 1792, 1024, None, False),
    "l23down": ("strided L2->L3 w8192", 49152, (11, 360, 360), 64, 64,
                8192, 6, 4608, 1024, 16384, True),
}


def synth_ids(v, shape, seed=0):
    """v sorted ids of random cells of the level (3/4 of v, at most half
    the grid), padded with sentinels."""
    rng = np.random.RandomState(seed)
    nz, ny, nx = shape
    sx, sy = so.yxz_strides(shape)
    n = min(v * 3 // 4, nz * ny * nx // 2)
    lin = rng.choice(nz * ny * nx, n, replace=False)
    z, y, x = lin % nz, (lin // nz) % ny, lin // (nz * ny)
    ids = np.unique(y * sy + (x + 1) * sx + (z + 1))[:v]
    sent = so.yxz_sentinel_start(shape)
    ids = np.concatenate([ids, sent + np.arange(max(v - ids.shape[0], 0))])
    return ids.astype(np.int32), sent


def run_case(probe, dev, key, max_v):
    name, v, shape, cin, cout, window, band, tap, block, tgt_v, strided = \
        CASES[key]
    v = min(v, max_v) // block * block
    ids_np, sent = synth_ids(v, shape)
    ids = torch.from_numpy(ids_np).to(dev)[None]
    deltas = so.yxz_offset_deltas((3, 3, 3), shape)
    if strided:
        tgt = ids[:, ::2][:, :min(tgt_v, v // 2)]
        pad = (-tgt.shape[1]) % block
        tgt = torch.cat([tgt, tgt[:, -1:] + 2 + torch.arange(
            pad, dtype=tgt.dtype, device=dev)], dim=1).contiguous()
    else:
        tgt = ids
    rng = np.random.RandomState(1)
    feats = torch.from_numpy(rng.randn(1, v, cin).astype(np.float32)
                             * 0.1).to(dev)
    w = torch.from_numpy(rng.randn(27, cin, cout).astype(np.float32)
                         * 0.05).to(dev)

    def conv():
        lp = tp.compute_positions(ids, tgt, deltas, block=block,
                                  window=window, sentinel_start=sent)
        return tp.posgather_conv(ids, feats, tgt, w, lp,
                                 sentinel_start=sent), lp.overflow

    t0 = time.perf_counter()
    out, ovf = conv()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    first = time.perf_counter() - t0
    ref, ovf_ref = ws.windowed_conv(ids, feats, tgt, w, deltas, block=block,
                                    window=window, sentinel_start=sent)
    err = rel_err(out, ref, tgt < sent)
    print(f"{name}: v {v}, targets {tgt.shape[1]}, {cin}->{cout}, "
          f"overflow {int(ovf.sum())} (K3 {int(ovf_ref.sum())}); TPU knobs "
          f"band {band}, tap_window {tap}: ignored", flush=True)
    probe.run(f"{name} (first call {first * 1e3:.1f} ms)", lambda: conv()[0],
              lambda o: (err < 1e-3 and bool(torch.isfinite(o).all()), err),
              graph=False)


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("case", nargs="?", default="all",
                    choices=["all", *CASES])
    ap.add_argument("--max-v", type=int, default=1 << 30)
    ap.set_defaults(reps=3)
    args = ap.parse_args(argv)
    dev = device_of(args)
    if dev is None:
        return 2
    probe = Probe(dev, args.reps)
    built = dict(_build.BUILD_SECONDS)
    for key in CASES:
        if args.case in ("all", key):
            run_case(probe, dev, key, args.max_v)
    new = {k: round(s, 1) for k, s in _build.BUILD_SECONDS.items()
           if k not in built}
    print(f"nvcc builds in this run: {new or 'none (already built)'}",
          flush=True)
    return probe.exit_code()


if __name__ == "__main__":
    sys.exit(main())
