"""What an in-kernel gather costs at sparse-conv shapes on the card — the
port of tools/probe_gather.py.

    python -m findnpropagate_torch.tools.probe_gather [--device cpu]
        [--c 16] [--s 2048] [--w 1024] [--taps 27] [--reps 20]

For `taps` index rows over a (C, S) bf16 window it gathers the (taps*C, W)
stacked columns x[:, idx[k]] five ways, each through the port's kernels
(ops/gather_probes.py):
  * take.axis1 x27 — one P1 launch per tap, joined;
  * take_along_axis x27 — one P1 launch of the stacked-tap form;
  * take.flat 27W — one P1 launch over the flattened index, then the rows
    re-stacked;
  * take.axis0(sublane) x27 — the same gather on the (S, C) transpose, taps
    side by side (P1 along axis 0);
  * onehot compare+matmul x27 — P2: the columns whose sorted unique id
    equals a wanted id, 0 where none does;
and prints `name: ms  device ms  correct=` for each (eager calls timed with
CUDA events; device: replays of a CUDA graph), the check being the probe's
own (the gather written with torch indexing), then the time of the library
call that computes the stacked gather (torch.take_along_dim) on a line of
its own. Exits non-zero if a variant fails or comes out wrong, and without
CUDA unless --device cpu is given (then nothing is timed).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import gather_probes as gp
from ._common import Probe, device_of, parser, same


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--c", type=int, default=16,
                    help="channels; the P2 kernel takes 16 only")
    ap.add_argument("--s", type=int, default=2048,
                    help="window ids; the P2 kernel stages them in shared "
                    f"memory: at most {gp.max_ids()} (gather_probes.max_ids)")
    ap.add_argument("--w", type=int, default=1024)
    ap.add_argument("--taps", type=int, default=27)
    args = ap.parse_args(argv)
    dev = device_of(args)
    if dev is None:
        return 2
    c, s, w, taps = args.c, args.s, args.w, args.taps
    probe = Probe(dev, args.reps)

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(c, s).astype(np.float32)).to(
        dev, torch.bfloat16)
    idx = torch.from_numpy(rng.randint(0, s, (taps, w)).astype(np.int32)
                           ).to(dev)
    want = torch.cat([x[:, idx[k].long()] for k in range(taps)])
    probe.run("take.axis1 x27", lambda: torch.cat(
        [gp.take_along(x, idx[k:k + 1], 1) for k in range(taps)]),
        lambda out: same(out, want))
    probe.run("take_along_axis x27",
              lambda: gp.take_along(x, idx, 1, taps=True),
              lambda out: same(out, want))
    probe.run("take.flat 27W", lambda: gp.take_along(
        x, idx.reshape(1, -1), 1).reshape(c, taps, w).transpose(0, 1)
        .reshape(taps * c, w), lambda out: same(out, want))
    idx_l = idx.long()
    probe.line("library torch.take_along_dim x27",
               lambda: torch.take_along_dim(x[None], idx_l[:, None], dim=2)
               .reshape(taps * c, w))

    rng = np.random.RandomState(0)
    xs = torch.from_numpy(rng.randn(s, c).astype(np.float32)).to(
        dev, torch.bfloat16)
    idx_s = torch.from_numpy(rng.randint(0, s, (taps, w)).astype(np.int32)
                             ).to(dev)
    want_s = torch.cat([xs[idx_s[k].long()] for k in range(taps)], dim=1)
    probe.run("take.axis0(sublane) x27",
              lambda: gp.take_along(xs, idx_s, 0, taps=True),
              lambda out: same(out, want_s))

    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(c, s).astype(np.float32)).to(
        dev, torch.bfloat16)
    ids_np = np.sort(rng.choice(10 * s, s, replace=False)).astype(np.int32)
    wid_np = rng.randint(0, 10 * s, (taps, w)).astype(np.int32)
    rank = np.clip(np.searchsorted(ids_np, wid_np), 0, s - 1)
    hit = torch.from_numpy(ids_np[rank] == wid_np).to(dev)
    rank = torch.from_numpy(rank).to(dev)
    want_o = (x[:, rank] * hit).permute(1, 0, 2).reshape(taps * c, w)
    ids, wid = torch.from_numpy(ids_np).to(dev), torch.from_numpy(wid_np).to(
        dev)
    probe.run("onehot compare+matmul x27",
              lambda: gp.onehot_gather(x, ids, wid),
              lambda out: same(out, want_o))
    return probe.exit_code()


if __name__ == "__main__":
    sys.exit(main())
