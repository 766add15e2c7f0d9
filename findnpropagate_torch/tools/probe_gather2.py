"""Each dynamic-gather form of tools/probe_gather2.py through the port's
gather kernel (P1, ops/gather_probes.py::take_along) on the card.

    python -m findnpropagate_torch.tools.probe_gather2 [--device cpu]
        [--s 1024] [--c 16] [--w 1024] [--reps 20]

Inputs as the probe makes them (numpy seed 0 for each form, indices in
[0, last dim of the index), floats standard normal):
  a  take_along_axis along axis 1, index (C, S), f32;
  b  the same in bf16;
  c  along axis 0, x (S, C), index (S, C) clamped to S-1;
  d  along axis 1 with an index twice as wide as the input (C, 2S): its
     indices from S up are out of range and give NaN;
  e  along axis 1 of a single row, x (1, S), index (1, W);
  f  along axis 1 with one index row broadcast over the C rows (stride 0);
  g  whole rows, x[idx, :] with idx (W,): along axis 0, the index
     broadcast over the columns.
The TPU probe asked which forms its compiler took and printed FAIL for the
others; here each form runs, is checked bit for bit against numpy (NaN
equal to NaN) and timed (CUDA events; device: CUDA-graph replays). Exits
non-zero if a form fails or comes out wrong, and without CUDA unless
--device cpu is given (then nothing is timed).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import gather_probes as gp
from ._common import Probe, device_of, parser, same, take_along_ref


def inputs(shapes, dev):
    """probe_gather2's try_kernel inputs: (torch on dev, numpy f32) pairs."""
    rng = np.random.RandomState(0)
    out = []
    for shp, dt in shapes:
        if dt == torch.int32:
            a = rng.randint(0, shp[-1], shp).astype(np.int32)
            out.append((torch.from_numpy(a).to(dev), a))
        else:
            t = torch.from_numpy(rng.randn(*shp).astype(np.float32)).to(
                dev, dt)
            out.append((t, t.float().cpu().numpy()))
    return out


def forms(s, c, w):
    """name -> (input shapes, port call, numpy reference)."""
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    return {
        "a taa axis=1 idx(C,S) f32": (
            [((c, s), f32), ((c, s), i32)],
            lambda x, i: gp.take_along(x, i, 1),
            lambda x, i: take_along_ref(x, i, 1)),
        "b taa axis=1 idx(C,S) bf16": (
            [((c, s), bf16), ((c, s), i32)],
            lambda x, i: gp.take_along(x, i, 1),
            lambda x, i: take_along_ref(x, i, 1)),
        "c taa axis=0 idx(S,C) f32": (
            [((s, c), f32), ((s, c), i32)],
            lambda x, i: gp.take_along(x, torch.clamp(i, max=s - 1), 0),
            lambda x, i: take_along_ref(x, np.minimum(i, s - 1), 0)),
        "d taa axis=1 idx(C,2S) grow": (
            [((c, s), f32), ((c, 2 * s), i32)],
            lambda x, i: gp.take_along(x, i, 1),
            lambda x, i: take_along_ref(x, i, 1)),
        "e taa axis=1 x(1,S) idx(1,W)": (
            [((1, s), f32), ((1, w), i32)],
            lambda x, i: gp.take_along(x, i, 1),
            lambda x, i: take_along_ref(x, i, 1)),
        "f taa axis=1 idx bcast row": (
            [((c, s), f32), ((1, s), i32)],
            lambda x, i: gp.take_along(x, i, 1),
            lambda x, i: take_along_ref(x, i, 1)),
        "g x[idx,:] sublane vec idx": (
            [((s, c), f32), ((1, w), i32)],
            lambda x, i: gp.take_along(x, i.t(), 0),
            lambda x, i: x[i[0]]),
    }


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--s", type=int, default=1024)
    ap.add_argument("--c", type=int, default=16)
    ap.add_argument("--w", type=int, default=1024)
    args = ap.parse_args(argv)
    dev = device_of(args)
    if dev is None:
        return 2
    probe = Probe(dev, args.reps)
    for name, (shapes, port, ref) in forms(args.s, args.c, args.w).items():
        (x, x_np), (i, i_np) = inputs(shapes, dev)
        want = ref(x_np, i_np)
        probe.run(name, lambda: port(x, i),
                  lambda out, want=want: same(out, want))
    return probe.exit_code()


if __name__ == "__main__":
    sys.exit(main())
