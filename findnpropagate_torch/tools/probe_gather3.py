"""take_along_axis at the tile-aligned small shapes of tools/probe_gather3.py
through the port's gather kernel (P1, ops/gather_probes.py::take_along) on
the card.

    python -m findnpropagate_torch.tools.probe_gather3 [--device cpu]
        [--reps 20]

f32 inputs as the probe makes them (numpy seed 0, indices in [0, last
dim)): along axis 1 at (8, 128), (8, 1024) and (1024, 128); along axis 0 at
(8, 128) with the raw indices (up to 127 on an 8-row axis: out of range,
NaN as jnp.take_along_axis gives), and with the indices taken modulo the
rows at (8, 128) and (512, 128). Each is checked bit for bit against numpy
(NaN equal to NaN) and timed (CUDA events; device: CUDA-graph replays).
Exits non-zero if a shape fails or comes out wrong, and without CUDA
unless --device cpu is given (then nothing is timed).
"""

from __future__ import annotations

import sys

import torch

from ..ops import gather_probes as gp
from ._common import Probe, device_of, parser, same, take_along_ref
from .probe_gather2 import inputs

CASES = [
    # name, shape, axis, indices modulo the rows
    ("taa axis=1 (8,128) f32", (8, 128), 1, False),
    ("taa axis=0 (8,128) f32", (8, 128), 0, False),
    ("taa axis=0 (8,128) idx%8", (8, 128), 0, True),
    ("taa axis=0 (512,128) idx%512", (512, 128), 0, True),
    ("taa axis=1 (8,1024)", (8, 1024), 1, False),
    ("taa axis=1 (1024,128)", (1024, 128), 1, False),
]


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args)
    if dev is None:
        return 2
    probe = Probe(dev, args.reps)
    for name, shape, axis, mod in CASES:
        (x, x_np), (i, i_np) = inputs(
            [(shape, torch.float32), (shape, torch.int32)], dev)
        if mod:
            i, i_np = torch.remainder(i, shape[0]), i_np % shape[0]
        want = take_along_ref(x_np, i_np, axis)
        probe.run(name, lambda: gp.take_along(x, i, axis),
                  lambda out, want=want: same(out, want))
    return probe.exit_code()


if __name__ == "__main__":
    sys.exit(main())
