"""Cost of the position precompute and of a banded gather + one weight
product at L0 sparse-conv scale on the card — the port of
tools/probe_posgather.py.

    python -m findnpropagate_torch.tools.probe_posgather [--device cpu]
        [--v 120000] [--nb 118] [--s 2048] [--w 1024] [--tap-win 1536]
        [--reps 20]

  * searchsorted: torch.searchsorted of 26 x V queries (every id plus each
    of the 26 non-centre deltas of a 3x3x3 kernel over strides sy = 62135,
    sx = 43) in V sorted unique ids like L0's (`make_ids`), and the 1-tap
    variant followed by a scalar gather of the ids found;
  * K1 (ops/posgather.py::positions) over the same ids as one L0 level:
    the window ranks of the 9 tap-group centres of every target (block
    1024, union window 3584 as the yaml's L0), timed beside
    torch.searchsorted of the same 9 x Vt queries in one call (global
    ranks: the window rank plus the block's window start wherever the id
    is found);
  * P3 (ops/gather_probes.py::banded_gather_conv) at band 2, 3 and 4: 27
    taps gathered at per-(block, tap, 128-target tile) starts plus
    in-band offsets from a (16, S) bf16 window, times (16, 432) weights,
    over nb blocks of W targets;
  * P2 with its weight stage (onehot_gather) at tap_win 1536 over nb
    blocks: the probe's one-hot reference.
Each prints `name: ms  device ms  correct=`: the searches are checked
against numpy, K1 against its plain version and the global ranks, P2 and
P3 against their plain versions (1e-3 of the output's scale plus one bf16
step of each element: f32 sums in another order before the bf16
rounding). Exits non-zero if a variant fails or comes out wrong, and
without CUDA unless --device cpu is given (then nothing is timed).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops import gather_probes as gp
from ..ops import posgather as tp
from ._common import Probe, bf16_close, device_of, parser, same

SY, SX = 62135, 43
BLOCK = 1024
L0_WINDOW = 3584


def make_ids(v=120000, seed=0):
    """Sorted unique int32 ids resembling L0 guard-banded yxz ids."""
    rng = np.random.RandomState(seed)
    return np.sort(rng.choice(v * 50, v, replace=False).astype(np.int32))


def deltas27():
    """The 27 tap deltas, zyx C order (dz outermost)."""
    return np.array([dy * SY + dx * SX + dz for dz in (-1, 0, 1)
                     for dy in (-1, 0, 1) for dx in (-1, 0, 1)], np.int32)


def bench_searchsorted(probe, dev, v):
    ids_np = make_ids(v)
    d26 = np.delete(deltas27(), 13)
    q_np = (ids_np[None, :].astype(np.int64) + d26[:, None]).reshape(-1)
    ids = torch.from_numpy(ids_np).to(dev)
    q = torch.from_numpy(q_np.astype(np.int32)).to(dev)
    want = np.searchsorted(ids_np, q_np)
    probe.run(f"searchsorted 26x{v} queries",
              lambda: torch.searchsorted(ids, q),
              lambda out: same(out, want))

    q1 = ids + SX
    pos1 = np.searchsorted(ids_np, ids_np + SX)
    want1 = ids_np[np.clip(pos1, 0, v - 1)]

    def one_tap():
        pos = torch.searchsorted(ids, q1)
        return ids[torch.clamp(pos, 0, v - 1)]
    probe.run("searchsorted 1 tap + scalar gather", one_tap,
              lambda out: same(out, want1))


def bench_positions(probe, dev, v):
    """K1 at an L0 level of the make_ids list, beside torch.searchsorted of
    the same queries."""
    ids_np = make_ids(v)
    pad = (-v) % BLOCK
    ids_np = np.concatenate([ids_np, ids_np[-1] + 2 + np.arange(
        pad, dtype=np.int32)])
    ids = torch.from_numpy(ids_np).to(dev)[None]
    lp = tp.compute_positions(ids, ids, deltas27(), block=BLOCK,
                              window=L0_WINDOW)
    nb, g_n = ids.shape[1] // BLOCK, lp.gdeltas.shape[0]
    tap_lo = torch.zeros(1, nb, g_n, dtype=torch.int32, device=dev)
    args = (ids, ids, lp.lo, tap_lo, lp.has_real, lp.gdeltas, BLOCK,
            lp.window, False)
    q = (ids.long()[:, None, :] + lp.gdeltas.long()[None, :, None]
         ).reshape(1, -1).to(torch.int32)
    ref = tp.positions_plain(*args)
    hit = ref >= 0
    lo_t = lp.lo.long().repeat_interleave(BLOCK, dim=1)[:, None, :]
    glob = (ref.long() + lo_t)[hit]

    def check(out):
        rank = torch.searchsorted(ids, q).reshape(out.shape)
        return same(out, ref) and bool(torch.equal(rank[hit], glob))
    overflow = int(lp.overflow.sum())
    probe.run(f"K1 positions Vt={ids.shape[1]} span={lp.window} "
              f"ovf={overflow}", lambda: tp.positions(*args), check)
    probe.line(f"library torch.searchsorted {g_n}x{ids.shape[1]}",
               lambda: torch.searchsorted(ids, q))


def banded_inputs(c, w_blk, band, taps, s_win, nb, dev):
    """bench_banded_taa's inputs (numpy seed 0)."""
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(c, s_win).astype(np.float32))
    rel = torch.from_numpy(rng.randint(0, band * 128, (taps, w_blk))
                           .astype(np.int32))
    starts = torch.from_numpy((rng.randint(
        0, (s_win - band * 128) // 128, (nb, taps, w_blk // 128)) * 128)
        .astype(np.int32))
    wt = torch.from_numpy(rng.randn(c, taps * c).astype(np.float32))
    return (starts.to(dev), feats.to(dev, torch.bfloat16), rel.to(dev),
            wt.to(dev, torch.bfloat16))


def onehot_inputs(c, w_blk, taps, s_win, dev):
    """bench_onehot_ref's inputs (numpy seed 0)."""
    rng = np.random.RandomState(0)
    feats = torch.from_numpy(rng.randn(c, s_win).astype(np.float32))
    ids = torch.from_numpy(np.sort(rng.choice(10 * s_win, s_win,
                                              replace=False)).astype(np.int32))
    want = torch.from_numpy(rng.randint(0, 10 * s_win, (taps, w_blk))
                            .astype(np.int32))
    wt = torch.from_numpy(rng.randn(c, taps * c).astype(np.float32))
    return (feats.to(dev, torch.bfloat16), ids.to(dev), want.to(dev),
            wt.to(dev, torch.bfloat16))


def main(argv=None):
    ap = parser(__doc__)
    ap.add_argument("--v", type=int, default=120000)
    ap.add_argument("--nb", type=int, default=118)
    ap.add_argument("--s", type=int, default=2048,
                    help="window columns; P3 stages them in shared memory: "
                    f"at most {gp.max_window(27, False)} "
                    "(gather_probes.max_window)")
    ap.add_argument("--w", type=int, default=1024)
    ap.add_argument("--tap-win", type=int, default=1536,
                    help="ids P2 compares, staged in shared memory: at "
                    f"most {gp.max_window(27, True)}")
    args = ap.parse_args(argv)
    dev = device_of(args)
    if dev is None:
        return 2
    probe = Probe(dev, args.reps)
    c, taps = 16, 27
    bench_searchsorted(probe, dev, args.v)
    bench_positions(probe, dev, args.v)
    for band in (2, 3, 4):
        a = banded_inputs(c, args.w, band, taps, args.s, args.nb, dev)
        ref = gp.banded_gather_conv_plain(*a, band)
        probe.run(f"banded-taa {taps}taps band{band} {args.nb}blk",
                  lambda: gp.banded_gather_conv(*a, band),
                  lambda out: bf16_close(out, ref))
    x, ids, want, wt = onehot_inputs(c, args.w, taps, args.s, dev)
    kw = dict(tap_win=args.tap_win, wt=wt, blocks=args.nb)
    ref = gp.onehot_gather_plain(x, ids, want, **kw)
    probe.run(f"onehot {taps}taps tapwin{args.tap_win} {args.nb}blk",
              lambda: gp.onehot_gather(x, ids, want, **kw),
              lambda out: bf16_close(out, ref))
    return probe.exit_code()


if __name__ == "__main__":
    sys.exit(main())
