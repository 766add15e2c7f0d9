"""The readings that a cell's correctness limits are set from: the numbers
compared, seed by seed, for the port (`--side port`: the lower readings)
or for the control (`--side control`: the reference one precision step
below the configuration's in the port's place, the upper readings),
several seeds in one process, each a short window at the cell's own load
that checks its first batch.

    python3 benchmark/calibrate.py --workload <cell> --side control \
        --seeds 11,12,13 --seconds 2 [--out readings.jsonl]

Prints one JSON line a seed: {"seed", "side", "correct", "checks"}.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--side", choices=("port", "control"), default="port")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    from benchmark import harness

    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        result, _ = harness.run_cell(args.workload, seed, args.seconds, False,
                                     time.perf_counter(), ROOT,
                                     side=args.side, check_among=1)
        row = {"seed": seed, "side": args.side,
               "correct": result["correct"], "checks": result["checks"],
               "readings": result["readings"]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return rows


if __name__ == "__main__":
    main()
