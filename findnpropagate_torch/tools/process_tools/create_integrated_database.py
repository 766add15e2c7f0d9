"""Pack a per-object gt database into one shared array — port of
tools/process_tools/create_integrated_database.py.

    python -m findnpropagate_torch.tools.process_tools.create_integrated_database
        --src_db_info data/nuscenes/nuscenes_dbinfos_10sweeps_withvelo.pkl
        --root_path data/nuscenes [--new_db_name gt_database_global]
        [--num_point_features 5] [--dst_db_info PATH]

Stacks every object's .bin into <root_path>/<new_db_name>.npy and stamps
its row range as ``global_data_offset`` into the db infos
(datasets/augmentor/database_sampler.py::build_shared_database), which
are written back over the source pickle unless `--dst_db_info` is given;
then checks 16 objects' rows against their .bin files. The sampler reads
the array through np.load(mmap_mode="r"). numpy only.
"""

from __future__ import annotations

import argparse
import pickle
from pathlib import Path

import numpy as np

from ...datasets.augmentor.database_sampler import build_shared_database


def verify(db_infos, monolith_path, root_path, num_point_features,
           samples=16):
    """The offset rows of the array equal the source .bins of `samples`
    objects drawn from RandomState(0)."""
    data = np.load(str(monolith_path), mmap_mode="r")
    rng = np.random.RandomState(0)
    flat = [i for lst in db_infos.values() for i in lst]
    n = min(samples, len(flat))
    for info in [flat[j] for j in rng.choice(len(flat), n, replace=False)]:
        pts = np.fromfile(str(Path(root_path) / info["path"]),
                          dtype=np.float32).reshape(-1, num_point_features)
        s, e = info["global_data_offset"]
        np.testing.assert_array_equal(np.asarray(data[s:e]), pts)
    print(f"verified {n} objects against the monolith")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src_db_info", required=True,
                    help="db_infos pickle produced by create_infos")
    ap.add_argument("--root_path", required=True,
                    help="dataset root (db paths are relative to it)")
    ap.add_argument("--new_db_name", default="gt_database_global")
    ap.add_argument("--num_point_features", type=int, default=5)
    ap.add_argument("--dst_db_info", default=None,
                    help="output infos pickle (default: overwrite the "
                    "source, as the reference does)")
    args = ap.parse_args(argv)

    with open(args.src_db_info, "rb") as f:
        db_infos = pickle.load(f)
    out_path = Path(args.root_path) / f"{args.new_db_name}.npy"
    db_infos = build_shared_database(
        db_infos, args.root_path, out_path,
        num_point_features=args.num_point_features)
    dst = args.dst_db_info or args.src_db_info
    with open(dst, "wb") as f:
        pickle.dump(db_infos, f)
    print(f"integrated database: {out_path}\nstamped infos: {dst}")
    verify(db_infos, out_path, args.root_path, args.num_point_features)
    return out_path, dst


if __name__ == "__main__":
    main()
