"""Dataset bootstrap CLI: info pickles and gt databases from a raw
dataset tree — port of tools/create_infos.py (numpy only, no device).

    python -m findnpropagate_torch.tools.create_infos kitti
        --data_path data/kitti [--save_path DIR] [--gt_database]
        [--classes NAME ...]
    python -m findnpropagate_torch.tools.create_infos nuscenes
        --data_path data/nuscenes [--version v1.0-trainval]
        [--max_sweeps 10] [--with_cam] [--gt_database] [--classes NAME ...]

KITTI reads velodyne / label_2 / calib / ImageSets and writes
kitti_infos_<split>.pkl (and with --gt_database gt_database/ and
kitti_dbinfos_train.pkl); nuScenes reads the release's JSON tables of
`--version` without the devkit and writes
nuscenes_infos_<max_sweeps>sweeps_<split>.pkl (and nuscenes_dbinfos_
train.pkl). The reference's other datasets (lyft, pandaset, argo2, once,
waymo) are not ported yet (ROADMAP.md queue 1 item 14).
"""

from __future__ import annotations

import argparse
import sys

DATASETS = ("kitti", "nuscenes", "lyft", "pandaset", "argo2", "once",
            "waymo")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dataset", choices=DATASETS)
    ap.add_argument("--data_path", required=True)
    ap.add_argument("--save_path", default=None)
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--max_sweeps", type=int, default=10)
    ap.add_argument("--with_cam", action="store_true")
    ap.add_argument("--gt_database", action="store_true")
    ap.add_argument("--classes", nargs="*", default=None)
    args = ap.parse_args(argv)

    if args.dataset == "kitti":
        from ..datasets.kitti import (
            create_groundtruth_database,
            create_kitti_infos,
        )

        out = create_kitti_infos(args.data_path, args.save_path)
    elif args.dataset == "nuscenes":
        from ..datasets.nuscenes_infos import (
            create_groundtruth_database,
            create_nuscenes_infos,
        )

        out = create_nuscenes_infos(
            args.data_path, args.save_path, version=args.version,
            max_sweeps=args.max_sweeps, with_cam=args.with_cam)
    else:
        raise NotImplementedError(
            f"create_infos {args.dataset}: not ported yet (ROADMAP.md queue "
            "1 item 14); the port has kitti and nuscenes")
    if args.gt_database and "train" in out:
        create_groundtruth_database(args.data_path, out["train"],
                                    args.save_path,
                                    used_classes=args.classes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
