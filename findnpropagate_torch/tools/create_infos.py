"""Dataset bootstrap CLI: info pickles and gt databases from a raw
dataset tree — port of tools/create_infos.py (numpy only, no device).

    python -m findnpropagate_torch.tools.create_infos kitti
        --data_path data/kitti [--save_path DIR] [--gt_database]
        [--classes NAME ...]
    python -m findnpropagate_torch.tools.create_infos nuscenes
        --data_path data/nuscenes [--version v1.0-trainval]
        [--max_sweeps 10] [--with_cam] [--gt_database] [--classes NAME ...]
    python -m findnpropagate_torch.tools.create_infos waymo
        --data_path data/waymo [--sampled_interval 1] [--single_return]
        [--gt_database] [--classes NAME ...]
    python -m findnpropagate_torch.tools.create_infos once
        --data_path data/once
    python -m findnpropagate_torch.tools.create_infos lyft
        --data_path data/lyft/trainval [--max_sweeps 10]
    python -m findnpropagate_torch.tools.create_infos pandaset
        --data_path data/pandaset
    python -m findnpropagate_torch.tools.create_infos argo2
        --data_path data/argo2/sensor

KITTI reads velodyne / label_2 / calib / ImageSets and writes
kitti_infos_<split>.pkl (and with --gt_database gt_database/ and
kitti_dbinfos_train.pkl); nuScenes reads the release's JSON tables of
`--version` without the devkit and writes
nuscenes_infos_<max_sweeps>sweeps_<split>.pkl (and nuscenes_dbinfos_
train.pkl). Waymo decodes raw_data/<seq>.tfrecord (the sequences of
ImageSets/<split>.txt) into waymo_processed_data/<seq>/ (%04d.npy points
and <seq>.pkl infos; with --gt_database gt_database_train/ and
waymo_dbinfos_train.pkl); ONCE reads data/<seq>/<seq>.json and writes
once_infos_<split>.pkl (no gt database); Lyft reads nuScenes-schema tables
and writes lyft_infos_<split>.pkl; Pandaset and Argo2 read pandas pickles
and feather files and need pandas.
"""

from __future__ import annotations

import argparse
import sys

DATASETS = ("kitti", "nuscenes", "lyft", "pandaset", "argo2", "once",
            "waymo")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dataset", choices=DATASETS)
    ap.add_argument("--sampled_interval", type=int, default=1)
    ap.add_argument("--single_return", action="store_true",
                    help="waymo: first lidar return only")
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
    elif args.dataset == "waymo":
        from ..datasets.waymo_infos import (
            create_waymo_gt_database,
            create_waymo_infos,
        )

        create_waymo_infos(
            args.data_path, args.save_path,
            sampled_interval=args.sampled_interval,
            use_two_returns=not args.single_return)
        if args.gt_database:
            create_waymo_gt_database(args.data_path, args.save_path,
                                     used_classes=args.classes)
        return 0
    else:
        from ..datasets import misc_infos

        if args.dataset == "lyft":
            misc_infos.create_lyft_infos(args.data_path, args.save_path,
                                         max_sweeps=args.max_sweeps)
        else:
            getattr(misc_infos, f"create_{args.dataset}_infos")(
                args.data_path, args.save_path)
        return 0
    if args.gt_database and "train" in out:
        create_groundtruth_database(args.data_path, out["train"],
                                    args.save_path,
                                    used_classes=args.classes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
