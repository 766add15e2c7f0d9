"""DataBaseSampler — class-balanced GT-database copy-paste ("gt_sampling");
port of findnpropagate_tpu/datasets/augmentor/database_sampler.py.

Per-class sample groups loaded from a dbinfos pickle, min-points
filtering, IoU collision rejection against the scene's boxes and those
already placed, removal of the scene's points inside the pasted boxes; the
shared database is one stacked .npy read through a memmap
(`build_shared_database`); with USE_ROAD_PLANE the pasted boxes and their
points are set down on the sample's KITTI road plane (its `road_plane` and
`calib`). With no database on disk it is a no-op. The random draws come
from `rng`, the dataset's np.random.RandomState, in the reference's order.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ...utils import geometry_np as G


class DataBaseSampler:
    def __init__(self, sampler_cfg, root_path, class_names, logger=None,
                 rng=None):
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.cfg = sampler_cfg
        self.class_names = list(class_names)
        self.logger = logger
        self.root = Path(root_path) if root_path else None
        self.db_infos = {n: [] for n in self.class_names}
        self.enabled = False

        for db_path in sampler_cfg.get("DB_INFO_PATH", []):
            p = (self.root / db_path) if self.root else Path(db_path)
            if not p.exists():
                if logger:
                    logger.warning(f"gt_sampling: missing dbinfos {p}; disabled")
                continue
            with open(p, "rb") as f:
                infos = pickle.load(f)
            for name, lst in infos.items():
                if name in self.db_infos:
                    self.db_infos[name].extend(lst)
            self.enabled = True

        # min-points filtering (database_sampler.py PREPARE)
        prep = sampler_cfg.get("PREPARE", {})
        for flt in prep.get("filter_by_min_points", []):
            name, min_num = flt.split(":")
            min_num = int(min_num)
            if name in self.db_infos:
                self.db_infos[name] = [
                    x for x in self.db_infos[name]
                    if x.get("num_points_in_gt", 0) >= min_num
                ]

        self.sample_groups = {}
        for grp in sampler_cfg.get("SAMPLE_GROUPS", []):
            name, num = grp.split(":")
            if name in self.class_names:
                self.sample_groups[name] = int(num)
        self.num_point_features = int(sampler_cfg.get("NUM_POINT_FEATURES", 5))

        # shared database (the reference's USE_SHARED_MEMORY): one stacked
        # .npy read through a memmap that readers share in the OS page
        # cache; infos carry `global_data_offset` row ranges
        # (build_shared_database)
        self.db_data = None
        if sampler_cfg.get("USE_SHARED_MEMORY", False):
            for db_data_path in sampler_cfg.get("DB_DATA_PATH", []):
                p = (self.root / db_data_path) if self.root \
                    else Path(db_data_path)
                if p.exists():
                    self.db_data = np.load(str(p), mmap_mode="r")
                    if logger:
                        logger.info(
                            f"gt_sampling: shared DB memmap {p} "
                            f"({self.db_data.shape})")
                    break

    def _load_points(self, info):
        if self.db_data is not None and "global_data_offset" in info:
            start, end = info["global_data_offset"]
            return np.array(self.db_data[start:end], np.float32)
        path = self.root / info["path"]
        pts = np.fromfile(str(path), dtype=np.float32).reshape(
            -1, self.num_point_features
        )
        return pts

    def __call__(self, data_dict):
        if not self.enabled:
            return data_dict
        gt_boxes = data_dict.get("gt_boxes", np.zeros((0, 7), np.float32))
        gt_names = list(data_dict.get("gt_names", []))
        points = data_dict["points"]

        placed_boxes = gt_boxes[:, :7].copy() if len(gt_boxes) else \
            np.zeros((0, 7), np.float32)
        new_boxes, new_names, new_points = [], [], []
        for name, num in self.sample_groups.items():
            want = max(num - sum(n == name for n in gt_names), 0)
            pool = self.db_infos.get(name, [])
            if want <= 0 or not pool:
                continue
            choice = self.rng.choice(len(pool), min(want * 2, len(pool)),
                                     replace=False)
            taken = 0
            for ci in choice:
                if taken >= want:
                    break
                info = pool[int(ci)]
                box = np.asarray(info["box3d_lidar"], np.float32)[:7]
                cand = np.concatenate([placed_boxes, box[None]], axis=0)
                iou = G.boxes_bev_iou_cpu(box[None, :7], placed_boxes) \
                    if len(placed_boxes) else np.zeros((1, 0))
                if iou.size and iou.max() > 1e-4:
                    continue
                try:
                    obj_pts = self._load_points(info)
                except Exception:
                    continue
                obj_pts = obj_pts.copy()
                obj_pts[:, :3] += box[:3]
                placed_boxes = cand
                new_boxes.append(box)
                new_names.append(name)
                new_points.append(obj_pts)
                taken += 1

        if new_boxes:
            new_boxes = np.stack(new_boxes)
            if self.cfg.get("USE_ROAD_PLANE", False) \
                    and data_dict.get("road_plane") is not None \
                    and data_dict.get("calib") is not None:
                new_boxes = self._on_road_plane(data_dict, new_boxes,
                                                new_points)
            # remove original points inside pasted boxes (occlusion)
            inside = G.points_in_boxes_mask(points[:, :3], new_boxes)
            points = points[~inside.any(axis=0)]
            pts_cat = [points] + [
                p[:, : points.shape[1]] for p in new_points
            ]
            data_dict["points"] = np.concatenate(pts_cat, axis=0)
            data_dict["gt_boxes"] = np.concatenate(
                [gt_boxes[:, :7], new_boxes], axis=0
            ) if len(gt_boxes) else new_boxes
            data_dict["gt_names"] = np.asarray(gt_names + new_names)
            if "gt_boxes_mask" in data_dict:
                data_dict["gt_boxes_mask"] = np.concatenate(
                    [data_dict["gt_boxes_mask"],
                     np.ones(len(new_boxes), bool)]
                )
        return data_dict


    @staticmethod
    def _on_road_plane(data_dict, boxes, points):
        """Shift each pasted box, and its points in place, down so that its
        bottom sits on the road plane a*x + b*y + c*z + d = 0 (rectified
        camera frame) under its centre."""
        from ...utils.calibration_kitti import Calibration

        calib = data_dict["calib"]
        if isinstance(calib, dict):
            calib = Calibration({"P2": calib["P2"], "R0": calib["R0"],
                                 "Tr_velo2cam": calib["V2C"]})
        a, b, c, d = data_dict["road_plane"]
        center_cam = calib.lidar_to_rect(boxes[:, 0:3])
        center_cam[:, 1] = (-d - a * center_cam[:, 0]
                            - c * center_cam[:, 2]) / b
        lidar_h = calib.rect_to_lidar(center_cam)[:, 2]
        mv = boxes[:, 2] - boxes[:, 5] / 2 - lidar_h
        boxes = boxes.copy()
        boxes[:, 2] -= mv
        for i, p in enumerate(points):
            p[:, 2] -= mv[i]
        return boxes


def build_shared_database(db_infos, root_path, out_path,
                          num_point_features=5, logger=None):
    """Stack every per-object .bin into one (TotalRows, C) .npy monolith
    and stamp `global_data_offset` row ranges into the infos (the
    reference's shared-memory database). Readers share the array through
    the OS page cache via np.load(mmap_mode='r'). Returns the updated
    db_infos; callers re-pickle them next to the monolith."""
    root = Path(root_path)
    chunks, row = [], 0
    for name, lst in db_infos.items():
        for info in lst:
            pts = np.fromfile(
                str(root / info["path"]), dtype=np.float32
            ).reshape(-1, num_point_features)
            info["global_data_offset"] = (row, row + len(pts))
            row += len(pts)
            chunks.append(pts)
    data = np.concatenate(chunks, axis=0) if chunks else \
        np.zeros((0, num_point_features), np.float32)
    np.save(str(out_path), data)
    if logger:
        logger.info(f"shared gt database: {data.shape} rows -> {out_path}")
    return db_infos
