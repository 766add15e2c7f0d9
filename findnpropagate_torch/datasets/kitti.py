"""KittiDataset — info-pkl based KITTI loader and raw-data bootstrap; port
of findnpropagate_tpu/datasets/kitti.py on the port's DatasetTemplate.

Loads the kitti_infos_*.pkl pickles and the velodyne .bin files; a sample
carries `calib` (P2, R0, V2C: the KITTI seeker's and USE_ROAD_PLANE's
input) and, where training/planes/ holds one, its `road_plane`. The
evaluation is datasets/kitti_eval.py. `create_kitti_infos` /
`create_groundtruth_database` build both pickles and the gt database from
a raw KITTI tree (velodyne / label_2 / calib / ImageSets).
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from .dataset import DatasetTemplate


class KittiDataset(DatasetTemplate):
    def __init__(self, dataset_cfg, class_names, training=True, logger=None,
                 root_path=None, rng=None, hooks=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, logger=logger, root_path=root_path, rng=rng,
            hooks=hooks,
        )
        self.root = Path(root_path or dataset_cfg.get("DATA_PATH", "data/kitti"))
        self.split = dataset_cfg["DATA_SPLIT"]["train" if training else "test"]
        self.infos = []
        info_paths = dataset_cfg.get("INFO_PATH", {}).get(
            "train" if training else "test", []
        )
        for p in info_paths:
            fp = self.root / p
            if fp.exists():
                with open(fp, "rb") as f:
                    self.infos.extend(pickle.load(f))
        if not self.infos and logger is not None:
            logger.warning(f"KittiDataset: no infos found under {self.root}")

    def __len__(self):
        return len(self.infos)

    def get_lidar(self, idx):
        lidar_file = self.root / "training" / "velodyne" / f"{idx}.bin"
        return np.fromfile(str(lidar_file), dtype=np.float32).reshape(-1, 4)

    def __getitem__(self, index):
        info = self.infos[index]
        sample_idx = info["point_cloud"]["lidar_idx"]
        points = self.get_lidar(sample_idx)
        data_dict = {"points": points, "frame_id": sample_idx}
        if "calib" in info:
            # raw calib matrices for the KITTI open-vocabulary seeker
            data_dict["calib"] = {
                "P2": np.asarray(info["calib"]["P2"], np.float32),
                "R0": np.asarray(info["calib"]["R0_rect"], np.float32),
                "V2C": np.asarray(info["calib"]["Tr_velo_to_cam"], np.float32),
            }
        plane_file = self.root / "training" / "planes" / f"{sample_idx}.txt"
        if plane_file.exists():
            # KITTI road plane: line 4 holds
            # [a, b, c, d]; normalize and flip so b > 0
            lines = plane_file.read_text().splitlines()
            plane = np.asarray(lines[3].split(), np.float32)
            if plane[1] > 0:
                plane = -plane
            data_dict["road_plane"] = plane / np.linalg.norm(plane[:3])
        if "annos" in info:
            annos = info["annos"]
            mask = annos["name"] != "DontCare"
            gt_boxes = annos["gt_boxes_lidar"][: mask.sum()]
            data_dict["gt_boxes"] = gt_boxes
            data_dict["gt_names"] = annos["name"][mask]
        return self.prepare_data(data_dict)

    def evaluation(self, det_annos, class_names, **kwargs):
        from .kitti_eval import kitti_eval

        gt_annos = [info.get("annos", {"name": np.array([])})
                    for info in self.infos[: len(det_annos)]]
        # attach class names to detections (labels are 1-indexed)
        for d in det_annos:
            if "name" not in d:
                labels = np.asarray(d.get("labels", []), int)
                d["name"] = np.asarray(
                    [class_names[l - 1] if 1 <= l <= len(class_names) else "?"
                     for l in labels]
                )
        return kitti_eval(gt_annos, det_annos, class_names)


# ---------------------------------------------------------------- bootstrap

def _split_ids(root: Path, split: str):
    f = root / "ImageSets" / f"{split}.txt"
    if f.exists():
        return [line.strip() for line in f.read_text().splitlines()
                if line.strip()]
    vel = root / "training" / "velodyne"
    return sorted(p.stem for p in vel.glob("*.bin"))


def build_kitti_info(root: Path, sample_idx: str, count_points=True):
    """One info dict of the kitti_infos schema: point_cloud / calib /
    annos with gt_boxes_lidar precomputed."""
    from ..utils.calibration_kitti import (
        Calibration, get_objects_from_label, objects_to_boxes_lidar,
    )

    info = {"point_cloud": {"num_features": 4, "lidar_idx": sample_idx}}
    calib_file = root / "training" / "calib" / f"{sample_idx}.txt"
    label_file = root / "training" / "label_2" / f"{sample_idx}.txt"
    if calib_file.exists():
        calib = Calibration(str(calib_file))
        info["calib"] = {"P2": calib.P2, "R0_rect": calib.R0,
                         "Tr_velo_to_cam": calib.V2C}
        if label_file.exists():
            objects = get_objects_from_label(str(label_file))
            boxes, names, levels, boxes2d = objects_to_boxes_lidar(
                objects, calib)
            num_dc = sum(1 for o in objects if o.cls_type == "DontCare")
            annos = {
                "name": names,
                "gt_boxes_lidar": boxes,
                "difficulty": levels,
                "bbox": boxes2d,
                "truncated": np.asarray(
                    [o.truncation for o in objects
                     if o.cls_type != "DontCare"], np.float32),
                "occluded": np.asarray(
                    [o.occlusion for o in objects
                     if o.cls_type != "DontCare"], np.float32),
                "num_dontcare": num_dc,
            }
            if count_points:
                lidar = root / "training" / "velodyne" / f"{sample_idx}.bin"
                if lidar.exists() and len(boxes):
                    from ..utils.geometry_np import points_in_boxes_mask

                    pts = np.fromfile(str(lidar), np.float32).reshape(-1, 4)
                    inside = points_in_boxes_mask(pts[:, :3], boxes)  # (N,P)
                    annos["num_points_in_gt"] = inside.sum(axis=1).astype(
                        np.int32)
            info["annos"] = annos
    return info


def create_kitti_infos(data_path, save_path=None, splits=("train", "val"),
                      logger=None):
    """Regenerate kitti_infos_<split>.pkl from a raw KITTI tree."""
    root = Path(data_path)
    save = Path(save_path or data_path)
    out = {}
    for split in splits:
        infos = [build_kitti_info(root, idx) for idx in _split_ids(root, split)]
        fp = save / f"kitti_infos_{split}.pkl"
        with open(fp, "wb") as f:
            pickle.dump(infos, f)
        (logger.info if logger else print)(
            f"kitti infos {split}: {len(infos)} -> {fp}")
        out[split] = fp
    return out


def create_groundtruth_database(data_path, info_path, save_path=None,
                                used_classes=None, logger=None):
    """Per-object point crops + dbinfos pkl for gt_sampling."""
    from ..utils.geometry_np import points_in_boxes_mask

    root = Path(data_path)
    save = Path(save_path or data_path)
    db_dir = save / "gt_database"
    db_dir.mkdir(parents=True, exist_ok=True)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    db_infos = {}
    for info in infos:
        idx = info["point_cloud"]["lidar_idx"]
        annos = info.get("annos")
        if annos is None or len(annos["gt_boxes_lidar"]) == 0:
            continue
        pts = np.fromfile(
            str(root / "training" / "velodyne" / f"{idx}.bin"), np.float32
        ).reshape(-1, 4)
        boxes = annos["gt_boxes_lidar"]
        inside = points_in_boxes_mask(pts[:, :3], boxes).T  # (P, N)
        for i, name in enumerate(annos["name"]):
            if used_classes and name not in used_classes:
                continue
            obj_pts = pts[inside[:, i]]
            obj_pts = obj_pts.copy()
            obj_pts[:, :3] -= boxes[i, :3]
            fname = f"{idx}_{name}_{i}.bin"
            obj_pts.astype(np.float32).tofile(str(db_dir / fname))
            db_infos.setdefault(name, []).append({
                "name": name, "path": f"gt_database/{fname}",
                "image_idx": idx, "gt_idx": i,
                "box3d_lidar": boxes[i],
                "num_points_in_gt": int(inside[:, i].sum()),
                "difficulty": int(annos["difficulty"][i]),
            })
    fp = save / "kitti_dbinfos_train.pkl"
    with open(fp, "wb") as f:
        pickle.dump(db_infos, f)
    (logger.info if logger else print)(
        "gt database: " + ", ".join(f"{k}: {len(v)}"
                                    for k, v in db_infos.items()))
    return fp
