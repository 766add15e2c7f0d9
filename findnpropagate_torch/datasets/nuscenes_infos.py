"""nuScenes info generation without the devkit — port of
findnpropagate_tpu/datasets/nuscenes_infos.py (numpy).

A nuScenes release is JSON tables; this module reads them directly
(sample, sample_data, ego_pose, calibrated_sensor, sample_annotation,
scene, instance, attribute, category) and emits the info-pkl schema:

  lidar_path, token, sweeps[{lidar_path, transform_matrix, time_lag}],
  ref_from_car, car_from_global, timestamp,
  gt_boxes (N, 9) [x y z l w h yaw vx vy] in the LIDAR frame,
  gt_names (detection classes), num_lidar_pts/num_radar_pts,
  optional cams{...} camera matrices for the open-vocabulary pipeline;
and `create_groundtruth_database` cuts each ground truth's points out of
its sweep for gt_sampling.
"""

from __future__ import annotations

import json
import pickle
from functools import reduce
from pathlib import Path

import numpy as np

# official general->detection class mapping
MAP_NAME = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}
CAMERA_TYPES = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT")


def quat_to_rot(q):
    """[w, x, y, z] -> (3, 3) rotation matrix."""
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float64)


def quat_yaw(q):
    """Yaw of the rotated x-axis (devkit quaternion_yaw)."""
    v = quat_to_rot(q) @ np.array([1.0, 0.0, 0.0])
    return float(np.arctan2(v[1], v[0]))


def transform_matrix(translation, rotation_q, inverse=False):
    tm = np.eye(4)
    rot = quat_to_rot(rotation_q)
    if inverse:
        tm[:3, :3] = rot.T
        tm[:3, 3] = rot.T @ (-np.asarray(translation))
    else:
        tm[:3, :3] = rot
        tm[:3, 3] = translation
    return tm


class NuScenesTables:
    """Minimal table reader: token-indexed access like the devkit."""

    TABLES = ("sample", "sample_data", "ego_pose", "calibrated_sensor",
              "sample_annotation", "scene", "instance", "attribute",
              "category")

    def __init__(self, data_path, version="v1.0-trainval"):
        self.data_path = Path(data_path)
        self.version = version
        tdir = self.data_path / version
        self._tables = {}
        self._index = {}
        for name in self.TABLES:
            fp = tdir / f"{name}.json"
            rows = json.loads(fp.read_text()) if fp.exists() else []
            self._tables[name] = rows
            self._index[name] = {r["token"]: r for r in rows}
        # per-sample annotation lists + the devkit's reverse index: raw
        # sample_annotation rows carry only instance_token; the devkit
        # injects category_name (nuscenes.py __make_reverse_index__) and
        # downstream code relies on it
        self._sample_anns = {}
        inst = self._index.get("instance", {})
        cat = self._index.get("category", {})
        for ann in self._tables["sample_annotation"]:
            if "category_name" not in ann:
                it = ann.get("instance_token")
                ct = inst.get(it, {}).get("category_token")
                if ct in cat:
                    ann["category_name"] = cat[ct]["name"]
            self._sample_anns.setdefault(ann["sample_token"], []).append(ann)

    def get(self, table, token):
        return self._index[table][token]

    @property
    def sample(self):
        return self._tables["sample"]

    def sample_anns(self, sample_token):
        return self._sample_anns.get(sample_token, [])

    def box_velocity(self, ann, max_time_diff=1.5):
        """Finite-difference global-frame velocity (devkit box_velocity)."""
        has_prev = ann["prev"] != ""
        has_next = ann["next"] != ""
        if not has_prev and not has_next:
            return np.array([np.nan, np.nan, np.nan])
        first = self.get("sample_annotation", ann["prev"]) if has_prev else ann
        last = self.get("sample_annotation", ann["next"]) if has_next else ann
        pos_first = np.asarray(first["translation"])
        pos_last = np.asarray(last["translation"])
        t_first = 1e-6 * self.get("sample", first["sample_token"])["timestamp"]
        t_last = 1e-6 * self.get("sample", last["sample_token"])["timestamp"]
        dt = t_last - t_first
        if dt > max_time_diff or dt <= 0:
            return np.array([np.nan, np.nan, np.nan])
        return (pos_last - pos_first) / dt


def _boxes_in_lidar(nusc: NuScenesTables, sample, ref_cs, ref_pose):
    """Sample annotations -> (N, 9) lidar-frame boxes + names + counts."""
    anns = nusc.sample_anns(sample["token"])
    r_cs = quat_to_rot(ref_cs["rotation"])
    t_cs = np.asarray(ref_cs["translation"])
    r_pose = quat_to_rot(ref_pose["rotation"])
    t_pose = np.asarray(ref_pose["translation"])

    rows, names, n_lidar, n_radar, attrs, tokens = [], [], [], [], [], []
    for ann in anns:
        center = np.asarray(ann["translation"])
        # global -> ego -> lidar
        c_ego = r_pose.T @ (center - t_pose)
        c_lid = r_cs.T @ (c_ego - t_cs)
        w, l, h = ann["size"]
        yaw_global = quat_yaw(ann["rotation"])
        # rotation composition reduces to yaw offsets for z-up frames;
        # exact form: rotate orientation quats like the devkit does
        q = ann["rotation"]
        rot = r_cs.T @ r_pose.T @ quat_to_rot(q)
        v = rot @ np.array([1.0, 0.0, 0.0])
        yaw = float(np.arctan2(v[1], v[0]))
        vel = nusc.box_velocity(ann)
        vel = np.nan_to_num(vel)
        v_lid = r_cs.T @ (r_pose.T @ vel)
        rows.append([*c_lid, l, w, h, yaw, v_lid[0], v_lid[1]])
        names.append(MAP_NAME.get(ann["category_name"],
                                  ann["category_name"]))
        n_lidar.append(ann["num_lidar_pts"])
        n_radar.append(ann["num_radar_pts"])
        tokens.append(ann["token"])
        at = ann.get("attribute_tokens", [])
        attrs.append(nusc.get("attribute", at[0])["name"] if at else "")
    if not rows:
        z = np.zeros
        return (z((0, 9)), np.array([], dtype=object), z(0, dtype=np.int64),
                z(0, dtype=np.int64), np.array([], dtype=object),
                np.array([], dtype=object))
    return (np.asarray(rows, np.float32), np.asarray(names, dtype=object),
            np.asarray(n_lidar), np.asarray(n_radar),
            np.asarray(attrs, dtype=object), np.asarray(tokens, dtype=object))


def fill_trainval_infos(nusc: NuScenesTables, max_sweeps=10, with_cam=False,
                        test=False):
    """All samples -> (train_infos, val_infos) split by official scene
    splits when available (else scene-name heuristic: every 8th scene val)."""
    scenes = nusc._tables["scene"]
    val_scene_tokens = {s["token"] for i, s in enumerate(scenes)
                        if i % 8 == 0}

    train_infos, val_infos = [], []
    for sample in nusc.sample:
        ref_sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        ref_cs = nusc.get("calibrated_sensor",
                          ref_sd["calibrated_sensor_token"])
        ref_pose = nusc.get("ego_pose", ref_sd["ego_pose_token"])
        ref_time = 1e-6 * ref_sd["timestamp"]
        ref_from_car = transform_matrix(ref_cs["translation"],
                                        ref_cs["rotation"], inverse=True)
        car_from_global = transform_matrix(ref_pose["translation"],
                                           ref_pose["rotation"], inverse=True)
        info = {
            "lidar_path": ref_sd["filename"],
            "token": sample["token"],
            "sweeps": [],
            "ref_from_car": ref_from_car,
            "car_from_global": car_from_global,
            "timestamp": ref_time,
        }

        # sweeps: walk the previous sample_datas
        curr = ref_sd
        sweeps = []
        while len(sweeps) < max_sweeps - 1:
            if curr["prev"] == "":
                if len(sweeps) == 0:
                    sweeps.append({
                        "lidar_path": ref_sd["filename"],
                        "sample_data_token": curr["token"],
                        "transform_matrix": None,
                        "time_lag": 0.0,
                        "sensor2lidar_rotation": np.eye(3),
                        "sensor2lidar_translation": np.zeros(3),
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr = nusc.get("sample_data", curr["prev"])
                pose = nusc.get("ego_pose", curr["ego_pose_token"])
                cs = nusc.get("calibrated_sensor",
                              curr["calibrated_sensor_token"])
                global_from_car = transform_matrix(pose["translation"],
                                                   pose["rotation"])
                car_from_current = transform_matrix(cs["translation"],
                                                    cs["rotation"])
                tm = reduce(np.dot, [ref_from_car, car_from_global,
                                     global_from_car, car_from_current])
                sweeps.append({
                    "lidar_path": curr["filename"],
                    "sample_data_token": curr["token"],
                    "transform_matrix": tm,
                    "sensor2lidar_rotation": tm[:3, :3],
                    "sensor2lidar_translation": tm[:3, 3],
                    "time_lag": ref_time - 1e-6 * curr["timestamp"],
                })
        info["sweeps"] = sweeps

        if with_cam:
            cams = {}
            for cam in CAMERA_TYPES:
                if cam not in sample["data"]:
                    continue
                sd = nusc.get("sample_data", sample["data"][cam])
                cs = nusc.get("calibrated_sensor",
                              sd["calibrated_sensor_token"])
                pose = nusc.get("ego_pose", sd["ego_pose_token"])
                cam_from_global = reduce(np.dot, [
                    transform_matrix(cs["translation"], cs["rotation"],
                                     inverse=True),
                    transform_matrix(pose["translation"], pose["rotation"],
                                     inverse=True)])
                lidar2cam = cam_from_global @ np.linalg.inv(
                    car_from_global) @ np.linalg.inv(ref_from_car)
                intr = np.eye(4)
                intr[:3, :3] = np.asarray(cs["camera_intrinsic"])
                cams[cam] = {
                    "data_path": sd["filename"],
                    "camera_intrinsics": intr,
                    "lidar2camera": lidar2cam,
                    "camera2lidar": np.linalg.inv(lidar2cam),
                    "lidar2image": intr @ lidar2cam,
                }
            info["cams"] = cams

        if not test:
            boxes, names, n_lidar, n_radar, attrs, tokens = _boxes_in_lidar(
                nusc, sample, ref_cs, ref_pose)
            mask = (n_lidar + n_radar) > 0 if len(boxes) else \
                np.zeros(0, bool)
            info["gt_boxes"] = boxes[mask]
            info["gt_names"] = names[mask]
            info["gt_attrs"] = attrs[mask]
            info["gt_boxes_token"] = tokens[mask]
            info["num_lidar_pts"] = n_lidar[mask]
            info["num_radar_pts"] = n_radar[mask]

        scene_token = nusc.get("sample", sample["token"])["scene_token"]
        (val_infos if scene_token in val_scene_tokens
         else train_infos).append(info)
    return train_infos, val_infos


def create_nuscenes_infos(data_path, save_path=None,
                          version="v1.0-trainval", max_sweeps=10,
                          with_cam=False, logger=None):
    nusc = NuScenesTables(data_path, version)
    train_infos, val_infos = fill_trainval_infos(
        nusc, max_sweeps=max_sweeps, with_cam=with_cam,
        test="test" in version)
    save = Path(save_path or data_path)
    emit = logger.info if logger else print
    out = {}
    for split, infos in (("train", train_infos), ("val", val_infos)):
        fp = save / f"nuscenes_infos_{max_sweeps}sweeps_{split}.pkl"
        with open(fp, "wb") as f:
            pickle.dump(infos, f)
        emit(f"nuscenes infos {split}: {len(infos)} -> {fp}")
        out[split] = fp
    return out


def create_groundtruth_database(data_path, info_path, save_path=None,
                                used_classes=None, logger=None):
    """Object point crops for gt_sampling."""
    from ..utils.geometry_np import points_in_boxes_mask

    root = Path(data_path)
    save = Path(save_path or data_path)
    db_dir = save / "gt_database"
    db_dir.mkdir(parents=True, exist_ok=True)
    with open(info_path, "rb") as f:
        infos = pickle.load(f)
    db_infos = {}
    for info in infos:
        boxes = np.asarray(info.get("gt_boxes", np.zeros((0, 9))))
        if len(boxes) == 0:
            continue
        pts = np.fromfile(str(root / info["lidar_path"]),
                          np.float32).reshape(-1, 5)
        inside = points_in_boxes_mask(pts[:, :3], boxes[:, :7])  # (N, P)
        stem = Path(info["lidar_path"]).stem
        for i, name in enumerate(info["gt_names"]):
            if used_classes and name not in used_classes:
                continue
            obj = pts[inside[i]].copy()
            obj[:, :3] -= boxes[i, :3]
            fname = f"{stem}_{name}_{i}.bin"
            obj.astype(np.float32).tofile(str(db_dir / fname))
            db_infos.setdefault(name, []).append({
                "name": name, "path": f"gt_database/{fname}",
                "image_idx": stem, "gt_idx": i,
                "box3d_lidar": boxes[i, :7],
                "num_points_in_gt": int(inside[i].sum()),
            })
    fp = save / "nuscenes_dbinfos_train.pkl"
    with open(fp, "wb") as f:
        pickle.dump(db_infos, f)
    (logger.info if logger else print)(
        "gt database: " + ", ".join(f"{k}: {len(v)}"
                                    for k, v in db_infos.items()))
    return fp
