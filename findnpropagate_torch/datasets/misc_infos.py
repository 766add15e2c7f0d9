"""Info generation without the devkits for Lyft, Pandaset, Argoverse 2 and
ONCE — port of findnpropagate_tpu/datasets/misc_infos.py (numpy; pandas,
imported where it is used, for Pandaset and Argo2).

  * Lyft L5: nuScenes-schema JSON tables (the lyft devkit is a nuScenes
    fork) read through the port's `NuScenesTables`.
  * Pandaset: gzipped pandas pickles (lidar + cuboid DataFrames) and a
    poses.json per sequence. The world -> ego -> normative conversion runs
    once here and is cached as .npy, so the loader reads the points as
    they are.
  * Argo2: feather files read through pandas / pyarrow, converted to
    KITTI-style annos and packed velodyne bins.
  * ONCE: per-sequence JSON and lidar bins.

Waymo's info generation is `waymo_infos.py`.
"""

from __future__ import annotations

import gzip
import json
import pickle
from functools import reduce
from pathlib import Path

import numpy as np

from .nuscenes_infos import NuScenesTables, quat_to_rot, transform_matrix


# ---------------------------------------------------------------------------
# Lyft L5
# ---------------------------------------------------------------------------

def _lyft_boxes_in_lidar(tables: NuScenesTables, sample, ref_cs, ref_pose):
    """Annotations -> lidar-frame (N, 7) boxes + (N, 3) velocity + names.

    Same global->ego->sensor chain as nuScenes but WITHOUT the
    num_lidar_pts visibility mask (lyft annotations carry no point
    counts, so every box is kept)."""
    anns = tables.sample_anns(sample["token"])
    r_cs = quat_to_rot(ref_cs["rotation"])
    t_cs = np.asarray(ref_cs["translation"])
    r_pose = quat_to_rot(ref_pose["rotation"])
    t_pose = np.asarray(ref_pose["translation"])

    rows, vels, names, tokens = [], [], [], []
    for ann in anns:
        center = np.asarray(ann["translation"])
        c_ego = r_pose.T @ (center - t_pose)
        c_lid = r_cs.T @ (c_ego - t_cs)
        w, l, h = ann["size"]
        rot = r_cs.T @ r_pose.T @ quat_to_rot(ann["rotation"])
        v = rot @ np.array([1.0, 0.0, 0.0])
        yaw = float(np.arctan2(v[1], v[0]))
        vel = np.nan_to_num(tables.box_velocity(ann))
        v_lid = r_cs.T @ (r_pose.T @ vel)
        rows.append([*c_lid, l, w, h, yaw])
        vels.append(v_lid)
        names.append(ann["category_name"])
        tokens.append(ann["token"])
    if not rows:
        return (np.zeros((0, 7), np.float32), np.zeros((0, 3), np.float32),
                np.array([], dtype=object), np.array([], dtype=object))
    return (np.asarray(rows, np.float32), np.asarray(vels, np.float32),
            np.asarray(names, dtype=object), np.asarray(tokens, dtype=object))


def fill_lyft_infos(tables: NuScenesTables, train_scene_tokens,
                    val_scene_tokens, max_sweeps=10, test=False):
    """All samples -> (train, val) info lists."""
    train_infos, val_infos = [], []
    for sample in tables.sample:
        ref_sd = tables.get("sample_data", sample["data"]["LIDAR_TOP"])
        ref_cs = tables.get("calibrated_sensor",
                            ref_sd["calibrated_sensor_token"])
        ref_pose = tables.get("ego_pose", ref_sd["ego_pose_token"])
        ref_time = 1e-6 * ref_sd["timestamp"]
        ref_from_car = transform_matrix(ref_cs["translation"],
                                        ref_cs["rotation"], inverse=True)
        car_from_global = transform_matrix(ref_pose["translation"],
                                           ref_pose["rotation"], inverse=True)
        info = {
            "lidar_path": ref_sd["filename"],
            "token": sample["token"],
            "ref_from_car": ref_from_car,
            "ref_to_car": transform_matrix(ref_cs["translation"],
                                           ref_cs["rotation"]),
            "car_from_global": car_from_global,
            "car_to_global": transform_matrix(ref_pose["translation"],
                                              ref_pose["rotation"]),
            "timestamp": ref_time,
            "sweeps": [],
        }

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
                    })
                else:
                    sweeps.append(sweeps[-1])
            else:
                curr = tables.get("sample_data", curr["prev"])
                pose = tables.get("ego_pose", curr["ego_pose_token"])
                cs = tables.get("calibrated_sensor",
                                curr["calibrated_sensor_token"])
                tm = reduce(np.dot, [
                    ref_from_car, car_from_global,
                    transform_matrix(pose["translation"], pose["rotation"]),
                    transform_matrix(cs["translation"], cs["rotation"])])
                sweeps.append({
                    "lidar_path": curr["filename"],
                    "sample_data_token": curr["token"],
                    "transform_matrix": tm,
                    "time_lag": ref_time - 1e-6 * curr["timestamp"],
                })
        info["sweeps"] = sweeps

        if not test:
            boxes, vels, names, tokens = _lyft_boxes_in_lidar(
                tables, sample, ref_cs, ref_pose)
            info["gt_boxes"] = boxes
            info["gt_boxes_velocity"] = vels
            info["gt_names"] = names
            info["gt_boxes_token"] = tokens

        scene_token = sample["scene_token"]
        if scene_token in val_scene_tokens:
            val_infos.append(info)
        elif train_scene_tokens is None or scene_token in train_scene_tokens:
            train_infos.append(info)
    return train_infos, val_infos


def create_lyft_infos(data_path, save_path=None, max_sweeps=10,
                      table_dir="data", logger=None):
    """`data_path` is the version root (e.g. data/lyft/trainval) holding
    `data/*.json` tables + lidar files; scene splits come from
    `../ImageSets/{train,val}.txt` when present, else every 8th scene goes to val."""
    root = Path(data_path)
    tables = NuScenesTables(root, table_dir)
    emit = logger.info if logger else print

    split_dir = root.parent / "ImageSets"
    scenes = tables._tables["scene"]
    by_name = {s["name"]: s["token"] for s in scenes}

    def read_split(fname):
        fp = split_dir / fname
        if not fp.exists():
            return None
        return {by_name[n] for n in fp.read_text().split() if n in by_name}

    train_tokens = read_split("train.txt")
    val_tokens = read_split("val.txt")
    if val_tokens is None:
        val_tokens = {s["token"] for i, s in enumerate(scenes) if i % 8 == 0}
        if train_tokens is None:
            train_tokens = {s["token"] for s in scenes} - val_tokens

    train_infos, val_infos = fill_lyft_infos(
        tables, train_tokens, val_tokens, max_sweeps=max_sweeps)
    save = Path(save_path or root)
    save.mkdir(parents=True, exist_ok=True)
    out = {}
    for split, infos in (("train", train_infos), ("val", val_infos)):
        fp = save / f"lyft_infos_{split}.pkl"
        with open(fp, "wb") as f:
            pickle.dump(infos, f)
        emit(f"lyft infos {split}: {len(infos)} -> {fp}")
        out[split] = fp
    return out


# ---------------------------------------------------------------------------
# Pandaset
# ---------------------------------------------------------------------------

def _pose_inverse_apply(points, pose):
    """World -> ego: inverse of the sensor pose (devkit
    ps.geometry.lidar_points_to_ego)."""
    q = pose["heading"]
    rot = quat_to_rot([q["w"], q["x"], q["y"], q["z"]])
    t = np.array([pose["position"]["x"], pose["position"]["y"],
                  pose["position"]["z"]])
    return (points - t) @ rot  # == rot.T @ (p - t) per-row


def _read_pandas_pickle(path):
    import pandas as pd

    return pd.read_pickle(path)


def create_pandaset_infos(data_path, save_path=None, sequences=None,
                          lidar_device=0, training_categories=None,
                          logger=None):
    """Walk `<data_path>/dataset/<seq>/` raw trees; emit per-frame infos with
    PREPROCESSED normative-frame points (.npy) + ego boxes, matching what
    `PandasetDataset.__getitem__` consumes.

    The reference converts world -> ego in every __getitem__; here it
    runs once at info time — same math: inverse sensor pose, then the axis swap (x right, y fwd) ->
    (x fwd, y left), yaw += zrot_world_to_ego, dims x/y swapped.
    """
    root = Path(data_path)
    ds_dir = root / "dataset"
    save = Path(save_path or root)
    pts_dir = save / "preprocessed"
    pts_dir.mkdir(parents=True, exist_ok=True)
    emit = logger.info if logger else print

    all_seqs = sorted(p.name for p in ds_dir.iterdir() if p.is_dir())
    if sequences is None:
        # default: ~60/20/20 by position, like the fixed random split of
        # pandaset_dataset.yaml's SEQUENCES
        n = len(all_seqs)
        sequences = {"train": all_seqs[: int(n * 0.6)],
                     "val": all_seqs[int(n * 0.6): int(n * 0.8)],
                     "test": all_seqs[int(n * 0.8):]}

    out = {}
    for split, seqs in sequences.items():
        infos = []
        for seq in seqs:
            seq_dir = ds_dir / seq
            poses_fp = seq_dir / "lidar" / "poses.json"
            if not poses_fp.exists():
                continue
            poses = json.loads(poses_fp.read_text())
            frames = sorted(
                p for p in (seq_dir / "lidar").glob("*.pkl*")
                if "poses" not in p.name)
            for frame_idx, frame_fp in enumerate(frames):
                pose = poses[frame_idx]
                lidar = _read_pandas_pickle(frame_fp)
                if lidar_device != -1 and "d" in lidar.columns:
                    lidar = lidar[lidar.d == lidar_device]
                world = lidar[["x", "y", "z", "i"]].to_numpy(np.float64)
                ego = _pose_inverse_apply(world[:, :3], pose)
                # pandaset ego (x right, y fwd, z up) -> normative
                pts = np.empty((len(ego), 4), np.float32)
                pts[:, 0] = ego[:, 1]
                pts[:, 1] = -ego[:, 0]
                pts[:, 2] = ego[:, 2]
                pts[:, 3] = world[:, 3] / 255.0
                stem = f"{seq}_{frame_fp.name.split('.')[0]}"
                np.save(pts_dir / f"{stem}.npy", pts)

                info = {"sequence": seq, "frame_idx": frame_idx,
                        "points_path": f"preprocessed/{stem}.npy"}

                cub_fp = seq_dir / "annotations" / "cuboids" / frame_fp.name
                if cub_fp.exists():
                    cub = _read_pandas_pickle(cub_fp)
                    if lidar_device != -1 and "cuboids.sensor_id" in \
                            cub.columns:
                        cub = cub[cub["cuboids.sensor_id"] != 1 - lidar_device]
                    centers = cub[["position.x", "position.y",
                                   "position.z"]].to_numpy(np.float64)
                    dims = cub[["dimensions.x", "dimensions.y",
                                "dimensions.z"]].to_numpy(np.float64)
                    yaws = cub["yaw"].to_numpy(np.float64)
                    names = cub["label"].to_numpy()
                    ego_c = _pose_inverse_apply(centers, pose)
                    # yaw offset of the world y-axis in the ego frame
                    yax = _pose_inverse_apply(
                        np.array([[0.0, 0, 0], [0, 1.0, 0]]), pose)
                    yax = yax[1] - yax[0]
                    zrot = float(np.arctan2(-yax[0], yax[1]))
                    boxes = np.stack([
                        ego_c[:, 1], -ego_c[:, 0], ego_c[:, 2],
                        dims[:, 1], dims[:, 0], dims[:, 2],
                        yaws + zrot,
                    ], axis=1).astype(np.float32)
                    if training_categories:
                        names = np.array([
                            training_categories.get(n, n) for n in names])
                    info["gt_boxes"] = boxes
                    info["gt_names"] = np.asarray(names, dtype=object)
                    info["zrot_world_to_ego"] = zrot
                infos.append(info)
        fp = save / f"pandaset_infos_{split}.pkl"
        with open(fp, "wb") as f:
            pickle.dump(infos, f)
        emit(f"pandaset infos {split}: {len(infos)} -> {fp}")
        out[split] = fp
    return out


# ---------------------------------------------------------------------------
# Argoverse 2 (sensor)
# ---------------------------------------------------------------------------

# cuboid column order in annotations.feather (argo2_utils/constants.py)
ARGO2_LABEL_ATTR = ("tx_m", "ty_m", "tz_m", "length_m", "width_m",
                    "height_m", "qw", "qx", "qy", "qz")


def _quat_to_yaw(qw, qx, qy, qz):
    return np.arctan2(2.0 * (qw * qz + qx * qy),
                      1.0 - 2.0 * (qy * qy + qz * qz))


def create_argo2_infos(data_path, save_path=None, splits=("train", "val"),
                       save_bin=True, logger=None):
    """`data_path` is the av2 `sensor/` root (train/ val/ per-log trees).
    Emits KITTI-style infos + packed (N, 4) float32 velodyne bins, matching
    `Argo2Dataset.__getitem__` (bin_idx =
    <split-prefix><seg:03d><frame:03d>, min-1-interior-point filter,
    capitalized category names)."""
    import pandas as pd

    root = Path(data_path)
    save = Path(save_path or root)
    emit = logger.info if logger else print
    prefix = {"train": "0", "val": "1", "test": "2"}
    split_dirname = {"train": "training", "val": "training",
                     "test": "testing"}

    out = {}
    for split in splits:
        split_root = root / split
        if not split_root.is_dir():
            continue
        infos = []
        for seg_idx, seg_dir in enumerate(sorted(split_root.iterdir())):
            lidar_dir = seg_dir / "sensors" / "lidar"
            if not lidar_dir.is_dir():
                continue
            anno_fp = seg_dir / "annotations.feather"
            seg_anno = pd.read_feather(anno_fp) if anno_fp.exists() else None
            for frame_idx, frame_fp in enumerate(sorted(
                    lidar_dir.glob("*.feather"))):
                ts = int(frame_fp.stem)
                sample_idx = (f"{prefix.get(split, '2')}"
                              f"{seg_idx:03d}{frame_idx:03d}")
                rel = f"{split_dirname.get(split, 'testing')}/velodyne/" \
                      f"{sample_idx}.bin"
                info = {
                    "uuid": f"{seg_dir.name}/{ts}",
                    "sample_idx": sample_idx,
                    "point_cloud": {"num_features": 4,
                                    "velodyne_path": rel},
                    "image": {}, "calib": {}, "pose": {}, "sweeps": [],
                }
                if save_bin:
                    lidar = pd.read_feather(frame_fp)
                    pts = lidar[["x", "y", "z", "intensity"]].to_numpy(
                        np.float32)
                    bin_fp = save / rel
                    bin_fp.parent.mkdir(parents=True, exist_ok=True)
                    pts.tofile(bin_fp)
                if seg_anno is not None:
                    fa = seg_anno[seg_anno["timestamp_ns"] == ts]
                    fa = fa[fa["num_interior_pts"] > 0]
                    cub = fa.loc[:, list(ARGO2_LABEL_ATTR)].to_numpy(
                        np.float64)
                    yaw = _quat_to_yaw(cub[:, 6], cub[:, 7],
                                       cub[:, 8], cub[:, 9])
                    names = np.array([c.lower().capitalize()
                                      for c in fa["category"]])
                    n = len(names)
                    info["annos"] = {
                        "name": names,
                        "truncated": np.zeros(n),
                        "occluded": np.zeros(n, np.int64),
                        "alpha": -10 * np.ones(n),
                        "dimensions": cub[:, 3:6],
                        "location": cub[:, :3],
                        "rotation_y": yaw,
                        "index": np.arange(n, dtype=np.int32),
                        "num_points_in_gt":
                            fa["num_interior_pts"].to_numpy(np.int32),
                        "gt_boxes_lidar": np.concatenate(
                            [cub[:, :3], cub[:, 3:6], yaw[:, None]],
                            axis=1).astype(np.float32),
                    }
                infos.append(info)
        fp = save / f"argo2_infos_{split}.pkl"
        with open(fp, "wb") as f:
            pickle.dump(infos, f)
        emit(f"argo2 infos {split}: {len(infos)} -> {fp}")
        out[split] = fp
    return out


# ---------------------------------------------------------------------------
# ONCE
# ---------------------------------------------------------------------------

def create_once_infos(data_path, save_path=None, splits=("train", "val"),
                      logger=None):
    """Devkit-free ONCE info generation — the raw release is per-sequence
    JSON (`data/<seq>/<seq>.json`: meta_info, per-cam calib, frames with
    pose + optional annos) plus lidar bins. Parity target:
    the reference's `get_infos`:
    split sequence lists from ImageSets/<split>.txt, frame dicts with
    prev/next ids + cam paths + calib arrays, annotated frames with zero
    boxes skipped, num_points_in_gt counted in the lidar frame (in_hull of
    the box corners == box containment; counted here with the exact
    points-in-boxes kernel)."""
    from ..utils.geometry_np import points_in_boxes_mask

    root = Path(data_path)
    emit = logger.info if logger else print
    cam_names = ["cam01", "cam03", "cam05", "cam06", "cam07", "cam08",
                 "cam09"]
    save = Path(save_path or root)
    save.mkdir(parents=True, exist_ok=True)
    out = {}
    for split in splits:
        split_fp = root / "ImageSets" / f"{split}.txt"
        if not split_fp.exists():
            emit(f"once infos: no split list {split_fp}, skipping")
            continue
        seq_ids = [s for s in split_fp.read_text().split() if s]
        infos = []
        for seq_idx in seq_ids:
            seq_path = root / "data" / seq_idx
            with open(seq_path / f"{seq_idx}.json") as f:
                seq_json = json.load(f)
            meta_info = seq_json.get("meta_info")
            calib = seq_json.get("calib", {})
            frames = seq_json["frames"]
            for f_idx, frame in enumerate(frames):
                frame_id = frame["frame_id"]
                info = {
                    "sequence_id": seq_idx,
                    "frame_id": frame_id,
                    "timestamp": int(frame_id),
                    "prev_id": (frames[f_idx - 1]["frame_id"]
                                if f_idx > 0 else None),
                    "next_id": (frames[f_idx + 1]["frame_id"]
                                if f_idx + 1 < len(frames) else None),
                    "meta_info": meta_info,
                    "lidar": str(seq_path / "lidar_roof"
                                 / f"{frame_id}.bin"),
                    "pose": np.asarray(frame["pose"]),
                }
                calib_dict = {}
                for cam in cam_names:
                    if cam not in calib:
                        continue
                    info[cam] = str(seq_path / cam / f"{frame_id}.jpg")
                    calib_dict[cam] = {
                        "cam_to_velo": np.asarray(calib[cam]["cam_to_velo"]),
                        "cam_intrinsic":
                            np.asarray(calib[cam]["cam_intrinsic"]),
                        "distortion": np.asarray(calib[cam]["distortion"]),
                    }
                info["calib"] = calib_dict
                if "annos" in frame:
                    annos = frame["annos"]
                    boxes_3d = np.asarray(annos["boxes_3d"], np.float64)
                    if boxes_3d.shape[0] == 0:
                        # annotated frames with no boxes are skipped
                        continue
                    boxes_2d = {
                        cam: np.asarray(annos["boxes_2d"][cam])
                        for cam in cam_names
                        if cam in annos.get("boxes_2d", {})
                    }
                    lidar_fp = Path(info["lidar"])
                    if lidar_fp.exists():
                        pts = np.fromfile(str(lidar_fp),
                                          np.float32).reshape(-1, 4)
                        npts = points_in_boxes_mask(
                            pts[:, :3].astype(np.float64),
                            boxes_3d[:, :7]).sum(axis=1).astype(np.int32)
                    else:
                        npts = -np.ones(len(boxes_3d), np.int32)
                    info["annos"] = {
                        "name": np.asarray(annos["names"]),
                        "boxes_3d": boxes_3d.astype(np.float32),
                        "boxes_2d": boxes_2d,
                        "num_points_in_gt": npts,
                    }
                infos.append(info)
        fp = save / f"once_infos_{split}.pkl"
        with open(fp, "wb") as f:
            pickle.dump(infos, f)
        emit(f"once infos {split}: {len(infos)} -> {fp}")
        out[split] = fp
    return out
