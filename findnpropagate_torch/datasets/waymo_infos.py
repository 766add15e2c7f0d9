"""Waymo info generation without the devkit — port of
findnpropagate_tpu/datasets/waymo_infos.py (numpy): raw `.tfrecord`
sequences -> the per-sequence `<seq>/<seq>.pkl` + `%04d.npy` layout that
`WaymoDataset` reads, and the gt database.

Frames are decoded by `waymo_proto` (TFRecord framing and protobuf wire
parsing); range images become points by the devkit's published math
(`range_image_utils.py`) in numpy: per-row beam inclinations (reversed: row
0 = top beam), per-column azimuth `(W - 0.5 - col)/W * 2pi - pi -
atan2(extr[1,0], extr[0,0])`, spherical -> sensor cartesian -> vehicle
frame through the extrinsic, and for the TOP lidar a per-pixel
vehicle->global pose (rot = Rz(yaw) @ Ry(pitch) @ Rx(roll) from the pose
channels [roll, pitch, yaw, x, y, z]) followed by inverse(frame_pose) back
into the frame's vehicle frame.
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from . import waymo_proto as wp

WAYMO_CLASSES = ("unknown", "Vehicle", "Pedestrian", "Sign", "Cyclist")


# ---------------------------------------------------------------------------
# Range image geometry (range_image_utils' math in numpy)
# ---------------------------------------------------------------------------


def compute_inclination(incl_min: float, incl_max: float, height: int):
    """Beam inclination per row when the calibration has only min/max:
    uniform bin centers, ordered low -> high (caller reverses)."""
    return incl_min + (incl_max - incl_min) * (
        0.5 + np.arange(height, dtype=np.float64)) / height


def _rotation_zyx(roll, pitch, yaw):
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll), broadcast over leading dims."""
    cr, sr = np.cos(roll), np.sin(roll)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    r = np.empty(np.broadcast(roll, pitch, yaw).shape + (3, 3))
    r[..., 0, 0] = cy * cp
    r[..., 0, 1] = cy * sp * sr - sy * cr
    r[..., 0, 2] = cy * sp * cr + sy * sr
    r[..., 1, 0] = sy * cp
    r[..., 1, 1] = sy * sp * sr + cy * cr
    r[..., 1, 2] = sy * sp * cr - cy * sr
    r[..., 2, 0] = -sp
    r[..., 2, 1] = cp * sr
    r[..., 2, 2] = cp * cr
    return r


def range_image_to_cartesian(ri_range, extrinsic, inclinations,
                             pixel_pose=None, frame_pose=None):
    """(H, W) ranges -> (H, W, 3) points in the frame's vehicle frame.

    inclinations: (H,) ordered to MATCH rows (row 0 = top beam).
    pixel_pose: optional (H, W, 6) [roll, pitch, yaw, x, y, z]
    vehicle->global per pixel (TOP lidar); frame_pose: (4, 4)
    vehicle->global of the frame, used to bring points back.
    """
    h, w = ri_range.shape
    az_correction = np.arctan2(extrinsic[1, 0], extrinsic[0, 0])
    ratios = (np.arange(w, 0, -1, dtype=np.float64) - 0.5) / w
    azimuth = (ratios * 2.0 - 1.0) * np.pi - az_correction      # (W,)

    cos_i = np.cos(inclinations)[:, None]
    sin_i = np.sin(inclinations)[:, None]
    cos_a = np.cos(azimuth)[None, :]
    sin_a = np.sin(azimuth)[None, :]
    r = ri_range.astype(np.float64)
    pts = np.stack([cos_a * cos_i * r, sin_a * cos_i * r,
                    np.broadcast_to(sin_i, (h, w)) * r], axis=-1)

    # sensor -> vehicle
    pts = pts @ extrinsic[:3, :3].T + extrinsic[:3, 3]

    if pixel_pose is not None:
        rot = _rotation_zyx(pixel_pose[..., 0], pixel_pose[..., 1],
                            pixel_pose[..., 2])                  # (H, W, 3, 3)
        trans = pixel_pose[..., 3:6]
        pts = np.einsum("hwij,hwj->hwi", rot, pts) + trans       # -> global
        inv = np.linalg.inv(frame_pose)
        pts = pts @ inv[:3, :3].T + inv[:3, 3]                   # -> vehicle
    return pts.astype(np.float32)


def convert_frame_to_points(frame: wp.Frame, ri_index=(0, 1)):
    """All lidars (sorted by laser name) -> per-lidar
    float32 (N, 6) [x y z intensity elongation nlz] stacks.

    Range image channels: 0=range, 1=intensity, 2=elongation, 3=NLZ flag
    (-1 = outside any no-label zone)."""
    calibs = {c.name: c for c in frame.laser_calibrations}
    lasers = {l.name: l for l in frame.lasers}
    per_lidar = []
    for name in sorted(lasers):
        laser, calib = lasers[name], calibs[name]
        chunks = []
        for idx in ri_index:
            ri_msg = (laser.ri_return1, laser.ri_return2)[idx]
            if ri_msg is None or ri_msg.range_image is None:
                continue
            ri = ri_msg.range_image
            h = ri.shape[0]
            if calib.beam_inclinations.size:
                incl = calib.beam_inclinations
            else:
                incl = compute_inclination(calib.beam_inclination_min,
                                           calib.beam_inclination_max, h)
            incl = incl[::-1]                      # row 0 = top beam
            pixel_pose = frame_pose = None
            if name == wp.LASER_TOP and laser.ri_return1 is not None \
                    and laser.ri_return1.pose is not None:
                pixel_pose = laser.ri_return1.pose
                frame_pose = frame.pose
            xyz = range_image_to_cartesian(
                ri[..., 0], calib.extrinsic, incl, pixel_pose, frame_pose)
            mask = ri[..., 0] > 0
            chunks.append(np.concatenate(
                [xyz[mask], ri[mask][:, 1:2], ri[mask][:, 2:3],
                 ri[mask][:, 3:4]], axis=1).astype(np.float32))
        per_lidar.append(
            np.concatenate(chunks, axis=0) if chunks
            else np.zeros((0, 6), np.float32))
    return per_lidar


# ---------------------------------------------------------------------------
# Labels + per-sequence processing
# ---------------------------------------------------------------------------


def generate_labels(frame: wp.Frame, pose: np.ndarray) -> dict:
    labels = frame.laser_labels
    keep = [l for l in labels if l.type != 0]      # drop 'unknown'
    n = len(keep)
    annos = {
        "name": np.array([WAYMO_CLASSES[l.type] for l in keep]),
        "difficulty": np.array(
            [l.detection_difficulty_level for l in keep], np.int64),
        "dimensions": np.array(
            [[l.length, l.width, l.height] for l in keep]).reshape(n, 3),
        "location": np.array([l.center for l in keep]).reshape(n, 3),
        "heading_angles": np.array([l.heading for l in keep]),
        "obj_ids": np.array([l.id for l in keep]),
        "tracking_difficulty": np.array(
            [l.tracking_difficulty_level for l in keep], np.int64),
        "num_points_in_gt": np.array(
            [l.num_lidar_points_in_box for l in keep], np.int64),
        "speed_global": np.array([l.speed for l in keep]).reshape(n, 2),
        "accel_global": np.array([l.accel for l in keep]).reshape(n, 2),
    }
    if n:
        # global speed vector into the frame's vehicle frame: v @ R (==
        # v @ inv(R.T) for orthonormal R)
        v3 = np.pad(annos["speed_global"], ((0, 0), (0, 1)))
        speed = (v3 @ pose[:3, :3])[:, :2]
        annos["gt_boxes_lidar"] = np.concatenate(
            [annos["location"], annos["dimensions"],
             annos["heading_angles"][:, None], speed], axis=1)
    else:
        annos["gt_boxes_lidar"] = np.zeros((0, 9))
    return annos


def process_single_sequence(sequence_file, save_path, sampled_interval=1,
                            has_label=True, use_two_returns=True,
                            logger=None):
    sequence_file = Path(sequence_file)
    sequence_name = sequence_file.stem
    if not sequence_file.exists():
        (logger.info if logger else print)(f"missing: {sequence_file}")
        return []
    out_dir = Path(save_path) / sequence_name
    out_dir.mkdir(parents=True, exist_ok=True)
    pkl_file = out_dir / f"{sequence_name}.pkl"
    if pkl_file.exists():
        with open(pkl_file, "rb") as f:
            return pickle.load(f)

    ri_index = (0, 1) if use_two_returns else (0,)
    infos = []
    for cnt, payload in enumerate(wp.read_tfrecord(sequence_file)):
        if cnt % sampled_interval != 0:
            continue
        frame = wp.Frame.parse(payload)
        pose = frame.pose.astype(np.float32)
        info = {
            "point_cloud": {"num_features": 5,
                            "lidar_sequence": sequence_name,
                            "sample_idx": cnt},
            "frame_id": sequence_name + "_%03d" % cnt,
            "metadata": {"context_name": frame.context_name,
                         "timestamp_micros": frame.timestamp_micros},
            "pose": pose,
        }
        if has_label:
            info["annos"] = generate_labels(frame, pose)

        per_lidar = convert_frame_to_points(frame, ri_index)
        info["num_points_of_each_lidar"] = [p.shape[0] for p in per_lidar]
        allp = (np.concatenate(per_lidar, axis=0) if per_lidar
                else np.zeros((0, 6), np.float32))
        # loader layout (waymo.py get_lidar): [x y z intensity elongation
        # | NLZ], NLZ filtered at load time, tanh(intensity) applied there
        np.save(out_dir / ("%04d.npy" % cnt), allp)
        infos.append(info)

    with open(pkl_file, "wb") as f:
        pickle.dump(infos, f)
    if logger:
        logger.info(f"waymo seq {sequence_name}: {len(infos)} frames")
    return infos


def create_waymo_infos(data_path, save_path=None,
                       processed_data_tag="waymo_processed_data",
                       splits=("train", "val"), sampled_interval=1,
                       use_two_returns=True, logger=None):
    """data_path/raw_data/<seq>.tfrecord (+ ImageSets/<split>.txt listing
    sequence file names) -> data_path/<tag>/<seq>/{<seq>.pkl, %04d.npy}."""
    root = Path(data_path)
    save = Path(save_path or data_path) / processed_data_tag
    emit = logger.info if logger else print
    all_infos = {}
    for split in splits:
        split_file = root / "ImageSets" / f"{split}.txt"
        if split_file.exists():
            seqs = [s.strip() for s in split_file.read_text().splitlines()
                    if s.strip()]
        else:
            seqs = sorted(p.name for p in (root / "raw_data").glob(
                "*.tfrecord"))
        infos = []
        for seq in seqs:
            infos.extend(process_single_sequence(
                root / "raw_data" / seq, save, sampled_interval,
                use_two_returns=use_two_returns, logger=logger))
        emit(f"waymo infos {split}: {len(infos)} frames "
             f"({len(seqs)} sequences) -> {save}")
        all_infos[split] = infos
    return all_infos


def create_waymo_gt_database(data_path, save_path=None,
                             processed_data_tag="waymo_processed_data",
                             split="train", used_classes=None, logger=None):
    """Object crops for gt_sampling: points inside each gt box,
    box-centered, saved per object with a `waymo_dbinfos_<split>.pkl` index
    in the database_sampler schema. The crops keep the `.npy` files' raw
    intensity (the loader applies tanh to its own points only)."""
    from ..utils.geometry_np import points_in_boxes_mask

    root = Path(data_path)
    proc = Path(save_path or data_path) / processed_data_tag
    db_dir = Path(save_path or data_path) / f"gt_database_{split}"
    db_dir.mkdir(parents=True, exist_ok=True)

    split_file = root / "ImageSets" / f"{split}.txt"
    seqs = ([s.strip() for s in split_file.read_text().splitlines()
             if s.strip()] if split_file.exists()
            else sorted(p.name for p in proc.iterdir() if p.is_dir()))
    db_infos = {}
    for seq in seqs:
        seq = Path(seq).stem
        pkl = proc / seq / f"{seq}.pkl"
        if not pkl.exists():
            continue
        with open(pkl, "rb") as f:
            infos = pickle.load(f)
        for info in infos:
            annos = info.get("annos")
            if annos is None or len(annos["name"]) == 0:
                continue
            idx = info["point_cloud"]["sample_idx"]
            pts = np.load(proc / seq / ("%04d.npy" % idx))[:, :5]
            boxes = np.asarray(annos["gt_boxes_lidar"], np.float32)
            inside = points_in_boxes_mask(pts[:, :3], boxes[:, :7])
            for i, name in enumerate(annos["name"]):
                if used_classes and name not in used_classes:
                    continue
                obj = pts[inside[i]].copy()
                obj[:, :3] -= boxes[i, :3]
                fname = f"{seq}_{idx:04d}_{name}_{i}.bin"
                obj.astype(np.float32).tofile(str(db_dir / fname))
                db_infos.setdefault(name, []).append({
                    "name": name,
                    "path": f"gt_database_{split}/{fname}",
                    "image_idx": f"{seq}_{idx:04d}", "gt_idx": i,
                    "box3d_lidar": boxes[i, :7],
                    "num_points_in_gt": int(inside[i].sum()),
                    "difficulty": int(annos["difficulty"][i]),
                })
    fp = Path(save_path or data_path) / f"waymo_dbinfos_{split}.pkl"
    with open(fp, "wb") as f:
        pickle.dump(db_infos, f)
    (logger.info if logger else print)(
        "waymo gt database: " + ", ".join(
            f"{k}: {len(v)}" for k, v in db_infos.items()))
    return fp
