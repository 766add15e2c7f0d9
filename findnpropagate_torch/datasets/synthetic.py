"""SyntheticDataset — procedurally generated LiDAR scenes; port of
findnpropagate_tpu/datasets/synthetic.py on the port's DatasetTemplate.

Scenes are deterministic per (seed, index), so the same index gives the
same points, boxes and cameras in both packages. Two point patterns:
`uniform` (the default: points uniform inside each box plus ground
clutter) and `lidar_ring` (a 32-beam, 10-sweep spinning-LiDAR aggregate of
nuScenes' LIDAR_TOP geometry). SYNTHETIC.CAMERA attaches a camera rig and
random images. Object classes are drawn from the dataset's class names.
"""

from __future__ import annotations

import numpy as np

from .dataset import DatasetTemplate

SIZE_PRIORS = {
    "Car": ([4.6, 1.95, 1.7], [0.3, 0.1, 0.1]),
    "Pedestrian": ([0.8, 0.7, 1.7], [0.1, 0.1, 0.1]),
    "Cyclist": ([1.8, 0.7, 1.7], [0.15, 0.1, 0.1]),
    "truck": ([7.0, 2.5, 2.8], [0.8, 0.2, 0.3]),
    "bus": ([11.0, 2.9, 3.3], [1.0, 0.2, 0.3]),
}
DEFAULT_PRIOR = ([2.5, 1.5, 1.6], [0.4, 0.3, 0.2])


def lidar_ring_points(rng, boxes, budget):
    """32-beam, 10-sweep spinning-LiDAR aggregate (nuScenes LIDAR_TOP
    geometry): ground rings, walls on a piecewise-constant skyline, object
    surface hits. (budget, 4) float32 xyz + intensity at most."""
    n_sweeps = 10
    n_beams = 32
    elev = np.deg2rad(np.linspace(10.67, -30.67, n_beams))
    n_az = max(200, budget // (n_sweeps * n_beams))
    sensor_h = 1.84
    ground_z = -sensor_h
    max_r = 70.0

    n_sect = 64
    wall_r = np.where(rng.uniform(size=n_sect) < 0.70,
                      rng.uniform(6.0, 40.0, n_sect), np.inf)
    wall_h = rng.uniform(3.0, 14.0, n_sect)

    ego_speed = rng.uniform(0.3, 3.0)
    ego_yaw = rng.uniform(-np.pi, np.pi)
    pts = []
    for sw in range(n_sweeps):
        dt = 0.05 * (n_sweeps - 1 - sw)
        ox = -ego_speed * dt * np.cos(ego_yaw)
        oy = -ego_speed * dt * np.sin(ego_yaw)
        az = (rng.normal(0, 2 * np.pi / n_az / 8)
              + np.linspace(0, 2 * np.pi, n_az, endpoint=False))
        a, e = np.meshgrid(az, elev)
        sect = ((a / (2 * np.pi) * n_sect).astype(int)) % n_sect
        wr = wall_r[sect]
        wh = wall_h[sect]
        with np.errstate(divide="ignore"):
            rg = np.where(e < -1e-3, sensor_h / np.tan(-e), np.inf)
        zw = wr * np.tan(e)
        hits_wall = (wr < rg) & (zw > ground_z) & (zw < ground_z + wh)
        r = np.where(hits_wall, wr, rg)
        r = r * (1.0 + rng.normal(0, 0.0006, r.shape))
        keep = (r > 1.0) & (r < max_r)
        rr, aa, ee = r[keep], a[keep], e[keep]
        x = rr * np.cos(ee) * np.cos(aa) + ox
        y = rr * np.cos(ee) * np.sin(aa) + oy
        z = rr * np.sin(ee)
        pts.append(np.stack([x, y, z], axis=-1))
    pts = np.concatenate(pts, axis=0)

    obj = []
    for i in range(boxes.shape[0]):
        r_obj = max(np.hypot(boxes[i, 0], boxes[i, 1]), 5.0)
        area = boxes[i, 3] * boxes[i, 5] + boxes[i, 4] * boxes[i, 5]
        cnt = int(np.clip(9000.0 * area / r_obj ** 2, 8, 2000))
        local = rng.uniform(-0.5, 0.5, (cnt, 3)) * boxes[i, 3:6]
        face = rng.randint(0, 3, cnt // 2)
        sgn = rng.choice([-0.5, 0.5], cnt // 2)
        local[: cnt // 2, 0] = np.where(face == 0, sgn * boxes[i, 3],
                                        local[: cnt // 2, 0])
        local[: cnt // 2, 1] = np.where(face == 1, sgn * boxes[i, 4],
                                        local[: cnt // 2, 1])
        local[: cnt // 2, 2] = np.where(face == 2, sgn * boxes[i, 5],
                                        local[: cnt // 2, 2])
        c, s = np.cos(boxes[i, 6]), np.sin(boxes[i, 6])
        x = local[:, 0] * c - local[:, 1] * s + boxes[i, 0]
        y = local[:, 0] * s + local[:, 1] * c + boxes[i, 1]
        z = local[:, 2] + boxes[i, 2]
        obj.append(np.stack([x, y, z], axis=-1))
    if obj:
        pts = np.concatenate([pts] + obj, axis=0)
    if pts.shape[0] > budget:
        pts = pts[rng.permutation(pts.shape[0])[:budget]]
    inten = rng.uniform(0, 1, (pts.shape[0], 1))
    return np.concatenate([pts, inten], axis=-1).astype(np.float32)


def bench_data_cfg(num_scenes, cfg, pcr=None, voxel=None, max_voxels=None,
                   max_points=None):
    """bench.py's synthetic nuScenes data config for a model config `cfg`
    (lidar_ring, 200k raw points, x/y/z/intensity, 40 objects), optionally
    cropped (`pcr`, `voxel`, capacities) for a narrow reference run."""
    caps = dict(cfg.DATA_CONFIG.CAPACITIES)
    if max_voxels:
        caps["MAX_VOXELS"] = max_voxels
    if max_points:
        caps["MAX_POINTS"] = max_points
    return {
        "POINT_CLOUD_RANGE": pcr or list(cfg.DATA_CONFIG.POINT_CLOUD_RANGE),
        "SYNTHETIC": {"NUM_SCENES": num_scenes, "NUM_OBJECTS": 40,
                      "NUM_RAW_POINTS": 200000, "PATTERN": "lidar_ring"},
        "CAPACITIES": caps,
        "POINT_FEATURE_ENCODING": {
            "encoding_type": "absolute_coordinates_encoding",
            "used_feature_list": ["x", "y", "z", "intensity"],
            "src_feature_list": ["x", "y", "z", "intensity"]},
        "DATA_PROCESSOR": [
            {"NAME": "mask_points_and_boxes_outside_range",
             "REMOVE_OUTSIDE_BOXES": True},
            {"NAME": "transform_points_to_voxels",
             "VOXEL_SIZE": voxel or [0.075, 0.075, 0.2]}],
    }


class SyntheticDataset(DatasetTemplate):
    """dataset_cfg keys: the DatasetTemplate's (POINT_CLOUD_RANGE,
    POINT_FEATURE_ENCODING, DATA_AUGMENTOR, DATA_PROCESSOR, CAPACITIES) and
    SYNTHETIC {NUM_SCENES, NUM_OBJECTS, NUM_RAW_POINTS, SEED, PATTERN
    ('uniform' or 'lidar_ring'), CAMERA {NUM, IMAGE_SIZE}}. Training
    scenes draw their seeds from SEED, test scenes from SEED + 10000."""

    def __init__(self, dataset_cfg, class_names, training=True, logger=None,
                 root_path=None, rng=None, hooks=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, logger=logger, root_path=root_path, rng=rng,
            hooks=hooks,
        )
        syn = dataset_cfg.get("SYNTHETIC", {})
        self.num_scenes = int(syn.get("NUM_SCENES", 64))
        self.num_objects = int(syn.get("NUM_OBJECTS", 24))
        self.num_raw_points = int(syn.get("NUM_RAW_POINTS", 20000))
        self.base_seed = int(syn.get("SEED", 0)) + (0 if training else 10_000)
        self.camera_cfg = syn.get("CAMERA")
        self.pattern = str(syn.get("PATTERN", "uniform"))
        if self.pattern not in ("uniform", "lidar_ring"):
            raise ValueError(f"synthetic PATTERN {self.pattern!r}")

    def __len__(self):
        return self.num_scenes

    def generate_scene(self, index):
        rng = np.random.RandomState(self.base_seed + index)
        pcr = self.point_cloud_range
        n = self.num_objects

        names = [self.class_names[rng.randint(len(self.class_names))] for _ in range(n)]
        boxes = np.zeros((n, 7), np.float32)
        margin = 4.0
        ground_lvl = -1.84 if self.pattern == "lidar_ring" else -1.5
        boxes[:, 0] = rng.uniform(pcr[0] + margin, pcr[3] - margin, n)
        boxes[:, 1] = rng.uniform(pcr[1] + margin, pcr[4] - margin, n)
        for i, nm in enumerate(names):
            mean, std = SIZE_PRIORS.get(nm, DEFAULT_PRIOR)
            boxes[i, 3:6] = np.abs(rng.normal(mean, std))
        boxes[:, 2] = boxes[:, 5] / 2 + ground_lvl
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)

        if self.pattern == "lidar_ring":
            points = lidar_ring_points(rng, boxes, self.num_raw_points)
            out = {
                "points": points,
                "gt_boxes": boxes,
                "gt_names": np.asarray(names),
                "frame_id": index,
            }
            return self._attach_cameras(out, rng)

        # object points: uniform inside each box, count scaled by footprint
        obj_pts = []
        for i in range(n):
            cnt = max(20, int(40 * boxes[i, 3] * boxes[i, 4]))
            local = rng.uniform(-0.5, 0.5, (cnt, 3)) * boxes[i, 3:6]
            c, s = np.cos(boxes[i, 6]), np.sin(boxes[i, 6])
            x = local[:, 0] * c - local[:, 1] * s + boxes[i, 0]
            y = local[:, 0] * s + local[:, 1] * c + boxes[i, 1]
            z = local[:, 2] + boxes[i, 2]
            inten = rng.uniform(0, 1, (cnt, 1))
            obj_pts.append(
                np.concatenate([np.stack([x, y, z], -1), inten], -1)
            )
        # ground clutter
        m = self.num_raw_points - sum(len(p) for p in obj_pts)
        m = max(m, 1000)
        ground = np.zeros((m, 4), np.float32)
        ground[:, 0] = rng.uniform(pcr[0], pcr[3], m)
        ground[:, 1] = rng.uniform(pcr[1], pcr[4], m)
        ground[:, 2] = rng.normal(-1.5, 0.05, m)
        ground[:, 3] = rng.uniform(0, 1, m)
        points = np.concatenate(obj_pts + [ground], axis=0).astype(np.float32)

        out = {
            "points": points,
            "gt_boxes": boxes,
            "gt_names": np.asarray(names),
            "frame_id": index,
        }
        return self._attach_cameras(out, rng)

    def _attach_cameras(self, out, rng):
        if self.camera_cfg:
            ncam = int(self.camera_cfg.get("NUM", 2))
            h, w = (int(v) for v in self.camera_cfg.get("IMAGE_SIZE",
                                                        (64, 64)))
            fx = w  # ~90 deg FOV
            K = np.array([[fx, 0, w / 2], [0, fx, h / 2], [0, 0, 1.0]])
            l2i, c2l, intr = [], [], []
            for ci in range(ncam):
                yaw = 2 * np.pi * ci / ncam
                R_c2l = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
                rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                                [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
                c2l_i = np.eye(4, dtype=np.float32)
                c2l_i[:3, :3] = rot @ R_c2l
                l2c = np.linalg.inv(c2l_i)
                l2i_i = np.eye(4, dtype=np.float32)
                l2i_i[:3, :3] = K @ l2c[:3, :3]
                l2i_i[:3, 3] = K @ l2c[:3, 3]
                intr_i = np.eye(4, dtype=np.float32)
                intr_i[:3, :3] = K
                l2i.append(l2i_i)
                c2l.append(c2l_i)
                intr.append(intr_i)
            out["lidar2image"] = np.stack(l2i)
            out["camera2lidar"] = np.stack(c2l)
            out["camera_intrinsics"] = np.stack(intr)
            out["camera_imgs"] = rng.uniform(
                0, 1, (ncam, h, w, 3)).astype(np.float32)
            # CaDDN-style single-camera transforms (camera 0)
            out["trans_lidar_to_cam"] = np.linalg.inv(
                c2l[0]).astype(np.float32)
            out["trans_cam_to_img"] = intr[0][:3, :4].astype(np.float32)
        return out

    def __getitem__(self, index):
        data_dict = self.generate_scene(index)
        return self.prepare_data(data_dict)

    def batch(self, indices):
        """The collated samples `indices` without the host-only keys
        (frame_id, batch_size): every value a numpy array."""
        batch = self.collate_batch([self[int(i)] for i in indices])
        batch.pop("frame_id")
        batch.pop("batch_size")
        return batch

    def evaluation(self, det_annos, class_names, **kwargs):
        """Center-distance mAP of eval_utils against the scenes' ground
        truth: (result_str, result_dict)."""
        from .eval_utils import simple_map_eval

        gts = [self.generate_scene(i) for i in range(len(self))]
        return simple_map_eval(det_annos, gts, class_names)
