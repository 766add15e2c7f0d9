"""SyntheticDataset — the `lidar_ring` procedural LiDAR scenes, numpy only.

The port's own copy of findnpropagate_tpu/datasets/synthetic.py:26-200
(`_lidar_ring_points`, scene and box generation) and of the fixed-capacity
collation of findnpropagate_tpu/datasets/dataset.py. Scenes are
deterministic per (seed, index), so the same index gives the same points in
both packages. Only the `lidar_ring` pattern and the data pipeline of the
TransFusion configs are carried over: point-range mask
(geometry_np.mask_points_by_range), the configured point features, padding
to MAX_POINTS with a mask, and the ground truth as (MAX_GT, 8) rows of
7 box values + the 1-indexed class, boxes whose centre is out of range
removed in training (REMOVE_OUTSIDE_BOXES), zero rows as padding. No
augmentation and no point shuffling are ported.
"""

from __future__ import annotations

import numpy as np

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


class SyntheticDataset:
    """Geometry + scenes + collation.

    dataset_cfg keys: POINT_CLOUD_RANGE, SYNTHETIC {NUM_OBJECTS,
    NUM_RAW_POINTS, PATTERN='lidar_ring', SEED}, CAPACITIES, DATA_PROCESSOR
    (its transform_points_to_voxels entry gives VOXEL_SIZE),
    POINT_FEATURE_ENCODING."""

    def __init__(self, dataset_cfg, class_names, training=False):
        self.dataset_cfg = dataset_cfg
        self.class_names = list(class_names)
        self.training = training
        self.point_cloud_range = np.array(dataset_cfg["POINT_CLOUD_RANGE"],
                                          dtype=np.float32)
        syn = dataset_cfg.get("SYNTHETIC", {})
        self.num_scenes = int(syn.get("NUM_SCENES", 64))
        self.num_objects = int(syn.get("NUM_OBJECTS", 24))
        self.num_raw_points = int(syn.get("NUM_RAW_POINTS", 20000))
        self.base_seed = int(syn.get("SEED", 0)) + (0 if training else 10_000)
        pattern = str(syn.get("PATTERN", "lidar_ring"))
        if pattern != "lidar_ring":
            raise NotImplementedError(
                f"synthetic PATTERN {pattern!r}: only lidar_ring is ported")
        enc = dataset_cfg["POINT_FEATURE_ENCODING"]
        assert list(enc["src_feature_list"][0:3]) == ["x", "y", "z"]
        self.used_feature_list = list(enc["used_feature_list"])
        self.src_feature_list = list(enc["src_feature_list"])

        self.voxel_size = None
        for proc in dataset_cfg["DATA_PROCESSOR"]:
            if proc["NAME"] == "transform_points_to_voxels":
                self.voxel_size = np.asarray(proc["VOXEL_SIZE"], np.float32)
        grid = (self.point_cloud_range[3:6] - self.point_cloud_range[0:3]
                ) / self.voxel_size
        self.grid_size = np.round(grid).astype(np.int64)

        caps = dataset_cfg.get("CAPACITIES", {})
        self.max_points = int(caps.get("MAX_POINTS", 60000))
        self.max_gt = int(caps.get("MAX_GT", 128))
        self.remove_outside_boxes = training and any(
            proc["NAME"] == "mask_points_and_boxes_outside_range"
            and proc.get("REMOVE_OUTSIDE_BOXES", False)
            for proc in dataset_cfg["DATA_PROCESSOR"])
        self.max_voxels = int(caps.get("MAX_VOXELS", 40000))
        self.max_points_per_voxel = int(caps.get("MAX_POINTS_PER_VOXEL", 32))

    @property
    def num_point_features(self):
        return len(self.used_feature_list)

    def __len__(self):
        return self.num_scenes

    def generate_scene(self, index):
        rng = np.random.RandomState(self.base_seed + index)
        pcr = self.point_cloud_range
        n = self.num_objects
        names = [self.class_names[rng.randint(len(self.class_names))]
                 for _ in range(n)]
        boxes = np.zeros((n, 7), np.float32)
        margin = 4.0
        ground_lvl = -1.84
        boxes[:, 0] = rng.uniform(pcr[0] + margin, pcr[3] - margin, n)
        boxes[:, 1] = rng.uniform(pcr[1] + margin, pcr[4] - margin, n)
        for i, nm in enumerate(names):
            mean, std = SIZE_PRIORS.get(nm, DEFAULT_PRIOR)
            boxes[i, 3:6] = np.abs(rng.normal(mean, std))
        boxes[:, 2] = boxes[:, 5] / 2 + ground_lvl
        boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
        points = lidar_ring_points(rng, boxes, self.num_raw_points)
        return {"points": points, "gt_boxes": boxes,
                "gt_names": np.asarray(names), "frame_id": index}

    def __getitem__(self, index):
        d = self.generate_scene(index)
        pts = d["points"]
        cols = [pts[:, 0:3]] + [
            pts[:, self.src_feature_list.index(f):
                self.src_feature_list.index(f) + 1]
            for f in self.used_feature_list if f not in ("x", "y", "z")]
        pts = np.concatenate(cols, axis=1)
        r = self.point_cloud_range
        keep = ((pts[:, 0] >= r[0]) & (pts[:, 0] <= r[3])
                & (pts[:, 1] >= r[1]) & (pts[:, 1] <= r[4]))
        d["points"] = pts[keep]
        known = np.array([n in self.class_names for n in d["gt_names"]],
                         dtype=bool)
        names = d["gt_names"][known]
        classes = np.array([self.class_names.index(n) + 1 for n in names],
                           dtype=np.float32)
        boxes = np.concatenate([d["gt_boxes"][known][:, :7],
                                classes.reshape(-1, 1)], axis=1)
        if self.remove_outside_boxes:
            c = boxes[:, 0:3]
            inside = ((c >= r[0:3]).all(axis=-1) & (c <= r[3:6]).all(axis=-1))
            boxes, names = boxes[inside], names[inside]
        d["gt_boxes"], d["gt_names"] = boxes, names
        return d

    def collate_batch(self, samples):
        """Pad to (B, MAX_POINTS, F) float32 + (B, MAX_POINTS) bool mask
        and (B, MAX_GT, 8) float32 ground truth."""
        b = len(samples)
        f = samples[0]["points"].shape[-1]
        points = np.zeros((b, self.max_points, f), np.float32)
        mask = np.zeros((b, self.max_points), bool)
        gt_boxes = np.zeros((b, self.max_gt, 8), np.float32)
        for i, s in enumerate(samples):
            p = s["points"][: self.max_points]
            points[i, : len(p)] = p
            mask[i, : len(p)] = True
            g = s["gt_boxes"][: self.max_gt]
            gt_boxes[i, : len(g)] = g
        return {"points": points, "points_mask": mask, "gt_boxes": gt_boxes}

    def batch(self, indices):
        return self.collate_batch([self[int(i)] for i in indices])


class DataLoader:
    """Deterministic epoch-based loader over fixed-shape collated batches,
    the reference's datasets.DataLoader without sharding: the order of
    epoch e is ``RandomState(seed + e).permutation`` when shuffling, and
    the last short batch is dropped when `drop_last`."""

    def __init__(self, dataset, batch_size, shuffle=True, seed=0,
                 drop_last=True):
        self.dataset, self.batch_size = dataset, int(batch_size)
        self.shuffle, self.seed, self.drop_last = shuffle, seed, drop_last
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch
                                          ).permutation(len(self.dataset))
        for b in range(len(self)):
            idxs = order[b * self.batch_size:(b + 1) * self.batch_size]
            yield self.dataset.batch(idxs)
