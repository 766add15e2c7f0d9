"""The benchmark's scenes: LiDAR sweeps, boxes and camera rigs.

A copy of the port's synthetic nuScenes recipe (findnpropagate_torch/
datasets/synthetic.py: `lidar_ring_points`, the boxes of
`SyntheticDataset.generate_scene`, the camera rig of `_attach_cameras`),
kept here so that a change to the program cannot change the traffic: a
32-beam, 10-sweep spinning-LiDAR aggregate of nuScenes' LIDAR_TOP geometry
(ground rings, walls on a piecewise-constant skyline, object surface hits),
x / y / z / intensity / timestamp (the nuScenes dataset yaml's
used_feature_list; the timestamp is the sweep's time lag behind the key
frame, 0 to 0.45 s), with the points outside the point-cloud range removed
as the loader's `mask_points_and_boxes_outside_range` does.
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
SENSOR_H = 1.84


def lidar_ring_points(rng, boxes, budget):
    """(budget, 5) float32 xyz + intensity + time lag at most."""
    n_sweeps = 10
    n_beams = 32
    elev = np.deg2rad(np.linspace(10.67, -30.67, n_beams))
    n_az = max(200, budget // (n_sweeps * n_beams))
    ground_z = -SENSOR_H
    max_r = 70.0

    n_sect = 64
    wall_r = np.where(rng.uniform(size=n_sect) < 0.70,
                      rng.uniform(6.0, 40.0, n_sect), np.inf)
    wall_h = rng.uniform(3.0, 14.0, n_sect)

    ego_speed = rng.uniform(0.3, 3.0)
    ego_yaw = rng.uniform(-np.pi, np.pi)
    pts, lags = [], []
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
            rg = np.where(e < -1e-3, SENSOR_H / np.tan(-e), np.inf)
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
        lags.append(np.full(x.shape, dt))
    pts = np.concatenate(pts, axis=0)
    lags = np.concatenate(lags)

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
        # an object's hits come from every sweep of the aggregate
        lags = np.concatenate(
            [lags, 0.05 * rng.randint(0, n_sweeps, cnt)])
    if obj:
        pts = np.concatenate([pts] + obj, axis=0)
    if pts.shape[0] > budget:
        keep = rng.permutation(pts.shape[0])[:budget]
        pts, lags = pts[keep], lags[keep]
    inten = rng.uniform(0, 1, (pts.shape[0], 1))
    return np.concatenate([pts, inten, lags[:, None]],
                          axis=-1).astype(np.float32)


def scene(seed, class_names, pcr, n_objects, n_points):
    """One scene: (points (P, 5) float32 inside the range, boxes (M, 7))."""
    rng = np.random.RandomState(seed)
    names = [class_names[rng.randint(len(class_names))]
             for _ in range(n_objects)]
    boxes = np.zeros((n_objects, 7), np.float32)
    margin = 4.0
    boxes[:, 0] = rng.uniform(pcr[0] + margin, pcr[3] - margin, n_objects)
    boxes[:, 1] = rng.uniform(pcr[1] + margin, pcr[4] - margin, n_objects)
    for i, nm in enumerate(names):
        mean, std = SIZE_PRIORS.get(nm, DEFAULT_PRIOR)
        boxes[i, 3:6] = np.abs(rng.normal(mean, std))
    boxes[:, 2] = boxes[:, 5] / 2 - SENSOR_H
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n_objects)
    points = lidar_ring_points(rng, boxes, n_points)
    lo, hi = np.asarray(pcr[:3]), np.asarray(pcr[3:])
    inside = ((points[:, :3] >= lo) & (points[:, :3] <= hi)).all(1)
    return points[inside], boxes


def camera_rig(n_cams, image_size):
    """(lidar2image, camera2lidar, intrinsics), each (N, 4, 4) float32: a
    ring of cameras at yaw 2 pi i / N, fx = fy = width (about 90 degrees
    of view), principal point at the image centre."""
    h, w = (int(v) for v in image_size)
    k = np.array([[w, 0, w / 2], [0, w, h / 2], [0, 0, 1.0]])
    l2i, c2l, intr = [], [], []
    for ci in range(n_cams):
        yaw = 2 * np.pi * ci / n_cams
        r_c2l = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
        rot = np.array([[np.cos(yaw), -np.sin(yaw), 0],
                        [np.sin(yaw), np.cos(yaw), 0], [0, 0, 1.0]])
        c2l_i = np.eye(4, dtype=np.float32)
        c2l_i[:3, :3] = rot @ r_c2l
        l2c = np.linalg.inv(c2l_i)
        l2i_i = np.eye(4, dtype=np.float32)
        l2i_i[:3, :3] = k @ l2c[:3, :3]
        l2i_i[:3, 3] = k @ l2c[:3, 3]
        intr_i = np.eye(4, dtype=np.float32)
        intr_i[:3, :3] = k
        l2i.append(l2i_i)
        c2l.append(c2l_i)
        intr.append(intr_i)
    return tuple(np.stack(m).astype(np.float32) for m in (l2i, c2l, intr))
