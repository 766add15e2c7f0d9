"""KITTI calibration and label-file parsing — port of
findnpropagate_tpu/utils/calibration_kitti.py (numpy, host side).

`Calibration` converts between the lidar, rectified camera and image
frames from a calib file's P2 / R0_rect / Tr_velo_to_cam (or a dict of
them); `Object3d` parses one line of the 15-column label format with its
difficulty level; `objects_to_boxes_lidar` turns labels into lidar-frame
[x, y, z, dx, dy, dz, heading] boxes.
"""

from __future__ import annotations

import numpy as np


def get_calib_from_file(calib_file):
    with open(calib_file) as f:
        lines = f.readlines()
    out = {}
    for line in lines:
        if ":" not in line:
            continue
        key, vals = line.split(":", 1)
        out[key.strip()] = np.asarray(vals.split(), dtype=np.float32)
    return {
        "P2": out["P2"].reshape(3, 4),
        "P3": out.get("P3", np.zeros(12, np.float32)).reshape(3, 4),
        "R0": out.get("R0_rect", out.get("R0")).reshape(3, 3),
        "Tr_velo2cam": out.get("Tr_velo_to_cam",
                               out.get("Tr_velo2cam")).reshape(3, 4),
    }


class Calibration:
    def __init__(self, calib_file):
        calib = calib_file if isinstance(calib_file, dict) \
            else get_calib_from_file(calib_file)
        self.P2 = calib["P2"]
        self.R0 = calib["R0"]
        self.V2C = calib["Tr_velo2cam"]
        self.cu = self.P2[0, 2]
        self.cv = self.P2[1, 2]
        self.fu = self.P2[0, 0]
        self.fv = self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def cart_to_hom(pts):
        return np.hstack([pts, np.ones((pts.shape[0], 1), pts.dtype)])

    def rect_to_lidar(self, pts_rect):
        R0_ext = np.eye(4, dtype=np.float32)
        R0_ext[:3, :3] = self.R0
        V2C_ext = np.eye(4, dtype=np.float32)
        V2C_ext[:3, :4] = self.V2C
        pts = self.cart_to_hom(pts_rect) @ np.linalg.inv(
            (R0_ext @ V2C_ext).T)
        return pts[:, :3]

    def lidar_to_rect(self, pts_lidar):
        pts = self.cart_to_hom(pts_lidar)
        return pts @ self.V2C.T @ self.R0.T

    def rect_to_img(self, pts_rect):
        pts_2d = self.cart_to_hom(pts_rect) @ self.P2.T
        depth = pts_2d[:, 2] - self.P2.T[3, 2]
        return pts_2d[:, :2] / pts_rect[:, 2:3], depth

    def lidar_to_img(self, pts_lidar):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.stack([x, y, depth_rect], axis=1)

    def corners3d_to_img_boxes(self, corners3d):
        """(N, 8, 3) rect-frame corners -> (N, 4) xyxy image boxes."""
        n = corners3d.shape[0]
        pts = np.concatenate(
            [corners3d, np.ones((n, 8, 1), np.float32)], axis=2)
        img_pts = pts @ self.P2.T
        xy = img_pts[:, :, :2] / img_pts[:, :, 2:3]
        boxes = np.concatenate([xy.min(axis=1), xy.max(axis=1)], axis=1)
        return boxes, xy


class Object3d:
    """One KITTI label line (object3d_kitti.py semantics)."""

    CLS_LEVELS = {"Car": 1, "Pedestrian": 1, "Cyclist": 1, "Van": 2,
                  "Truck": 2}

    def __init__(self, line):
        p = line.strip().split(" ")
        self.cls_type = p[0]
        self.truncation = float(p[1])
        self.occlusion = float(p[2])
        self.alpha = float(p[3])
        self.box2d = np.asarray(p[4:8], np.float32)
        self.h, self.w, self.l = float(p[8]), float(p[9]), float(p[10])
        self.loc = np.asarray(p[11:14], np.float32)  # rect frame, box bottom
        self.ry = float(p[14])
        self.score = float(p[15]) if len(p) > 15 else -1.0
        self.level = self.get_kitti_obj_level()

    def get_kitti_obj_level(self):
        """Difficulty by 2D height / occlusion / truncation (easy 0,
        moderate 1, hard 2, unknown -1)."""
        height = float(self.box2d[3] - self.box2d[1])
        if height >= 40 and self.truncation <= 0.15 and self.occlusion <= 0:
            return 0
        if height >= 25 and self.truncation <= 0.3 and self.occlusion <= 1:
            return 1
        if height >= 25 and self.truncation <= 0.5 and self.occlusion <= 2:
            return 2
        return -1


def get_objects_from_label(label_file):
    with open(label_file) as f:
        lines = f.readlines()
    return [Object3d(line) for line in lines if line.strip()]


def objects_to_boxes_lidar(objects, calib: Calibration):
    """KITTI labels (rect frame, bottom-center) -> lidar-frame
    [x, y, z, dx, dy, dz, heading] boxes (box_utils.boxes3d_kitti_camera_to_lidar
    semantics) + names + difficulty."""
    objs = [o for o in objects if o.cls_type != "DontCare"]
    if not objs:
        return (np.zeros((0, 7), np.float32), np.zeros(0, dtype=object),
                np.zeros(0, np.int32), np.zeros((0, 4), np.float32))
    loc = np.stack([o.loc for o in objs])
    dims = np.asarray([[o.l, o.h, o.w] for o in objs], np.float32)
    ry = np.asarray([o.ry for o in objs], np.float32)
    loc_lidar = calib.rect_to_lidar(loc)
    l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
    loc_lidar[:, 2] += h[:, 0] / 2  # bottom -> center
    heading = -(np.pi / 2 + ry)
    boxes = np.concatenate(
        [loc_lidar, l, w, h, heading[:, None]], axis=1).astype(np.float32)
    names = np.asarray([o.cls_type for o in objs], dtype=object)
    levels = np.asarray([o.level for o in objs], np.int32)
    boxes2d = np.stack([o.box2d for o in objs]).astype(np.float32)
    return boxes, names, levels, boxes2d
