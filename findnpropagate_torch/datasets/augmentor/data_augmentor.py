"""DataAugmentor — cfg-named queue of world-level augmentations; port of
findnpropagate_tpu/datasets/augmentor/data_augmentor.py.

Each world aug also records its parameter (flip_x / flip_y / noise_rot /
noise_scale / noise_translate) in the data_dict so that the self-training
stage can invert it (openvocab/pseudo_labels.py::reverse_augmentation), and
transforms `pseudo_boxes` alongside the ground truth when present.

Every random draw comes from `rng`, the dataset's np.random.RandomState, in
the reference's order: the reference draws the same values from numpy's
global state, so ``np.random.seed(s)`` there and ``RandomState(s)`` here
give the same samples.

gt_sampling builds the DataBaseSampler. The pseudo-label steps
(load_frustum_pseudos, load_selftrain_pseudos, unknowns_copy_paste) come
from `hooks`, a mapping of step name -> factory(cfg, augmentor) ->
callable(data_dict) that the caller hands down (the reference registers
them in a module-level dict instead; here two datasets never share them).
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ...utils import geometry_np as G


class DataAugmentor:
    def __init__(self, augmentor_configs, class_names, root_path=None,
                 logger=None, rng=None, hooks=None):
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.hooks = dict(hooks or {})
        self.class_names = class_names
        self.logger = logger
        self.root_path = root_path
        self.queue = []
        cfg_list = (
            augmentor_configs["AUG_CONFIG_LIST"]
            if isinstance(augmentor_configs, dict)
            else augmentor_configs
        )
        disable = (
            augmentor_configs.get("DISABLE_AUG_LIST", [])
            if isinstance(augmentor_configs, dict)
            else []
        )
        for cfg in cfg_list:
            name = cfg["NAME"]
            if name in disable:
                continue
            if name == "gt_sampling":
                from .database_sampler import DataBaseSampler

                self.queue.append(
                    DataBaseSampler(cfg, root_path, class_names,
                                    logger=logger, rng=self.rng)
                )
            elif name in self.hooks:
                self.queue.append(self.hooks[name](cfg, self))
            elif hasattr(self, name):
                self.queue.append(partial(getattr(self, name), config=cfg))
            else:
                raise ValueError(
                    f"augmentation {name!r} is neither a method of "
                    f"DataAugmentor nor one of the hooks given "
                    f"({sorted(self.hooks)})")

    # --- world augs; each records its parameter for later inversion ---

    def random_world_flip(self, data_dict, config):
        gt_boxes = data_dict.get("gt_boxes")
        points = data_dict["points"]
        for axis in config["ALONG_AXIS_LIST"]:
            enable = self.rng.random_sample() < 0.5
            if axis == "x":
                data_dict["flip_x"] = float(enable)
                if enable:
                    points, gt_boxes = G.flip_along_x(points, gt_boxes)
                    if data_dict.get("pseudo_boxes") is not None:
                        _, data_dict["pseudo_boxes"] = G.flip_along_x(
                            points[:0], data_dict["pseudo_boxes"]
                        )
            elif axis == "y":
                data_dict["flip_y"] = float(enable)
                if enable:
                    points, gt_boxes = G.flip_along_y(points, gt_boxes)
                    if data_dict.get("pseudo_boxes") is not None:
                        _, data_dict["pseudo_boxes"] = G.flip_along_y(
                            points[:0], data_dict["pseudo_boxes"]
                        )
        data_dict["points"] = points
        if gt_boxes is not None:
            data_dict["gt_boxes"] = gt_boxes
        return data_dict

    def random_world_rotation(self, data_dict, config):
        rot_range = config["WORLD_ROT_ANGLE"]
        if not isinstance(rot_range, (list, tuple, np.ndarray)):
            rot_range = [-rot_range, rot_range]
        angle = self.rng.uniform(rot_range[0], rot_range[1])
        data_dict["noise_rot"] = angle
        data_dict["points"] = G.rotate_points_along_z(data_dict["points"], angle)
        if data_dict.get("gt_boxes") is not None and len(data_dict["gt_boxes"]):
            data_dict["gt_boxes"] = G.rotate_boxes_along_z(
                data_dict["gt_boxes"], angle
            )
        if data_dict.get("pseudo_boxes") is not None and len(data_dict["pseudo_boxes"]):
            data_dict["pseudo_boxes"] = G.rotate_boxes_along_z(
                data_dict["pseudo_boxes"], angle
            )
        return data_dict

    def random_world_scaling(self, data_dict, config):
        lo, hi = config["WORLD_SCALE_RANGE"]
        scale = self.rng.uniform(lo, hi) if hi - lo >= 1e-3 else 1.0
        data_dict["noise_scale"] = scale
        data_dict["points"] = data_dict["points"].copy()
        data_dict["points"][:, :3] *= scale
        for key in ("gt_boxes", "pseudo_boxes"):
            if data_dict.get(key) is not None and len(data_dict[key]):
                b = data_dict[key].copy()
                b[:, :6] *= scale
                if b.shape[1] > 8:
                    b[:, 7:9] *= scale
                data_dict[key] = b
        return data_dict

    def random_world_translation(self, data_dict, config):
        std = config["NOISE_TRANSLATE_STD"]
        if not isinstance(std, (list, tuple, np.ndarray)):
            std = [std, std, std]
        offset = np.array(
            [self.rng.normal(0, s) for s in std], dtype=np.float32
        )
        data_dict["noise_translate"] = offset
        data_dict["points"] = data_dict["points"].copy()
        data_dict["points"][:, :3] += offset
        for key in ("gt_boxes", "pseudo_boxes"):
            if data_dict.get(key) is not None and len(data_dict[key]):
                b = data_dict[key].copy()
                b[:, :3] += offset
                data_dict[key] = b
        return data_dict

    # --- local / frustum / pyramid augs (augmentor_utils.py:200-705) ---

    @staticmethod
    def _points_in_box(points, box):
        from ...utils.geometry_np import points_in_boxes_mask

        return points_in_boxes_mask(points[:, :3], box[None, :7])[0]

    def random_local_translation(self, data_dict, config):
        """Per-object translation along the configured axes
        (random_local_translation_along_{x,y,z}, augmentor_utils.py:200-264)."""
        rng = config["LOCAL_TRANSLATION_RANGE"]
        gt = data_dict.get("gt_boxes")
        if gt is None or not len(gt):
            return data_dict
        gt = gt.copy()
        points = data_dict["points"].copy()
        axes = {"x": 0, "y": 1, "z": 2}
        for axis in config["ALONG_AXIS_LIST"]:
            a = axes[axis]
            for i in range(len(gt)):
                offset = self.rng.uniform(rng[0], rng[1])
                mask = self._points_in_box(points, gt[i])
                points[mask, a] += offset
                gt[i, a] += offset
        data_dict["gt_boxes"] = gt
        data_dict["points"] = points
        return data_dict

    def random_local_rotation(self, data_dict, config):
        """Per-object yaw jitter (local_rotation, augmentor_utils.py:368-414)."""
        rng = config["LOCAL_ROT_ANGLE"]
        gt = data_dict.get("gt_boxes")
        if gt is None or not len(gt):
            return data_dict
        gt = gt.copy()
        points = data_dict["points"].copy()
        for i in range(len(gt)):
            ang = self.rng.uniform(rng[0], rng[1])
            mask = self._points_in_box(points, gt[i])
            ctr = gt[i, :3]
            local = points[mask, :3] - ctr
            c, s = np.cos(ang), np.sin(ang)
            rot = np.stack([local[:, 0] * c - local[:, 1] * s,
                            local[:, 0] * s + local[:, 1] * c,
                            local[:, 2]], -1)
            points[mask, :3] = rot + ctr
            gt[i, 6] += ang
        data_dict["gt_boxes"] = gt
        data_dict["points"] = points
        return data_dict

    def random_local_scaling(self, data_dict, config):
        """Per-object scaling about the box center (local_scaling,
        augmentor_utils.py:334-366)."""
        rng = config["LOCAL_SCALE_RANGE"]
        gt = data_dict.get("gt_boxes")
        if gt is None or not len(gt):
            return data_dict
        gt = gt.copy()
        points = data_dict["points"].copy()
        for i in range(len(gt)):
            scale = self.rng.uniform(rng[0], rng[1])
            mask = self._points_in_box(points, gt[i])
            ctr = gt[i, :3]
            points[mask, :3] = (points[mask, :3] - ctr) * scale + ctr
            gt[i, 3:6] *= scale
        data_dict["gt_boxes"] = gt
        data_dict["points"] = points
        return data_dict

    def random_global_frustum_dropout(self, data_dict, config):
        """Scene-level slab dropout (global_frustum_dropout_*,
        augmentor_utils.py:266-333): drops everything above/below a
        fractional threshold of the z (top/bottom) or y (left/right) span."""
        rng = config["INTENSITY_RANGE"]
        gt = data_dict.get("gt_boxes")
        points = data_dict["points"]
        for direction in config["DIRECTION"]:
            if not len(points):
                break
            intensity = self.rng.uniform(rng[0], rng[1])
            axis = 2 if direction in ("top", "bottom") else 1
            lo, hi = points[:, axis].min(), points[:, axis].max()
            if direction in ("top", "left"):
                thr = hi - intensity * (hi - lo)
                keep_pts = points[:, axis] < thr
                keep_gt = gt[:, axis] < thr if gt is not None and len(gt) \
                    else None
            else:
                thr = lo + intensity * (hi - lo)
                keep_pts = points[:, axis] > thr
                keep_gt = gt[:, axis] > thr if gt is not None and len(gt) \
                    else None
            points = points[keep_pts]
            if keep_gt is not None:
                gt = gt[keep_gt]
                data_dict["gt_names"] = np.asarray(
                    data_dict["gt_names"])[keep_gt]
                if "gt_boxes_mask" in data_dict:
                    data_dict["gt_boxes_mask"] = np.asarray(
                        data_dict["gt_boxes_mask"])[keep_gt]
        data_dict["points"] = points
        if gt is not None:
            data_dict["gt_boxes"] = gt
        return data_dict

    # reference name for the scene-level slab dropout
    # (pcdet data_augmentor.py:236)
    def random_world_frustum_dropout(self, data_dict, config):
        return self.random_global_frustum_dropout(data_dict, config)

    def random_local_frustum_dropout(self, data_dict, config):
        """Per-object partial dropout (local_frustum_dropout_*,
        augmentor_utils.py:416-494): removes the in-box points beyond a
        fractional threshold of the box extent."""
        rng = config["INTENSITY_RANGE"]
        gt = data_dict.get("gt_boxes")
        if gt is None or not len(gt):
            return data_dict
        points = data_dict["points"]
        for direction in config["DIRECTION"]:
            for i in range(len(gt)):
                intensity = self.rng.uniform(rng[0], rng[1])
                mask = self._points_in_box(points, gt[i])
                z, dz = gt[i, 2], gt[i, 5]
                y, dy = gt[i, 1], gt[i, 4]
                x, dx = gt[i, 0], gt[i, 3]
                if direction == "top":
                    drop = mask & (points[:, 2] >= (z + dz / 2) - intensity * dz)
                elif direction == "bottom":
                    drop = mask & (points[:, 2] <= (z - dz / 2) + intensity * dz)
                elif direction == "left":
                    drop = mask & (points[:, 1] >= (y + dy / 2) - intensity * dy)
                else:
                    drop = mask & (points[:, 1] <= (y - dy / 2) + intensity * dy)
                points = points[~drop]
        data_dict["points"] = points
        return data_dict

    @staticmethod
    def _get_pyramids(boxes):
        """(N, 7) -> (N, 6, 5, 3) apex+base-quad pyramids per box face
        (get_pyramids, augmentor_utils.py:516-539)."""
        from ...utils.geometry_np import boxes_to_corners_3d

        orders = np.array([[0, 1, 5, 4], [4, 5, 6, 7], [7, 6, 2, 3],
                           [3, 2, 1, 0], [1, 2, 6, 5], [0, 4, 7, 3]])
        corners = boxes_to_corners_3d(boxes)          # (N, 8, 3)
        pyr = np.zeros((len(boxes), 6, 5, 3), np.float32)
        pyr[:, :, 0] = boxes[:, None, :3]
        for fi, order in enumerate(orders):
            pyr[:, fi, 1:] = corners[:, order]
        return pyr

    @staticmethod
    def _points_in_pyramids(points, pyramids):
        """(P, 3+), (M, 5, 3) -> (P, M) membership via convex-hull test."""
        from scipy.spatial import Delaunay

        flags = np.zeros((len(points), len(pyramids)), bool)
        for i, pyr in enumerate(pyramids):
            try:
                hull = Delaunay(pyr)
                flags[:, i] = hull.find_simplex(points[:, :3]) >= 0
            except Exception:
                pass
        return flags

    def random_local_pyramid_aug(self, data_dict, config):
        """Pyramid-level dropout / sparsify / swap
        (local_pyramid_dropout/sparsify/swap, augmentor_utils.py:557-705):
        each box splits into 6 face pyramids; a random pyramid per box may be
        dropped, down-sampled to a point budget, or swapped with the same
        face pyramid of another box (points re-parametrized by surface
        ratios)."""
        gt = data_dict.get("gt_boxes")
        if gt is None or not len(gt):
            return data_dict
        points = data_dict["points"]
        pyramids = self._get_pyramids(gt)             # (N, 6, 5, 3)

        # dropout
        p_drop = float(config.get("DROP_PROB", 0))
        if p_drop > 0 and len(pyramids):
            sel = self.rng.randint(0, 6, len(pyramids))
            box_m = self.rng.uniform(0, 1, len(pyramids)) <= p_drop
            if box_m.any():
                drop_p = pyramids[box_m, sel[box_m]]
                m = self._points_in_pyramids(points, drop_p)
                points = points[~m.any(-1)]
            pyramids = pyramids[~box_m]

        # sparsify
        p_sp = float(config.get("SPARSIFY_PROB", 0))
        n_sp = int(config.get("SPARSIFY_MAX_NUM", 50))
        if p_sp > 0 and len(pyramids):
            sel = self.rng.randint(0, 6, len(pyramids))
            box_m = self.rng.uniform(0, 1, len(pyramids)) <= p_sp
            cand = pyramids[box_m, sel[box_m]]
            if len(cand):
                m = self._points_in_pyramids(points, cand)
                counts = m.sum(0)
                keep_rows = ~m[:, counts > n_sp].any(-1)
                sparsified = []
                for ci in np.where(counts > n_sp)[0]:
                    rows = np.where(m[:, ci])[0]
                    pick = self.rng.choice(rows, n_sp, replace=False)
                    sparsified.append(points[pick])
                if sparsified:
                    points = np.concatenate(
                        [points[keep_rows]] + sparsified, axis=0)
            pyramids = pyramids[~box_m]

        # swap (ratio re-parametrization between same-face pyramids)
        p_sw = float(config.get("SWAP_PROB", 0))
        n_sw = int(config.get("SWAP_MAX_NUM", 50))
        if p_sw > 0 and len(pyramids) >= 2:
            def ratios(pts, pyr):
                p = pyr.reshape(15)
                sc = (p[3:6] + p[6:9] + p[9:12] + p[12:]) / 4.0
                v0 = p[6:9] - p[3:6]
                v1 = p[12:] - p[3:6]
                v2 = p[0:3] - sc
                rel = pts[:, :3] - p[3:6]
                a = rel @ v0 / max(v0 @ v0, 1e-9)
                b = rel @ v1 / max(v1 @ v1, 1e-9)
                base_pt = p[3:6] + a[:, None] * v0 + b[:, None] * v1
                g = np.linalg.norm(pts[:, :3] - base_pt, axis=1) / \
                    max(np.linalg.norm(v2), 1e-9)
                return a, b, g

            def recover(a, b, g, pyr):
                p = pyr.reshape(15)
                sc = (p[3:6] + p[6:9] + p[9:12] + p[12:]) / 4.0
                v0 = p[6:9] - p[3:6]
                v1 = p[12:] - p[3:6]
                v2 = p[0:3] - sc
                base = p[3:6] + a[:, None] * v0 + b[:, None] * v1
                return base + g[:, None] * v2

            sel = self.rng.randint(0, 6, len(pyramids))
            box_m = np.where(self.rng.uniform(0, 1, len(pyramids)) <= p_sw)[0]
            for bi in box_m:
                others = [o for o in range(len(pyramids)) if o != bi]
                oi = int(self.rng.choice(others))
                pa = pyramids[bi, sel[bi]]
                pb = pyramids[oi, sel[bi]]
                ma = self._points_in_pyramids(points, pa[None])[:, 0]
                mb = self._points_in_pyramids(points, pb[None])[:, 0]
                if ma.sum() == 0 or mb.sum() == 0:
                    continue
                a2, b2, g2 = ratios(points[mb], pb)
                moved = recover(a2, b2, g2, pa)
                new_rows = points[mb].copy()
                new_rows[:, :3] = moved
                points = np.concatenate([points[~ma], new_rows], axis=0)
        data_dict["points"] = points
        return data_dict

    def forward(self, data_dict):
        for aug in self.queue:
            data_dict = aug(data_dict)
        if data_dict.get("gt_boxes") is not None and len(data_dict["gt_boxes"]):
            data_dict["gt_boxes"][:, 6] = G.limit_period(
                data_dict["gt_boxes"][:, 6], offset=0.5, period=2 * np.pi
            )
        if "gt_boxes_mask" in data_dict:
            mask = data_dict.pop("gt_boxes_mask")
            if data_dict.get("gt_boxes") is not None:
                data_dict["gt_boxes"] = data_dict["gt_boxes"][mask]
                data_dict["gt_names"] = np.asarray(data_dict["gt_names"])[mask]
        return data_dict
