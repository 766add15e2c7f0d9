"""DatasetTemplate: per-sample prepare_data pipeline + fixed-shape
collation — port of findnpropagate_tpu/datasets/dataset.py.

prepare_data runs augmentor -> class filter -> point-feature encoding ->
processor steps; collate_batch pads the ragged per-sample outputs to fixed
shapes (points to MAX_POINTS with a mask, gt_boxes to MAX_GT, pseudo boxes
to MAX_PSEUDO), so every batch has the same shapes; voxelization is not
done here but on the device, inside the model.

The dataset owns `rng`, one np.random.RandomState that its augmentor,
gt sampler, processor and pseudo-label hooks all draw from, in the
reference's order (the reference draws from numpy's global state). Only
the thread that builds samples may draw from it.
"""

from __future__ import annotations

import numpy as np

from .augmentor.data_augmentor import DataAugmentor
from .processor.data_processor import DataProcessor
from .processor.point_feature_encoder import PointFeatureEncoder


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None, rng=None, hooks=None):
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = list(class_names or [])
        self.logger = logger
        self.root_path = root_path

        self.point_cloud_range = np.array(
            dataset_cfg["POINT_CLOUD_RANGE"], dtype=np.float32
        )
        self.point_feature_encoder = PointFeatureEncoder(
            dataset_cfg["POINT_FEATURE_ENCODING"],
            point_cloud_range=self.point_cloud_range,
        )
        self.data_augmentor = (
            DataAugmentor(
                dataset_cfg.get("DATA_AUGMENTOR"), self.class_names,
                root_path=root_path or dataset_cfg.get("DATA_PATH"),
                logger=logger, rng=self.rng, hooks=hooks,
            )
            if training and dataset_cfg.get("DATA_AUGMENTOR")
            else None
        )
        self.data_processor = DataProcessor(
            dataset_cfg["DATA_PROCESSOR"],
            point_cloud_range=self.point_cloud_range,
            training=self.training,
            num_point_features=self.point_feature_encoder.num_point_features,
            rng=self.rng,
        )
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size

        caps = dataset_cfg.get("CAPACITIES", {})
        self.max_points = int(caps.get("MAX_POINTS", 60000))
        self.max_gt = int(caps.get("MAX_GT", 128))
        self.max_pseudo = int(caps.get("MAX_PSEUDO", 64))
        self.max_voxels = int(caps.get("MAX_VOXELS", 40000))
        self.max_points_per_voxel = int(caps.get("MAX_POINTS_PER_VOXEL", 32))

    @property
    def num_point_features(self):
        return self.point_feature_encoder.num_point_features

    def prepare_data(self, data_dict):
        """data_dict: {points (N, 3+C), gt_boxes (M, 7), gt_names (M,)}."""
        if self.training and self.data_augmentor is not None:
            gt_names = data_dict.get("gt_names")
            if gt_names is not None:
                data_dict["gt_boxes_mask"] = np.array(
                    [n in self.class_names for n in gt_names], dtype=bool
                )
            data_dict = self.data_augmentor.forward(data_dict)

        if data_dict.get("gt_boxes", None) is not None:
            selected = np.array(
                [n in self.class_names for n in data_dict["gt_names"]], dtype=bool
            )
            data_dict["gt_boxes"] = data_dict["gt_boxes"][selected]
            data_dict["gt_names"] = np.array(data_dict["gt_names"])[selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict["gt_names"]],
                dtype=np.int32,
            )
            data_dict["gt_boxes"] = np.concatenate(
                (
                    data_dict["gt_boxes"][:, :7],
                    gt_classes.reshape(-1, 1).astype(np.float32),
                ),
                axis=1,
            )

        data_dict = self.point_feature_encoder.forward(data_dict)
        data_dict = self.data_processor.forward(data_dict)

        if self.training and data_dict.get("gt_boxes") is not None \
                and len(data_dict["gt_boxes"]) == 0:
            # resample like the reference
            new_index = self.rng.randint(len(self))
            return self.__getitem__(new_index)
        return data_dict

    def collate_batch(self, batch_list):
        """Pad each sample to (MAX_POINTS, MAX_GT) and stack. Fixed shapes.

        Double-flip TTA (reference data_processor.py:239-302): each sample
        expands into [orig, yflip, xflip, xyflip] — batch becomes B*4 with
        gt only on the originals; the consuming head merges the four
        (VoxelNeXt DOUBLE_FLIP)."""
        if getattr(self.data_processor, "double_flip", False):
            expanded = []
            for s in batch_list:
                expanded.append(s)
                for fy, fx in ((True, False), (False, True), (True, True)):
                    t = dict(s)
                    pts = np.array(s["points"], copy=True)
                    if fy:
                        pts[:, 1] = -pts[:, 1]
                    if fx:
                        pts[:, 0] = -pts[:, 0]
                    t["points"] = pts
                    t["gt_boxes"] = np.zeros((0, 7), np.float32)
                    t["gt_names"] = np.asarray([])
                    expanded.append(t)
            batch_list = expanded
        b = len(batch_list)
        f = batch_list[0]["points"].shape[-1]
        points = np.zeros((b, self.max_points, f), dtype=np.float32)
        points_mask = np.zeros((b, self.max_points), dtype=bool)
        gt_boxes = np.zeros((b, self.max_gt, 8), dtype=np.float32)
        frame_ids = []
        has_pseudo = any(s.get("pseudo_boxes") is not None for s in batch_list)
        if has_pseudo:
            pseudo_boxes = np.zeros((b, self.max_pseudo, 8), dtype=np.float32)
            pseudo_samples_mask = np.zeros((b, self.max_pseudo), dtype=bool)
        for i, s in enumerate(batch_list):
            pts = s["points"][: self.max_points]
            points[i, : len(pts)] = pts
            points_mask[i, : len(pts)] = True
            if s.get("gt_boxes") is not None:
                g = s["gt_boxes"][: self.max_gt]
                gt_boxes[i, : len(g), : g.shape[-1]] = g
            if has_pseudo and s.get("pseudo_boxes") is not None:
                p = np.asarray(s["pseudo_boxes"])[: self.max_pseudo]
                pseudo_boxes[i, : len(p), : p.shape[-1]] = p
                sm = s.get("pseudo_samples_mask")
                if sm is not None:
                    sm = np.asarray(sm)[: self.max_pseudo]
                    pseudo_samples_mask[i, : len(sm)] = sm
            frame_ids.append(s.get("frame_id", i))
        batch = {
            "points": points,
            "points_mask": points_mask,
            "gt_boxes": gt_boxes,
            "batch_size": b,
            "frame_id": frame_ids,
        }
        if has_pseudo:
            batch["pseudo_boxes"] = pseudo_boxes
            batch["pseudo_samples_mask"] = pseudo_samples_mask
        # first-stage proposal trajectories (MPPNet; per-sample fixed shape)
        for key in ("roi_boxes", "roi_scores", "roi_labels"):
            if all(key in s for s in batch_list):
                batch[key] = np.stack([np.asarray(s[key])
                                       for s in batch_list])
        # camera matrices/images for the OV + fusion pipelines
        for key in ("lidar2image", "camera2lidar", "camera_intrinsics",
                    "camera_imgs", "img_aug_matrix", "lidar_aug_matrix",
                    "trans_lidar_to_cam", "trans_cam_to_img"):
            if all(key in s for s in batch_list):
                batch[key] = np.stack(
                    [np.asarray(s[key], np.float32) for s in batch_list]
                )
        return batch

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError
