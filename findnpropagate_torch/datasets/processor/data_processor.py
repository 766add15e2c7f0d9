"""DataProcessor — cfg-named queue of host-side point/box processing steps;
port of findnpropagate_tpu/datasets/processor/data_processor.py.

`transform_points_to_voxels` only records the grid and voxel geometry: the
voxelization runs on the device inside the model (ops/voxelize.py). The
other steps (range masking, shuffling, point sampling) are numpy; their
random draws come from `rng`, the dataset's np.random.RandomState, in the
reference's order, so the same seed gives the same points.
"""

from __future__ import annotations

import numpy as np

from ...utils.geometry_np import mask_boxes_outside_range, mask_points_by_range


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training,
                 num_point_features, rng=None):
        self.rng = rng if rng is not None else np.random.RandomState(0)
        self.point_cloud_range = np.asarray(point_cloud_range, np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.grid_size = None
        self.voxel_size = None
        self.double_flip = False
        self.queue = []
        for cfg in processor_configs:
            if cfg["NAME"] == "transform_points_to_voxels":
                # double-flip TTA (data_processor.py:239-302): each eval
                # sample expands into [orig, yflip, xflip, xyflip] at
                # collate time (voxelization stays on device)
                self.double_flip = bool(cfg.get("DOUBLE_FLIP", False)) \
                    and not training
                # grid geometry must be known at construction time (the model
                # builder reads it); the device does the actual voxelization.
                self.voxel_size = np.asarray(cfg["VOXEL_SIZE"], np.float32)
                grid = (
                    self.point_cloud_range[3:6] - self.point_cloud_range[0:3]
                ) / self.voxel_size
                self.grid_size = np.round(grid).astype(np.int64)
            fn = getattr(self, cfg["NAME"])
            self.queue.append((fn, cfg))

    def mask_points_and_boxes_outside_range(self, data_dict, config):
        mask = mask_points_by_range(data_dict["points"], self.point_cloud_range)
        data_dict["points"] = data_dict["points"][mask]
        if (
            data_dict.get("gt_boxes") is not None
            and config.get("REMOVE_OUTSIDE_BOXES", False)
            and self.training
        ):
            bmask = mask_boxes_outside_range(
                data_dict["gt_boxes"], self.point_cloud_range
            )
            data_dict["gt_boxes"] = data_dict["gt_boxes"][bmask]
            if data_dict.get("gt_names") is not None:
                data_dict["gt_names"] = np.asarray(data_dict["gt_names"])[bmask]
        return data_dict

    def shuffle_points(self, data_dict, config):
        if config.get("SHUFFLE_ENABLED", {}).get(
            "train" if self.training else "test", self.training
        ):
            idx = self.rng.permutation(data_dict["points"].shape[0])
            data_dict["points"] = data_dict["points"][idx]
        return data_dict

    def sample_points(self, data_dict, config):
        num = config["NUM_POINTS"]["train" if self.training else "test"]
        points = data_dict["points"]
        if num < len(points):
            # far/near-aware sampling as the reference (data_processor.py:190+)
            depth = np.linalg.norm(points[:, :3], axis=1)
            far = points[depth >= 40.0]
            near = points[depth < 40.0]
            if num > len(far):
                choice = self.rng.choice(len(near), num - len(far), replace=False)
                points = np.concatenate([far, near[choice]], axis=0)
            else:
                choice = self.rng.choice(len(points), num, replace=False)
                points = points[choice]
            self.rng.shuffle(points)
        data_dict["points"] = points
        return data_dict

    def transform_points_to_voxels(self, data_dict, config):
        """No-op at sample time: the device voxelizes inside the model."""
        return data_dict

    def forward(self, data_dict):
        for fn, cfg in self.queue:
            data_dict = fn(data_dict, cfg)
        return data_dict
