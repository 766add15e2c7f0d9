"""PointFeatureEncoder — selects the per-point features; port of
findnpropagate_tpu/datasets/processor/point_feature_encoder.py: the
absolute-coordinates encoding keeps xyz plus the configured extra feature
channels from the source list.
"""

from __future__ import annotations

import numpy as np


class PointFeatureEncoder:
    def __init__(self, config, point_cloud_range=None):
        self.config = config
        assert list(config["src_feature_list"][0:3]) == ["x", "y", "z"]
        self.used_feature_list = list(config["used_feature_list"])
        self.src_feature_list = list(config["src_feature_list"])
        self.point_cloud_range = point_cloud_range

    @property
    def num_point_features(self):
        assert self.config["encoding_type"] == "absolute_coordinates_encoding"
        return len(self.used_feature_list)

    def forward(self, data_dict):
        points = data_dict["points"]
        point_feature_list = [points[:, 0:3]]
        for x in self.used_feature_list:
            if x in ("x", "y", "z"):
                continue
            idx = self.src_feature_list.index(x)
            point_feature_list.append(points[:, idx : idx + 1])
        data_dict["points"] = np.concatenate(point_feature_list, axis=1)
        data_dict["use_lead_xyz"] = True
        return data_dict
