"""Point feature selection/encoding.

Parity: reference datasets/processor/point_feature_encoder.py:56 —
selects used_feature_list channels out of src_feature_list, keeps
leading xyz (absolute_coordinates_encoding).
"""

from __future__ import annotations

import numpy as np


class PointFeatureEncoder:
    def __init__(self, config):
        self.config = config
        assert list(config["src_feature_list"][0:3]) == ["x", "y", "z"]
        self.used_feature_list = list(config["used_feature_list"])
        self.src_feature_list = list(config["src_feature_list"])

    @property
    def num_point_features(self):
        return getattr(
            self, self.config["encoding_type"]
        )(points=None)

    def forward(self, data_dict):
        data_dict["points"], use_lead_xyz = getattr(
            self, self.config["encoding_type"]
        )(data_dict["points"])
        data_dict["use_lead_xyz"] = use_lead_xyz
        return data_dict

    def absolute_coordinates_encoding(self, points=None):
        if points is None:
            return len(self.used_feature_list)
        point_features = [points[:, 0:3]]
        for f in self.used_feature_list:
            if f in ("x", "y", "z"):
                continue
            idx = self.src_feature_list.index(f)
            point_features.append(points[:, idx : idx + 1])
        return np.concatenate(point_features, axis=1), True
