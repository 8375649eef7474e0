"""Host-side data processor queue.

Parity: reference datasets/processor/data_processor.py:199-214 — a
config-driven list of processors. TPU-first differences:

- ``transform_points_to_voxels`` with ON_DEVICE (default) is a
  *declaration*: it records voxel params into the pipeline spec; the
  actual voxelization runs fused on-device in the detector
  (Detector3DTemplate.maybe_voxelize), replacing the reference's CPU
  spconv voxel generator.
- ``pad_points`` produces the fixed-size (MAX_POINTS, C) buffer +
  validity count the shape-stable collate needs.
- ``sample_points`` keeps the reference's near/far split semantics
  (data_processor.py:145-178).
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ...utils.common_utils import limit_period


class DataProcessor:
    def __init__(self, processor_configs, point_cloud_range, training,
                 num_point_features):
        self.point_cloud_range = np.array(point_cloud_range, np.float32)
        self.training = training
        self.num_point_features = num_point_features
        self.mode = "train" if training else "test"
        self.voxel_params = None  # filled by transform_points_to_voxels
        self.max_points = None
        self.data_processor_queue = []
        self.grid_size = None
        self.voxel_size = None
        for cfg in processor_configs:
            self.data_processor_queue.append(
                getattr(self, cfg["NAME"])(config=cfg)
            )

    def mask_points_and_boxes_outside_range(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(
                self.mask_points_and_boxes_outside_range, config=config
            )
        points = data_dict["points"]
        pc = self.point_cloud_range
        mask = (
            (points[:, 0] >= pc[0]) & (points[:, 0] <= pc[3])
            & (points[:, 1] >= pc[1]) & (points[:, 1] <= pc[4])
        )
        data_dict["points"] = points[mask]
        if (
            data_dict.get("gt_boxes", None) is not None
            and config.get("REMOVE_OUTSIDE_BOXES", False)
            and self.training
            and data_dict["gt_boxes"].shape[0]
        ):
            from ...utils import box_np_utils

            keep = box_np_utils.mask_boxes_outside_range(
                data_dict["gt_boxes"][:, :7], pc,
                min_num_corners=config.get("min_num_corners", 1),
            )
            data_dict["gt_boxes"] = data_dict["gt_boxes"][keep]
            if "gt_names" in data_dict:
                data_dict["gt_names"] = data_dict["gt_names"][keep]
        return data_dict

    def shuffle_points(self, data_dict=None, config=None):
        if data_dict is None:
            return partial(self.shuffle_points, config=config)
        if config["SHUFFLE_ENABLED"][self.mode]:
            rng = data_dict.get("_rng") or np.random.RandomState()
            idx = rng.permutation(data_dict["points"].shape[0])
            data_dict["points"] = data_dict["points"][idx]
        return data_dict

    def sample_points(self, data_dict=None, config=None):
        """Subsample/pad to NUM_POINTS with near/far split (reference
        data_processor.py:145-178)."""
        if data_dict is None:
            return partial(self.sample_points, config=config)
        num_points = config["NUM_POINTS"][self.mode]
        if num_points == -1:
            return data_dict
        points = data_dict["points"]
        rng = data_dict.get("_rng") or np.random.RandomState()
        if num_points < len(points):
            dist = np.linalg.norm(points[:, 0:3], axis=1)
            near_mask = dist < 40.0
            far_idxs = np.where(~near_mask)[0]
            near_idxs = np.where(near_mask)[0]
            if num_points > len(far_idxs):
                near_keep = num_points - len(far_idxs)
                near_idxs = rng.choice(near_idxs, near_keep, replace=False)
                choice = np.concatenate([near_idxs, far_idxs])
            else:
                choice = rng.choice(
                    np.arange(len(points)), num_points, replace=False
                )
            rng.shuffle(choice)
            data_dict["points"] = points[choice]
        else:
            if config.get("PAD_WITH_DUPLICATES", False):
                extra = rng.choice(
                    len(points), num_points - len(points),
                    replace=num_points - len(points) > len(points),
                )
                data_dict["points"] = np.concatenate(
                    [points, points[extra]], axis=0
                )
        return data_dict

    def pad_points(self, data_dict=None, config=None):
        """Fixed-size point buffer: truncate or zero-pad to MAX_POINTS
        and emit 'num_points' (shape-stable collate support)."""
        if data_dict is None:
            self.max_points = int(config["MAX_POINTS"])
            return partial(self.pad_points, config=config)
        max_points = int(config["MAX_POINTS"])
        points = data_dict["points"]
        n = points.shape[0]
        if n > max_points:
            rng = data_dict.get("_rng") or np.random.RandomState()
            choice = rng.choice(n, max_points, replace=False)
            points = points[choice]
            n = max_points
        elif n < max_points:
            pad = np.zeros((max_points - n, points.shape[1]), points.dtype)
            points = np.concatenate([points, pad], axis=0)
        data_dict["points"] = points
        data_dict["num_points"] = n
        return data_dict

    def transform_points_to_voxels(self, data_dict=None, config=None):
        if data_dict is None:
            self.voxel_size = np.array(config["VOXEL_SIZE"], np.float32)
            grid = (
                self.point_cloud_range[3:6] - self.point_cloud_range[0:3]
            ) / self.voxel_size
            self.grid_size = np.round(grid).astype(np.int64)
            self.voxel_params = {
                "voxel_size": [float(v) for v in config["VOXEL_SIZE"]],
                "max_points_per_voxel": int(config["MAX_POINTS_PER_VOXEL"]),
                "max_voxels": int(
                    config["MAX_NUMBER_OF_VOXELS"][self.mode]
                    if isinstance(config["MAX_NUMBER_OF_VOXELS"], dict)
                    else config["MAX_NUMBER_OF_VOXELS"]
                ),
                "on_device": bool(config.get("ON_DEVICE", True)),
            }
            return partial(self.transform_points_to_voxels, config=config)
        # on-device: nothing to do per sample
        return data_dict

    def calculate_grid_size(self, data_dict=None, config=None):
        if data_dict is None:
            self.voxel_size = np.array(config["VOXEL_SIZE"], np.float32)
            grid = (
                self.point_cloud_range[3:6] - self.point_cloud_range[0:3]
            ) / self.voxel_size
            self.grid_size = np.round(grid).astype(np.int64)
            return partial(self.calculate_grid_size, config=config)
        return data_dict

    def downsample_depth_map(self, data_dict=None, config=None):
        """Block-mean downsample of the LiDAR depth map (CaDDN input).

        Parity: reference data_processor.py:188-197
        (skimage.transform.downscale_local_mean) — zero-pads H/W up to
        a multiple of the factor and averages over FULL blocks,
        including the zero padding; reproduced here with a reshape so
        the host pipeline stays numpy-only.
        """
        if data_dict is None:
            self.depth_downsample_factor = int(config["DOWNSAMPLE_FACTOR"])
            return partial(self.downsample_depth_map, config=config)
        f = self.depth_downsample_factor
        depth = np.asarray(data_dict["depth_maps"], np.float32)
        h, w = depth.shape
        ph, pw = (-h) % f, (-w) % f
        if ph or pw:
            depth = np.pad(depth, ((0, ph), (0, pw)))
        hh, ww = depth.shape
        data_dict["depth_maps"] = depth.reshape(
            hh // f, f, ww // f, f
        ).mean(axis=(1, 3))
        return data_dict

    def forward(self, data_dict):
        for proc in self.data_processor_queue:
            data_dict = proc(data_dict=data_dict)
        return data_dict
