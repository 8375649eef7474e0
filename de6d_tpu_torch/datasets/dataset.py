"""Dataset base class.

Parity: reference DatasetTemplate (datasets/dataset.py:13-229): owns
PointFeatureEncoder, DataAugmentor (train only), DataProcessor, runs
the prepare_data pipeline per sample and a shape-stable collate.

TPU-first differences:
- collate emits FIXED shapes: points (B, MAX_POINTS, C) + 'points_mask'
  and gt_boxes (B, MAX_GT, 7+1[+2]) zero-padded — no ragged batch-idx
  columns (reference collate_batch pads gt to the per-batch max and
  prepends a batch column, :161-229).
- per-sample RandomState threaded through augmentations (reproducible
  with --fix_random_seed).
- the augmentation runs in the caller's ``turn`` (:class:`Turn`): the
  database sampler's ring pointer is state shared by every sample, so the
  loader hands the augmentor to samples in their order, whatever the
  number of workers (the JAX loader's batches are reproducible with one
  worker only).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..models.detectors.detector3d_template import DatasetSpec
from ..utils.common_utils import keep_arrays_by_name
from .augmentor.data_augmentor import DataAugmentor
from .processor.data_processor import DataProcessor
from .processor.point_feature_encoder import PointFeatureEncoder


class Turn:
    """A sample's turn at the augmentor. ``wait()`` blocks until the
    samples before it have released theirs; ``done()`` releases it (once;
    later calls do nothing). This base class is the turn of a sample
    prepared alone: it never waits."""

    def wait(self):
        pass

    def done(self):
        pass


class DatasetTemplate:
    def __init__(self, dataset_cfg=None, class_names=None, training=True,
                 root_path=None, logger=None):
        self.dataset_cfg = dataset_cfg
        self.training = training
        self.class_names = class_names
        self.logger = logger
        self.root_path = Path(
            root_path if root_path is not None
            else dataset_cfg.get("DATA_PATH", ".")
        )

        self.point_cloud_range = np.array(
            dataset_cfg["POINT_CLOUD_RANGE"], dtype=np.float32
        )
        self.point_feature_encoder = PointFeatureEncoder(
            dataset_cfg["POINT_FEATURE_ENCODING"]
        )
        self.data_augmentor = (
            DataAugmentor(
                self.root_path, dataset_cfg["DATA_AUGMENTOR"],
                self.class_names, logger=logger,
            )
            if self.training and "DATA_AUGMENTOR" in dataset_cfg
            else None
        )
        self.data_processor = DataProcessor(
            dataset_cfg["DATA_PROCESSOR"],
            point_cloud_range=self.point_cloud_range,
            training=self.training,
            num_point_features=self.point_feature_encoder.num_point_features,
        )
        self.grid_size = self.data_processor.grid_size
        self.voxel_size = self.data_processor.voxel_size
        self.max_gt = int(dataset_cfg.get("MAX_GT", 64))
        self.max_points = self.data_processor.max_points or int(
            dataset_cfg.get("MAX_POINTS", 16384)
        )
        self._epoch = 0

    @property
    def mode(self):
        return "train" if self.training else "test"

    @property
    def spec(self) -> DatasetSpec:
        vp = self.data_processor.voxel_params or {}
        return DatasetSpec(
            class_names=tuple(self.class_names),
            point_feature_dim=self.point_feature_encoder.num_point_features,
            point_cloud_range=tuple(float(x) for x in self.point_cloud_range),
            voxel_size=tuple(vp.get("voxel_size", (0.16, 0.16, 4.0))),
            max_voxels=vp.get("max_voxels", 16000),
            max_points_per_voxel=vp.get("max_points_per_voxel", 32),
        )

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, index):
        raise NotImplementedError

    # ------------------------------------------------------------------
    def prepare_data(self, data_dict, rng=None, turn=None):
        """Filter classes → augment → encode → process (reference
        prepare_data, dataset.py:102-158). Returns None when training
        and no valid gt remains (caller re-draws another index —
        reference :152-154); the sample then keeps its ``turn``, which is
        released once its gt is not empty."""
        rng = rng or np.random.RandomState()
        turn = turn or Turn()
        data_dict["_rng"] = rng
        if self.training:
            assert "gt_boxes" in data_dict
            gt_boxes_mask = np.array(
                [n in self.class_names for n in data_dict["gt_names"]],
                dtype=bool,
            )
            data_dict["gt_boxes"] = data_dict["gt_boxes"][gt_boxes_mask]
            data_dict["gt_names"] = data_dict["gt_names"][gt_boxes_mask]
            if "gt_boxes2d" in data_dict:  # keep 2D boxes aligned (CaDDN)
                data_dict["gt_boxes2d"] = data_dict["gt_boxes2d"][gt_boxes_mask]
            if self.data_augmentor is not None:
                turn.wait()
                data_dict = self.data_augmentor.forward(data_dict, rng)
            if data_dict["gt_boxes"].shape[0] == 0:
                return None
        turn.done()

        if data_dict.get("gt_boxes", None) is not None:
            selected = keep_arrays_by_name(
                data_dict["gt_names"], self.class_names
            )
            data_dict["gt_boxes"] = data_dict["gt_boxes"][selected]
            data_dict["gt_names"] = data_dict["gt_names"][selected]
            if "gt_boxes2d" in data_dict:
                data_dict["gt_boxes2d"] = data_dict["gt_boxes2d"][selected]
            gt_classes = np.array(
                [self.class_names.index(n) + 1 for n in data_dict["gt_names"]],
                dtype=np.float32,
            )
            data_dict["gt_boxes"] = np.concatenate(
                [
                    data_dict["gt_boxes"].astype(np.float32),
                    gt_classes.reshape(-1, 1),
                ],
                axis=1,
            )

        data_dict = self.point_feature_encoder.forward(data_dict)
        data_dict = self.data_processor.forward(data_dict)
        data_dict.pop("_rng", None)
        data_dict.pop("gt_names", None)
        return data_dict

    # ------------------------------------------------------------------
    def collate_batch(self, batch_list):
        """Fixed-shape collate. Returns dict of stacked np arrays."""
        batch = {}
        # only keys present in EVERY sample are batchable (probabilistic
        # augs like SlopeAug add per-sample extras such as 'slope_plane')
        keys = [
            k for k in batch_list[0].keys()
            if all(k in d for d in batch_list)
        ]
        b = len(batch_list)

        for key in keys:
            if key == "points":
                pts = np.stack([d["points"] for d in batch_list])
                batch["points"] = pts.astype(np.float32)
                n = np.array(
                    [d.get("num_points", pts.shape[1]) for d in batch_list]
                )
                mask = (
                    np.arange(pts.shape[1])[None, :] < n[:, None]
                )
                batch["points_mask"] = mask
            elif key == "gt_boxes":
                ndim = max(d["gt_boxes"].shape[1] for d in batch_list)
                out = np.zeros((b, self.max_gt, ndim), np.float32)
                for i, d in enumerate(batch_list):
                    g = d["gt_boxes"][: self.max_gt]
                    if g.shape[1] < ndim:  # mixed 7/9-DoF: splice class col
                        g = np.concatenate(
                            [
                                g[:, :-1],
                                np.zeros((g.shape[0], ndim - g.shape[1])),
                                g[:, -1:],
                            ],
                            axis=1,
                        )
                    out[i, : g.shape[0]] = g
                batch["gt_boxes"] = out
            elif key in ("images", "depth_maps"):
                # pad bottom/right to the batch-max H/W (reference
                # collate_batch pads images with zeros the same way;
                # real-KITTI frames differ by a few pixels)
                arrs = [np.asarray(d[key], np.float32) for d in batch_list]
                hmax = max(a.shape[0] for a in arrs)
                wmax = max(a.shape[1] for a in arrs)
                padded = [
                    np.pad(
                        a,
                        ((0, hmax - a.shape[0]), (0, wmax - a.shape[1]))
                        + ((0, 0),) * (a.ndim - 2),
                    )
                    for a in arrs
                ]
                batch[key] = np.stack(padded)
            elif key == "gt_boxes2d":
                out = np.zeros((b, self.max_gt, 4), np.float32)
                for i, d in enumerate(batch_list):
                    g = d["gt_boxes2d"][: self.max_gt]
                    out[i, : g.shape[0]] = g
                batch[key] = out
            elif key in ("num_points",):
                continue
            elif key == "image_shape":
                # (B, 2) int32 — the camera stack (CaDDN frustum grid)
                # consumes it on device; host eval indexes rows
                batch[key] = np.stack(
                    [np.asarray(d[key], np.int32) for d in batch_list]
                )
            elif key in ("frame_id", "calib", "metadata"):
                batch[key] = [d[key] for d in batch_list]
            else:
                try:
                    batch[key] = np.stack([d[key] for d in batch_list])
                except Exception:
                    batch[key] = [d[key] for d in batch_list]
        batch["batch_size"] = b
        return batch
