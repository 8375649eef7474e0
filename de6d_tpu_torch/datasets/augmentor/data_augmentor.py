"""Config-driven augmentation queue.

Parity: reference datasets/augmentor/data_augmentor.py:9-313 — a list
of named augmentations from DATA_AUGMENTOR.AUG_CONFIG_LIST minus
DISABLE_AUG_LIST, applied in order; SlopeAug
(``random_make_slope_in_scene``, reference :265-282) extends gt boxes
to 9 dims probabilistically; yaw is re-wrapped to [-pi, pi) at the end
(:298-300).
"""

from __future__ import annotations

from functools import partial

import numpy as np

from ...utils.common_utils import limit_period
from . import augmentor_utils
from .database_sampler import DataBaseSampler


def _pyramid_groups(config, names):
    """Yield (config_key, box_mask) per pyramid-aug application. An
    'all' config is ONE application over every box (one Bernoulli draw
    per box, like the reference); per-class configs get their class
    masks."""
    if "all" in config:
        yield "all", np.ones(len(names), bool)
        return
    for cls in config.keys():
        if cls != "NAME":
            yield cls, names == cls


class DataAugmentor:
    def __init__(self, root_path, augmentor_configs, class_names, logger=None):
        self.root_path = root_path
        self.class_names = class_names
        self.logger = logger
        self.data_augmentor_queue = []
        aug_list = (
            augmentor_configs
            if isinstance(augmentor_configs, list)
            else augmentor_configs["AUG_CONFIG_LIST"]
        )
        disable = (
            []
            if isinstance(augmentor_configs, list)
            else augmentor_configs.get("DISABLE_AUG_LIST", [])
        )
        self._queue_configs = [c for c in aug_list if c["NAME"] not in disable]
        for cfg in self._queue_configs:
            self.data_augmentor_queue.append(
                getattr(self, cfg["NAME"])(config=cfg)
            )

    # -- pickling (the loader's child process gets the augmentor so) -------
    def __getstate__(self):
        # the ops are closures, which do not pickle: keep each op's config
        # and rebuild it; the database sampler goes as it is (its ring
        # pointers and permutations are state)
        state = self.__dict__.copy()
        state["data_augmentor_queue"] = [
            aug if isinstance(aug, DataBaseSampler) else cfg
            for aug, cfg in zip(self.data_augmentor_queue,
                                self._queue_configs)
        ]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.data_augmentor_queue = [
            aug if isinstance(aug, DataBaseSampler)
            else getattr(self, aug["NAME"])(config=aug)
            for aug in self.data_augmentor_queue
        ]

    # -- augmentation builders ---------------------------------------------
    def gt_sampling(self, config=None):
        sampler = DataBaseSampler(
            root_path=self.root_path,
            sampler_cfg=config,
            class_names=self.class_names,
            logger=self.logger,
        )
        return sampler

    def random_world_flip(self, config=None):
        def _apply(data_dict, rng, config=config):
            gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
            for axis in config["ALONG_AXIS_LIST"]:
                fn = (
                    augmentor_utils.random_flip_along_x
                    if axis == "x"
                    else augmentor_utils.random_flip_along_y
                )
                gt_boxes, points = fn(gt_boxes, points, rng)
            data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
            return data_dict

        return _apply

    def random_image_flip(self, config=None):
        """Horizontal image-space flip for camera models (CaDDN).

        Parity: reference data_augmentor.py:82-99 +
        augmentor_utils.random_image_flip_horizontal:98-122 — 50%
        chance; flips image + depth map left-right and mirrors the 3D
        centroids in IMAGE space (project → u := W-u → unproject at the
        same depth), yaw := -yaw. Deviation (documented): we also
        mirror gt_boxes2d (u range swap) — the reference leaves them
        stale, which mis-weights its depth-loss foreground balancer on
        flipped frames.
        """

        def _apply(data_dict, rng, config=config):
            for axis in config["ALONG_AXIS_LIST"]:
                assert axis == "horizontal"
            if not rng.choice([False, True]):
                return data_dict
            image = data_dict["images"]
            calib = data_dict["calib"]
            w = image.shape[1]
            data_dict["images"] = np.fliplr(image)
            data_dict["depth_maps"] = np.fliplr(data_dict["depth_maps"])
            gt = data_dict["gt_boxes"].copy()
            if gt.shape[0]:
                img_pts, img_depth = calib.lidar_to_img(gt[:, :3])
                img_pts[:, 0] = w - img_pts[:, 0]
                pts_rect = calib.img_to_rect(
                    u=img_pts[:, 0], v=img_pts[:, 1], depth_rect=img_depth
                )
                gt[:, :3] = calib.rect_to_lidar(pts_rect)
                gt[:, 6] = -gt[:, 6]
            data_dict["gt_boxes"] = gt
            if "gt_boxes2d" in data_dict and len(data_dict["gt_boxes2d"]):
                b2d = data_dict["gt_boxes2d"].copy()
                b2d[:, [0, 2]] = w - b2d[:, [2, 0]]
                data_dict["gt_boxes2d"] = b2d
            return data_dict

        return _apply

    def random_world_rotation(self, config=None):
        def _apply(data_dict, rng, config=config):
            rot_range = config["WORLD_ROT_ANGLE"]
            if not isinstance(rot_range, (list, tuple)):
                rot_range = [-rot_range, rot_range]
            gt_boxes, points = augmentor_utils.global_rotation(
                data_dict["gt_boxes"], data_dict["points"], rot_range, rng
            )
            data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
            return data_dict

        return _apply

    def random_world_scaling(self, config=None):
        def _apply(data_dict, rng, config=config):
            gt_boxes, points = augmentor_utils.global_scaling(
                data_dict["gt_boxes"], data_dict["points"],
                config["WORLD_SCALE_RANGE"], rng,
            )
            data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
            return data_dict

        return _apply

    def random_world_translation(self, config=None):
        def _apply(data_dict, rng, config=config):
            stds = config.get("NOISE_TRANSLATE_STD", [0, 0, 0])
            if not isinstance(stds, (list, tuple)):
                stds = [stds] * 3
            gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
            for axis, std in enumerate(stds):
                if std > 0:
                    gt_boxes, points = (
                        augmentor_utils.random_translation_along_axis(
                            gt_boxes, points, std, axis, rng
                        )
                    )
            data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
            return data_dict

        return _apply

    def random_local_rotation(self, config=None):
        def _apply(data_dict, rng, config=config):
            rot_range = config["LOCAL_ROT_ANGLE"]
            if not isinstance(rot_range, (list, tuple)):
                rot_range = [-rot_range, rot_range]
            gt_boxes, points = augmentor_utils.random_local_rotation(
                data_dict["gt_boxes"], data_dict["points"], rot_range, rng
            )
            data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
            return data_dict

        return _apply

    def random_local_scaling(self, config=None):
        def _apply(data_dict, rng, config=config):
            gt_boxes, points = augmentor_utils.random_local_scaling(
                data_dict["gt_boxes"], data_dict["points"],
                config["LOCAL_SCALE_RANGE"], rng,
            )
            data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
            return data_dict

        return _apply

    def random_local_translation(self, config=None):
        def _apply(data_dict, rng, config=config):
            rng_range = config.get("LOCAL_TRANSLATION_RANGE", [0, 0.25])
            gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
            for axis_name in config.get("ALONG_AXIS_LIST", ["x", "y"]):
                axis = {"x": 0, "y": 1, "z": 2}[axis_name]
                gt_boxes, points = augmentor_utils.random_local_translation(
                    gt_boxes, points, rng_range, axis, rng
                )
            data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
            return data_dict

        return _apply

    def random_world_frustum_dropout(self, config=None):
        def _apply(data_dict, rng, config=config):
            gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
            for direction in config.get(
                "DIRECTION", ["top", "bottom", "left", "right"]
            ):
                gt_boxes, points = augmentor_utils.global_frustum_dropout(
                    gt_boxes, points,
                    config.get("INTENSITY_RANGE", [0, 0.2]), rng,
                    direction=direction,
                )
            data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
            return data_dict

        return _apply

    def random_local_pyramid_dropout(self, config=None):
        def _apply(data_dict, rng, config=config):
            names = data_dict["gt_names"]
            # 'all' applies ONE draw over the full box set (reference
            # local_pyramid_dropout operates on all gt_boxes at once,
            # augmentor_utils.py:496-520) — per-class re-application
            # would double-augment multi-class scenes
            for cls, m in _pyramid_groups(config, names):
                p = float(config[cls]["PROB"])
                _, data_dict["points"] = augmentor_utils.local_pyramid_dropout(
                    data_dict["gt_boxes"][m], data_dict["points"], p, rng
                )
            return data_dict

        return _apply

    def random_local_pyramid_sparsify(self, config=None):
        def _apply(data_dict, rng, config=config):
            names = data_dict["gt_names"]
            for cls, m in _pyramid_groups(config, names):
                p = float(config[cls]["PROB"])
                max_num = int(config[cls]["MAX_NUM"])
                _, data_dict["points"] = (
                    augmentor_utils.local_pyramid_sparsify(
                        data_dict["gt_boxes"][m], data_dict["points"],
                        p, max_num, rng,
                    )
                )
            return data_dict

        return _apply

    def random_local_pyramid_swap(self, config=None):
        def _apply(data_dict, rng, config=config):
            names = data_dict["gt_names"]
            for cls, m in _pyramid_groups(config, names):
                p = float(config[cls]["PROB"])
                max_num = int(config[cls]["MAX_NUM"])
                _, data_dict["points"] = augmentor_utils.local_pyramid_swap(
                    data_dict["gt_boxes"][m], data_dict["points"],
                    p, max_num, rng,
                )
            return data_dict

        return _apply

    def random_local_pyramid_aug(self, config=None):
        """Composite dropout → sparsify → swap (reference
        data_augmentor.py:252-261)."""
        drop = self.random_local_pyramid_dropout(config=config["DROPOUT"])
        sparse = self.random_local_pyramid_sparsify(
            config=config["SPARSIFY"]
        )
        swap = self.random_local_pyramid_swap(config=config["SWAP"])

        def _apply(data_dict, rng):
            return swap(sparse(drop(data_dict, rng), rng), rng)

        return _apply

    def random_make_slope_in_scene(self, config=None):
        """SlopeAug (reference data_augmentor.py:265-282): with
        probability PROB, synthesize a sloped region; gt boxes become
        9-dim either way."""

        def _apply(data_dict, rng, config=config):
            gt_boxes, points = data_dict["gt_boxes"], data_dict["points"]
            if gt_boxes.shape[1] < 9:
                gt_boxes = np.concatenate(
                    [gt_boxes, np.zeros((gt_boxes.shape[0], 2))], axis=1
                )
            if rng.random_sample() < config.get("PROB", 0.5):
                params = (
                    config.get("DIST_MEAN", 20.0),
                    config.get("DIST_VAR", 10.0),
                    np.deg2rad(config.get("ANGLE_MEAN", 20.0)),
                    np.deg2rad(config.get("ANGLE_VAR", 8.0)),
                )
                gt_boxes, points, rp, ra = (
                    augmentor_utils.random_global_make_slope(
                        gt_boxes, points, params, rng,
                        smooth=config.get("SMOOTH", False),
                    )
                )
                data_dict["slope_plane"] = np.concatenate([rp, ra])
            data_dict["gt_boxes"], data_dict["points"] = gt_boxes, points
            return data_dict

        return _apply

    # -----------------------------------------------------------------------
    def forward(self, data_dict, rng=None):
        rng = rng or np.random.RandomState()
        for aug in self.data_augmentor_queue:
            if isinstance(aug, DataBaseSampler):
                data_dict = aug(data_dict, rng)
            else:
                data_dict = aug(data_dict, rng)
        if "gt_boxes" in data_dict and data_dict["gt_boxes"].shape[0]:
            data_dict["gt_boxes"][:, 6] = limit_period(
                data_dict["gt_boxes"][:, 6], offset=0.5, period=2 * np.pi
            )
        return data_dict
