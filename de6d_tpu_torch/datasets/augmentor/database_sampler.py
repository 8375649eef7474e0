"""GT-database paste augmentation (host-side).

Parity: reference datasets/augmentor/database_sampler.py:9-248 —
samples cut-out objects from a pickled gt database, rejects samples
whose BEV rotated IoU with existing/accepted boxes is nonzero
(:232-236), optionally snaps z to the road plane (:137-154), removes
scene points inside pasted boxes (:195-199), and appends object points.

Shared-memory cache: with USE_SHARED_MEMORY + DB_DATA_PATH the packed
gt-point array is published once per host through the stdlib
``multiprocessing.shared_memory`` (replacing the reference's
SharedArray /dev/shm blobs, database_sampler.py:71-86) and every
loader worker indexes it by ``global_data_offset`` instead of reading
per-object .bin files.
Per-sampler RandomState instead of global np.random.
"""

from __future__ import annotations

import hashlib
import pickle
from pathlib import Path

import numpy as np

from ..eval.rotate_iou_np import boxes_bev_iou_cpu
from ...utils import box_np_utils


def _unlink_quietly(shm):
    try:
        shm.close()
        shm.unlink()
    except Exception:
        pass


class DataBaseSampler:
    def __init__(self, root_path, sampler_cfg, class_names, logger=None):
        self.root_path = Path(root_path)
        self.sampler_cfg = sampler_cfg
        self.class_names = class_names
        self.logger = logger
        self.db_infos = {c: [] for c in class_names}

        for db_info_path in sampler_cfg["DB_INFO_PATH"]:
            path = self.root_path / db_info_path
            if not path.exists():
                if logger:
                    logger.warning(f"gt database infos missing: {path}")
                continue
            with open(path, "rb") as f:
                infos = pickle.load(f)
            for cls in class_names:
                if cls in infos:
                    self.db_infos[cls].extend(infos[cls])

        for func_name, val in sampler_cfg.get("PREPARE", {}).items():
            self.db_infos = getattr(self, func_name)(self.db_infos, val)

        self.use_shared_memory = bool(
            sampler_cfg.get("USE_SHARED_MEMORY", False)
        )
        self._shm = None
        self.gt_database_data = None
        if self.use_shared_memory:
            self.gt_database_data = self._load_db_to_shared_memory()

        self.use_road_plane = sampler_cfg.get("USE_ROAD_PLANE", False)
        self.limit_whole_scene = sampler_cfg.get("LIMIT_WHOLE_SCENE", False)
        self.sample_groups = {}
        self.sample_class_num = {}
        for group in sampler_cfg["SAMPLE_GROUPS"]:
            cls, num = group.split(":")
            if cls in class_names:
                self.sample_class_num[cls] = int(num)
                self.sample_groups[cls] = {
                    "sample_num": int(num),
                    "pointer": len(self.db_infos.get(cls, [])),
                    "indices": np.arange(len(self.db_infos.get(cls, []))),
                }

    # -- pickling (the loader's child process gets the sampler so) --------
    def __getstate__(self):
        # the shared segment is attached anew, not copied
        state = self.__dict__.copy()
        state["_shm"] = state["gt_database_data"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        if self.use_shared_memory:
            self.gt_database_data = self._load_db_to_shared_memory()

    def _load_db_to_shared_memory(self):
        """Publish the packed gt-point npy once per host (reference
        load_db_to_shared_memory :71-86, SharedArray → stdlib
        shared_memory)."""
        from multiprocessing import shared_memory

        db_data_path = (
            self.root_path / self.sampler_cfg["DB_DATA_PATH"][0]
        )
        # one segment per file and version of it: another checkout's
        # database (or this one rewritten) never attaches to this one's
        st = db_data_path.resolve().stat()
        key = "de6d_torch_" + hashlib.sha1(
            f"{db_data_path.resolve()}:{st.st_size}:{st.st_mtime_ns}".encode()
        ).hexdigest()[:20]
        try:
            shm = shared_memory.SharedMemory(name=key)
            created = False
        except FileNotFoundError:
            data = np.load(db_data_path)
            try:
                shm = shared_memory.SharedMemory(
                    name=key, create=True, size=max(data.nbytes, 1)
                )
                created = True
            except FileExistsError:
                # two processes raced past the attach; loser attaches
                # to the winner's segment
                shm = shared_memory.SharedMemory(name=key)
                created = False
            if created:
                buf = np.ndarray(data.shape, data.dtype, buffer=shm.buf)
                buf[:] = data
                import atexit

                # the creating process owns cleanup: unlink at exit so
                # /dev/shm doesn't leak across runs
                atexit.register(lambda s=shm: _unlink_quietly(s))
        if created:
            self._shape_dtype = (data.shape, data.dtype)
        else:
            # shape rides in a sidecar (attachers can't infer it)
            data = np.load(db_data_path, mmap_mode="r")
            self._shape_dtype = (data.shape, data.dtype)
        self._shm = shm
        if self.logger:
            self.logger.info(
                f"gt database {'published to' if created else 'attached from'}"
                f" shared memory ({key})"
            )
        arr = np.ndarray(
            self._shape_dtype[0], self._shape_dtype[1], buffer=shm.buf
        )
        return arr

    # -- PREPARE filters (reference :88-110) --------------------------------
    def filter_by_difficulty(self, db_infos, removed_difficulty):
        new_db = {}
        for key, infos in db_infos.items():
            new_db[key] = [
                x for x in infos if x.get("difficulty", 0) not in removed_difficulty
            ]
        return new_db

    def filter_by_min_points(self, db_infos, min_gt_points_list):
        for spec in min_gt_points_list:
            name, num = spec.split(":")
            num = int(num)
            if name in db_infos:
                db_infos[name] = [
                    x for x in db_infos[name]
                    if x.get("num_points_in_gt", 1 << 30) >= num
                ]
        return db_infos

    # -----------------------------------------------------------------------
    def sample_with_fixed_number(self, class_name, sample_group, rng):
        """Shuffled-ring sampling without replacement (reference :112-124)."""
        sample_num = int(sample_group["sample_num"])
        pointer = sample_group["pointer"]
        indices = sample_group["indices"]
        infos = self.db_infos[class_name]
        if len(infos) == 0 or sample_num <= 0:
            return []
        if pointer + sample_num >= len(infos):
            indices = rng.permutation(len(infos))
            pointer = 0
        sampled = [infos[i] for i in indices[pointer : pointer + sample_num]]
        sample_group["pointer"] = pointer + sample_num
        sample_group["indices"] = indices
        return sampled

    def __call__(self, data_dict, rng):
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"]
        points = data_dict["points"]
        existed_boxes = gt_boxes.copy()
        total_valid_sampled = []

        for class_name, sample_group in self.sample_groups.items():
            if self.limit_whole_scene:
                num_gt = int(np.sum(gt_names == class_name))
                sample_group["sample_num"] = (
                    self.sample_class_num[class_name] - num_gt
                )
            sampled = self.sample_with_fixed_number(
                class_name, sample_group, rng
            )
            if not sampled:
                continue
            sampled_boxes = np.stack(
                [x["box3d_lidar"] for x in sampled], axis=0
            ).astype(np.float32)

            iou1 = boxes_bev_iou_cpu(sampled_boxes[:, :7], existed_boxes[:, :7]) \
                if existed_boxes.shape[0] else np.zeros((len(sampled), 0))
            iou2 = boxes_bev_iou_cpu(sampled_boxes[:, :7], sampled_boxes[:, :7])
            iou2[np.arange(len(sampled)), np.arange(len(sampled))] = 0
            keep = []
            occupied = iou1.max(axis=1) if iou1.shape[1] else np.zeros(len(sampled))
            for i in range(len(sampled)):
                if occupied[i] > 0:
                    continue
                if any(iou2[i, j] > 0 for j in keep):
                    continue
                keep.append(i)
            valid_sampled = [sampled[i] for i in keep]
            valid_boxes = sampled_boxes[keep]
            if valid_boxes.shape[0]:
                if existed_boxes.shape[1] > valid_boxes.shape[1]:
                    valid_boxes = np.pad(
                        valid_boxes,
                        ((0, 0), (0, existed_boxes.shape[1] - valid_boxes.shape[1])),
                    )
                existed_boxes = np.concatenate(
                    [existed_boxes, valid_boxes], axis=0
                )
            total_valid_sampled.extend(valid_sampled)

        sampled_gt_boxes = existed_boxes[gt_boxes.shape[0]:]
        if total_valid_sampled:
            data_dict = self.add_sampled_boxes_to_scene(
                data_dict, sampled_gt_boxes, total_valid_sampled
            )
        return data_dict

    def add_sampled_boxes_to_scene(self, data_dict, sampled_gt_boxes,
                                   total_valid_sampled):
        gt_boxes = data_dict["gt_boxes"]
        gt_names = data_dict["gt_names"]
        points = data_dict["points"]

        obj_points_list = []
        kept_rows = []
        for k, info in enumerate(total_valid_sampled):
            if self.gt_database_data is not None:
                start = int(info["global_data_offset"])
                num = int(info["num_points_in_gt"])
                obj_points = np.array(
                    self.gt_database_data[start:start + num]
                )
            else:
                file_path = self.root_path / info["path"]
                if not file_path.exists():
                    continue
                obj_points = np.fromfile(
                    str(file_path), dtype=np.float32
                ).reshape(
                    -1, self.sampler_cfg.get("NUM_POINT_FEATURES", 4)
                ).copy()
            obj_points[:, :3] += sampled_gt_boxes[k, :3].astype(np.float32)
            obj_points_list.append(obj_points)
            kept_rows.append(k)

        if not obj_points_list:
            return data_dict
        sampled_gt_boxes = sampled_gt_boxes[kept_rows]
        sampled_names = np.array(
            [total_valid_sampled[k]["name"] for k in kept_rows]
        )

        # carve out scene points inside the pasted boxes
        inside = box_np_utils.points_in_boxes_mask(
            points[:, :3], sampled_gt_boxes[:, :7]
        )
        points = points[~inside.any(axis=0)]
        obj_points = np.concatenate(obj_points_list, axis=0)
        data_dict["points"] = np.concatenate([obj_points, points], axis=0)
        if gt_boxes.shape[1] > sampled_gt_boxes.shape[1]:
            sampled_gt_boxes = np.pad(
                sampled_gt_boxes,
                ((0, 0), (0, gt_boxes.shape[1] - sampled_gt_boxes.shape[1])),
            )
        data_dict["gt_boxes"] = np.concatenate(
            [gt_boxes, sampled_gt_boxes[:, : gt_boxes.shape[1]]], axis=0
        )
        data_dict["gt_names"] = np.concatenate([gt_names, sampled_names])
        return data_dict
