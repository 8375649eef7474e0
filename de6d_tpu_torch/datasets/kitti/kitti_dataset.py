"""KITTI dataset adapter.

Parity: reference datasets/kitti/kitti_dataset.py:13-483 — infos pkl
ingest, calib/label/plane IO, FOV filtering (:407-413), camera→lidar
gt boxes (:393-394), prediction-dict generation (lidar→camera→image,
KITTI txt output), official eval hookup (:355-363), info generation
(:150) and gt-database creation (:224).
"""

from __future__ import annotations

import pickle
from pathlib import Path

import numpy as np

from ...registry import DATASETS
from ...utils import box_np_ops, calibration_kitti, object3d_kitti
from ...utils.common_utils import drop_info_with_name
from ..dataset import DatasetTemplate


@DATASETS.register
class KittiDataset(DatasetTemplate):
    LABEL_PARSER = staticmethod(object3d_kitti.get_objects_from_label)
    GT_NDIM = 7

    def __init__(self, dataset_cfg, class_names, training=True,
                 root_path=None, logger=None):
        super().__init__(
            dataset_cfg=dataset_cfg, class_names=class_names,
            training=training, root_path=root_path, logger=logger,
        )
        self.split = dataset_cfg["DATA_SPLIT"][self.mode]
        self.root_split_path = self.root_path / (
            "training" if self.split != "test" else "testing"
        )
        split_file = self.root_path / "ImageSets" / f"{self.split}.txt"
        self.sample_id_list = (
            [x.strip() for x in open(split_file).readlines()]
            if split_file.exists()
            else []
        )
        self.kitti_infos = []
        self.include_kitti_data(self.mode)

    def include_kitti_data(self, mode):
        infos = []
        for info_path in self.dataset_cfg["INFO_PATH"][mode]:
            path = self.root_path / info_path
            if not path.exists():
                if self.logger:
                    self.logger.warning(f"info file missing: {path}")
                continue
            with open(path, "rb") as f:
                infos.extend(pickle.load(f))
        self.kitti_infos = infos
        if self.logger:
            self.logger.info(f"KITTI {mode}: {len(infos)} samples")

    # ----------------------------------------------------------------- IO --
    def get_lidar(self, idx):
        f = self.root_split_path / "velodyne" / f"{idx}.bin"
        return np.fromfile(str(f), dtype=np.float32).reshape(-1, 4)

    def get_calib(self, idx):
        return calibration_kitti.Calibration(
            self.root_split_path / "calib" / f"{idx}.txt"
        )

    def get_label(self, idx):
        return self.LABEL_PARSER(
            self.root_split_path / "label_2" / f"{idx}.txt"
        )

    def get_road_plane(self, idx):
        f = self.root_split_path / "planes" / f"{idx}.txt"
        if not f.exists():
            return None
        with open(f, "r") as fh:
            lines = fh.readlines()
        plane = np.asarray([float(x) for x in lines[3].split()])
        if plane[1] > 0:
            plane = -plane
        return plane / np.linalg.norm(plane[0:3])

    def get_image(self, idx, img_shape):
        """RGB image normalized to [0, 1] float32 (reference
        kitti_dataset.py get_image: imread/255). The synthetic tree has
        no camera renders — fall back to zeros at the calib image shape
        so the CaDDN pipeline stays drivable end to end."""
        f = self.root_split_path / "image_2" / f"{idx}.png"
        if f.exists():
            from PIL import Image

            img = np.asarray(Image.open(f).convert("RGB"), np.float32)
            return img / 255.0
        return np.zeros((int(img_shape[0]), int(img_shape[1]), 3), np.float32)

    def get_depth_map(self, idx, calib, img_shape, points):
        """Sparse LiDAR depth map (reference kitti_dataset.py
        get_depth_map reads depth_2/<idx>.png / 256). When no depth png
        exists we build it the way the KITTI depth maps are built in
        the first place: project the scan through the calib and
        z-buffer the per-pixel minimum camera depth."""
        f = self.root_split_path / "depth_2" / f"{idx}.png"
        if f.exists():
            from PIL import Image

            return np.asarray(Image.open(f), np.float32) / 256.0
        h, w = int(img_shape[0]), int(img_shape[1])
        depth = np.full((h, w), 0.0, np.float32)
        pts_rect = calib.lidar_to_rect(points[:, :3])
        pts_img, pts_depth = calib.rect_to_img(pts_rect)
        u = np.round(pts_img[:, 0]).astype(np.int64)
        v = np.round(pts_img[:, 1]).astype(np.int64)
        ok = (u >= 0) & (u < w) & (v >= 0) & (v < h) & (pts_depth > 0)
        u, v, d = u[ok], v[ok], pts_depth[ok]
        buf = np.full(h * w, np.inf, np.float32)
        np.minimum.at(buf, v * w + u, d)
        hit = np.isfinite(buf)
        depth.reshape(-1)[hit] = buf[hit]
        return depth

    @staticmethod
    def calib_to_matricies(calib):
        """(trans_lidar_to_cam (4,4), trans_cam_to_img (3,4)) — parity:
        reference kitti_utils.calib_to_matricies."""
        v2c = np.vstack([calib.V2C, [0, 0, 0, 1]]).astype(np.float32)
        r0 = np.eye(4, dtype=np.float32)
        r0[:3, :3] = calib.R0
        return r0 @ v2c, calib.P2.astype(np.float32)

    def get_image_shape(self, idx):
        import struct

        f = self.root_split_path / "image_2" / f"{idx}.png"
        if not f.exists():
            return np.array([375, 1242], dtype=np.int32)
        with open(f, "rb") as fh:
            head = fh.read(26)
        w, h = struct.unpack(">II", head[16:24])
        return np.array([h, w], dtype=np.int32)

    @staticmethod
    def get_fov_flag(pts_rect, img_shape, calib):
        """Points visible in the camera image (reference :407-413)."""
        pts_img, pts_depth = calib.rect_to_img(pts_rect)
        flag = (
            (pts_img[:, 0] >= 0) & (pts_img[:, 0] < img_shape[1])
            & (pts_img[:, 1] >= 0) & (pts_img[:, 1] < img_shape[0])
            & (pts_depth >= 0)
        )
        return flag

    # ------------------------------------------------------------- infos --
    def _annotations_from_objects(self, obj_list, calib):
        annotations = {
            "name": np.array([o.cls_type for o in obj_list]),
            "truncated": np.array([o.truncation for o in obj_list]),
            "occluded": np.array([o.occlusion for o in obj_list]),
            "alpha": np.array([o.alpha for o in obj_list]),
            "bbox": (
                np.stack([o.box2d for o in obj_list])
                if obj_list else np.zeros((0, 4))
            ),
            "dimensions": np.array([[o.l, o.h, o.w] for o in obj_list]).reshape(-1, 3),
            "location": (
                np.stack([o.loc for o in obj_list])
                if obj_list else np.zeros((0, 3))
            ),
            "rotation_y": np.array([o.ry for o in obj_list]),
            "score": np.array([o.score for o in obj_list]),
            "difficulty": np.array([o.level for o in obj_list], np.int32),
        }
        num_objects = len(
            [o for o in obj_list if o.cls_type != "DontCare"]
        )
        num_gt = len(obj_list)
        annotations["index"] = np.array(
            list(range(num_objects)) + [-1] * (num_gt - num_objects),
            dtype=np.int32,
        )
        loc = annotations["location"][:num_objects]
        dims = annotations["dimensions"][:num_objects]
        rots = annotations["rotation_y"][:num_objects]
        loc_lidar = calib.rect_to_lidar(loc) if num_objects else np.zeros((0, 3))
        l, h, w = dims[:, 0:1], dims[:, 1:2], dims[:, 2:3]
        if num_objects:
            loc_lidar[:, 2] += h[:, 0] / 2
        gt_boxes_lidar = np.concatenate(
            [loc_lidar, l, w, h, -(np.pi / 2 + rots[..., None])], axis=1
        )
        annotations["gt_boxes_lidar"] = gt_boxes_lidar.astype(np.float32)
        return annotations, num_objects

    def get_infos(self, num_workers=4, has_label=True, count_inside_pts=True,
                  sample_id_list=None):
        from concurrent.futures import ThreadPoolExecutor

        sample_id_list = sample_id_list or self.sample_id_list

        def process(sample_idx):
            info = {
                "point_cloud": {
                    "num_features": 4, "lidar_idx": sample_idx,
                },
                "image": {
                    "image_idx": sample_idx,
                    "image_shape": self.get_image_shape(sample_idx),
                },
            }
            calib_obj = self.get_calib(sample_idx)
            info["calib"] = {
                "P2": calib_obj.P2, "R0_rect": calib_obj.R0,
                "Tr_velo_to_cam": calib_obj.V2C,
            }
            if has_label:
                obj_list = self.get_label(sample_idx)
                annotations, num_objects = self._annotations_from_objects(
                    obj_list, calib_obj
                )
                info["annos"] = annotations
                if count_inside_pts:
                    points = self.get_lidar(sample_idx)
                    pts_rect = calib_obj.lidar_to_rect(points[:, 0:3])
                    fov_flag = self.get_fov_flag(
                        pts_rect, info["image"]["image_shape"], calib_obj
                    )
                    pts = points[fov_flag]
                    gt = annotations["gt_boxes_lidar"]
                    corners = (
                        box_np_ops.boxes9d_to_corners_3d(gt)
                        if gt.shape[1] >= 9
                        else box_np_ops.boxes_to_corners_3d(gt)
                    )
                    num_in = -np.ones(len(obj_list), np.int32)
                    for k in range(gt.shape[0]):
                        box9 = (
                            gt[k] if gt.shape[1] >= 9
                            else np.concatenate([gt[k], [0, 0]])
                        )
                        num_in[k] = int(
                            box_np_ops.in_hull_obb(pts[:, :3], box9).sum()
                        )
                    annotations["num_points_in_gt"] = num_in
            return info

        with ThreadPoolExecutor(num_workers) as pool:
            infos = list(pool.map(process, sample_id_list))
        return infos

    def create_groundtruth_database(self, info_path, used_classes=None,
                                    split="train", packed=False):
        """Cut gt objects out of scenes into a sampling database
        (reference :224-282). With ``packed`` also write a single
        ``kitti_gt_database_{split}_global.npy`` with per-object
        ``global_data_offset`` entries — the layout the reference's
        shared-memory path consumes (database_sampler.py:71-86)."""
        db_path = self.root_path / f"gt_database_{split}" \
            if split != "train" else self.root_path / "gt_database"
        db_info_save_path = self.root_path / f"kitti_dbinfos_{split}.pkl"
        db_path.mkdir(parents=True, exist_ok=True)
        all_db_infos = {}
        packed_chunks = []
        packed_offset = 0
        with open(info_path, "rb") as f:
            infos = pickle.load(f)
        for info in infos:
            sample_idx = info["point_cloud"]["lidar_idx"]
            points = self.get_lidar(sample_idx)
            annos = info["annos"]
            gt_boxes = annos["gt_boxes_lidar"]
            names = annos["name"]
            difficulty = annos["difficulty"]
            for i in range(gt_boxes.shape[0]):
                if used_classes is not None and names[i] not in used_classes:
                    continue
                box9 = (
                    gt_boxes[i]
                    if gt_boxes.shape[1] >= 9
                    else np.concatenate([gt_boxes[i], [0, 0]])
                )
                mask = box_np_ops.in_hull_obb(points[:, :3], box9)
                gt_points = points[mask].copy()
                gt_points[:, :3] -= gt_boxes[i, :3]
                filename = f"{sample_idx}_{names[i]}_{i}.bin"
                filepath = db_path / filename
                gt_points.astype(np.float32).tofile(filepath)
                db_info = {
                    "name": names[i],
                    "path": str(filepath.relative_to(self.root_path)),
                    "image_idx": sample_idx,
                    "gt_idx": i,
                    "box3d_lidar": gt_boxes[i],
                    "num_points_in_gt": int(mask.sum()),
                    "difficulty": int(difficulty[i]),
                }
                if packed:
                    db_info["global_data_offset"] = packed_offset
                    packed_chunks.append(gt_points.astype(np.float32))
                    packed_offset += gt_points.shape[0]
                all_db_infos.setdefault(names[i], []).append(db_info)
        if packed:
            data = (
                np.concatenate(packed_chunks, axis=0)
                if packed_chunks
                else np.zeros((0, 4), np.float32)
            )
            np.save(
                self.root_path / f"kitti_gt_database_{split}_global.npy",
                data,
            )
        with open(db_info_save_path, "wb") as f:
            pickle.dump(all_db_infos, f)
        return db_info_save_path

    # --------------------------------------------------------- getitem ----
    def __len__(self):
        return len(self.kitti_infos)

    def getitem_prepared(self, index, rng=None, turn=None):
        info = self.kitti_infos[index]
        sample_idx = info["point_cloud"]["lidar_idx"]
        img_shape = info["image"]["image_shape"]
        calib = calibration_kitti.Calibration(
            {
                "P2": info["calib"]["P2"][:3, :4]
                if info["calib"]["P2"].shape == (4, 4)
                else info["calib"]["P2"],
                "P3": info["calib"].get("P3", info["calib"]["P2"]),
                "R0": info["calib"]["R0_rect"][:3, :3]
                if info["calib"]["R0_rect"].shape == (4, 4)
                else info["calib"]["R0_rect"],
                "Tr_velo2cam": info["calib"]["Tr_velo_to_cam"][:3, :4]
                if info["calib"]["Tr_velo_to_cam"].shape == (4, 4)
                else info["calib"]["Tr_velo_to_cam"],
            }
        )
        points = self.get_lidar(sample_idx)
        if self.dataset_cfg.get("FOV_POINTS_ONLY", True):
            pts_rect = calib.lidar_to_rect(points[:, 0:3])
            points = points[self.get_fov_flag(pts_rect, img_shape, calib)]

        input_dict = {
            "points": points,
            "frame_id": sample_idx,
            "calib": calib,
            "image_shape": img_shape,
        }
        get_item_list = self.dataset_cfg.get("GET_ITEM_LIST", ["points"])
        # camera items for CaDDN (reference kitti_dataset.py
        # get_item_list dispatch; "calib_matricies" spelling kept for
        # config parity with the reference)
        if "images" in get_item_list:
            input_dict["images"] = self.get_image(sample_idx, img_shape)
        if "depth_maps" in get_item_list:
            input_dict["depth_maps"] = self.get_depth_map(
                sample_idx, calib, img_shape, points
            )
        if "calib_matricies" in get_item_list:
            (
                input_dict["trans_lidar_to_cam"],
                input_dict["trans_cam_to_img"],
            ) = self.calib_to_matricies(calib)
        if "annos" in info:
            annos = drop_info_with_name(info["annos"], name="DontCare")
            input_dict["gt_names"] = annos["name"]
            input_dict["gt_boxes"] = annos["gt_boxes_lidar"]
            if "gt_boxes2d" in get_item_list:
                input_dict["gt_boxes2d"] = annos["bbox"].astype(np.float32)
            if "road_plane" in self.dataset_cfg.get("GET_ITEM_LIST", []):
                plane = self.get_road_plane(sample_idx)
                if plane is not None:
                    input_dict["road_plane"] = plane

        data_dict = self.prepare_data(input_dict, rng, turn=turn)
        if data_dict is None:
            return None
        data_dict["image_shape"] = img_shape
        # calib stays: collate passes it through per-sample and
        # generate_prediction_dicts needs it for the lidar→camera
        # transform (the bug only fired once a TRAINED model produced
        # detections — untrained smokes short-circuit at n == 0)
        data_dict.pop("use_lead_xyz", None)
        data_dict.pop("road_plane", None)
        data_dict["frame_id"] = sample_idx
        return data_dict

    def __getitem__(self, index):
        out = self.getitem_prepared(index)
        if out is None:  # re-draw (reference dataset.py:152-154)
            return self.__getitem__(np.random.randint(len(self)))
        return out

    # --------------------------------------------------- predictions/eval --
    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        """Host-side: fixed-size device outputs → per-frame KITTI annos
        (reference :299-379). pred_dicts: list of per-sample dicts with
        numpy pred_boxes/scores/labels already truncated to count."""

        def template(n, lidar_dim=7):
            return {
                "name": np.zeros(n), "truncated": np.zeros(n),
                "occluded": np.zeros(n), "alpha": np.zeros(n),
                "bbox": np.zeros([n, 4]), "dimensions": np.zeros([n, 3]),
                "location": np.zeros([n, 3]), "rotation_y": np.zeros(n),
                "score": np.zeros(n), "boxes_lidar": np.zeros([n, lidar_dim]),
            }

        annos = []
        for index, box_dict in enumerate(pred_dicts):
            frame_id = batch_dict["frame_id"][index]
            pred_boxes = np.asarray(box_dict["pred_boxes"])
            pred_scores = np.asarray(box_dict["pred_scores"])
            pred_labels = np.asarray(box_dict["pred_labels"])
            n = pred_boxes.shape[0]
            single = template(n, pred_boxes.shape[1] if n else 7)
            if n:
                calib = batch_dict["calib"][index]
                image_shape = batch_dict["image_shape"][index]
                boxes_cam = box_np_ops.boxes3d_lidar_to_kitti_camera(
                    pred_boxes[:, :7], calib
                )
                boxes_img = box_np_ops.boxes3d_kitti_camera_to_imageboxes(
                    boxes_cam, calib, image_shape=image_shape
                )
                single["name"] = np.array(class_names)[pred_labels - 1]
                single["alpha"] = (
                    -np.arctan2(-pred_boxes[:, 1], pred_boxes[:, 0])
                    + boxes_cam[:, 6]
                )
                single["bbox"] = boxes_img
                single["dimensions"] = boxes_cam[:, 3:6]
                single["location"] = boxes_cam[:, 0:3]
                single["rotation_y"] = boxes_cam[:, 6]
                single["score"] = pred_scores
                single["boxes_lidar"] = pred_boxes
            single["frame_id"] = frame_id
            annos.append(single)
            if output_path is not None:
                self._write_kitti_txt(Path(output_path), frame_id, single)
        return annos

    @staticmethod
    def _write_kitti_txt(output_path, frame_id, d):
        with open(output_path / f"{frame_id}.txt", "w") as f:
            for i in range(len(d["bbox"])):
                bbox, loc, dims = d["bbox"][i], d["location"][i], d["dimensions"][i]
                print(
                    "%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f "
                    "%.4f %.4f %.4f %.4f %.4f"
                    % (
                        d["name"][i], d["alpha"][i],
                        bbox[0], bbox[1], bbox[2], bbox[3],
                        dims[1], dims[2], dims[0],
                        loc[0], loc[1], loc[2],
                        d["rotation_y"][i], d["score"][i],
                    ),
                    file=f,
                )

    def evaluation(self, det_annos, class_names, **kwargs):
        if not self.kitti_infos or "annos" not in self.kitti_infos[0]:
            return None, {}
        from ..eval import kitti_eval

        import copy

        eval_det = copy.deepcopy(det_annos)
        eval_gt = [
            copy.deepcopy(info["annos"]) for info in self.kitti_infos
        ]
        ap_result_str, ap_dict = kitti_eval.get_official_eval_result(
            eval_gt, eval_det, class_names
        )
        return ap_result_str, ap_dict
