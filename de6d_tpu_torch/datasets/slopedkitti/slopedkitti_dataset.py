"""SlopedKITTI dataset adapter, full-pose labels (counterpart of
``de6d_tpu/datasets/slopedkitti/slopedkitti_dataset.py``, a copy of its
numpy code).

The KITTI layout, but: 17-field labels with the camera pitch and roll
(``object3d_kitti.ObjectPose3d``), ``slope_planes/`` hinge-parameter
files, 9-DoF ``gt_boxes_lidar`` [..., yaw, pitch, roll], predictions
that carry pitch and roll, a 17-column result txt, and the SlopedKITTI
protocol (``eval/slopedkitti_eval.py``).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ...registry import DATASETS
from ...utils import box_np_ops, object3d_kitti
from ..eval.slopedkitti_eval import get_slopedkitti_eval_result
from ..kitti.kitti_dataset import KittiDataset


@DATASETS.register
class SlopedKittiDataset(KittiDataset):
    LABEL_PARSER = staticmethod(object3d_kitti.get_objects3d_from_label)
    GT_NDIM = 9

    def get_slope_plane(self, idx):
        """Hinge parameters [point(3), rotation vector(3)] written by the
        generator; zeros where a frame has none."""
        f = self.root_split_path / "slope_planes" / f"{idx}.txt"
        if not f.exists():
            return np.zeros(6, np.float32)
        return np.loadtxt(str(f)).astype(np.float32).reshape(-1)[:6]

    def _annotations_from_objects(self, obj_list, calib):
        annotations, num_objects = super()._annotations_from_objects(
            obj_list, calib
        )
        annotations["pitch"] = np.array(
            [getattr(o, "rx", 0.0) for o in obj_list]
        )
        annotations["roll"] = np.array(
            [getattr(o, "rz", 0.0) for o in obj_list]
        )
        # extend the lidar boxes to 9-DoF
        gt7 = annotations["gt_boxes_lidar"]
        pitch = annotations["pitch"][: gt7.shape[0], None]
        roll = annotations["roll"][: gt7.shape[0], None]
        annotations["gt_boxes_lidar"] = np.concatenate(
            [gt7, pitch, roll], axis=1
        ).astype(np.float32)
        return annotations, num_objects

    def generate_prediction_dicts(self, batch_dict, pred_dicts, class_names,
                                  output_path=None):
        annos = super().generate_prediction_dicts(
            batch_dict, pred_dicts, class_names, output_path=None
        )
        for index, (anno, box_dict) in enumerate(zip(annos, pred_dicts)):
            boxes = np.asarray(box_dict["pred_boxes"])
            n = boxes.shape[0]
            anno["pitch"] = (
                boxes[:, 7] if n and boxes.shape[1] >= 9 else np.zeros(n)
            )
            anno["roll"] = (
                boxes[:, 8] if n and boxes.shape[1] >= 9 else np.zeros(n)
            )
            if output_path is not None:
                self._write_slopedkitti_txt(
                    Path(output_path), anno["frame_id"], anno
                )
        return annos

    @staticmethod
    def _write_slopedkitti_txt(output_path, frame_id, d):
        """17-column result txt: the KITTI columns with pitch and roll
        before the score."""
        with open(output_path / f"{frame_id}.txt", "w") as f:
            for i in range(len(d["bbox"])):
                bbox, loc, dims = d["bbox"][i], d["location"][i], d["dimensions"][i]
                print(
                    "%s -1 -1 %.4f %.4f %.4f %.4f %.4f %.4f %.4f %.4f "
                    "%.4f %.4f %.4f %.4f %.4f %.4f %.4f"
                    % (
                        d["name"][i], d["alpha"][i],
                        bbox[0], bbox[1], bbox[2], bbox[3],
                        dims[1], dims[2], dims[0],
                        loc[0], loc[1], loc[2],
                        d["rotation_y"][i], d["pitch"][i], d["roll"][i],
                        d["score"][i],
                    ),
                    file=f,
                )

    def evaluation(self, det_annos, class_names, **kwargs):
        if not self.kitti_infos or "annos" not in self.kitti_infos[0]:
            return None, {}
        import copy

        eval_det = copy.deepcopy(det_annos)
        for a in eval_det:
            a.setdefault("pitch", np.zeros(len(a["name"])))
            a.setdefault("roll", np.zeros(len(a["name"])))
        eval_gt = [copy.deepcopy(i["annos"]) for i in self.kitti_infos]
        return get_slopedkitti_eval_result(eval_gt, eval_det, class_names)
