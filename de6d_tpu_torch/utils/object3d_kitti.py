"""KITTI label parsing: 15/16-field standard labels and the 17/18-field
full-pose SlopedKITTI labels.

Parity: reference utils/object3d_kitti.py (Object3d :19, ObjectPose3d
:94-114). Field layouts are fixed by the KITTI txt format:
  type trunc occl alpha bbox(4) h w l x y z ry [score]
SlopedKITTI appends pitch(rx_cam) and roll(rz_cam) after ry:
  ... ry pitch roll [score]
"""

from __future__ import annotations

import numpy as np

CLS_TYPE_TO_ID = {"Car": 1, "Pedestrian": 2, "Cyclist": 3, "Van": 4}


def _difficulty(box2d, truncation, occlusion):
    height = float(box2d[3]) - float(box2d[1]) + 1
    if height >= 40 and truncation <= 0.15 and occlusion <= 0:
        return 0, "Easy"
    if height >= 25 and truncation <= 0.3 and occlusion <= 1:
        return 1, "Moderate"
    if height >= 25 and truncation <= 0.5 and occlusion <= 2:
        return 2, "Hard"
    return -1, "UnKnown"


class Object3d:
    """15/16-field KITTI label line."""

    POSE_FIELDS = 0  # extra pose angles after ry

    def __init__(self, line):
        label = line.strip().split(" ")
        self.src = line
        self.cls_type = label[0]
        self.cls_id = CLS_TYPE_TO_ID.get(self.cls_type, -1)
        self.truncation = float(label[1])
        self.occlusion = float(label[2])
        self.alpha = float(label[3])
        self.box2d = np.array([float(x) for x in label[4:8]], dtype=np.float32)
        self.h = float(label[8])
        self.w = float(label[9])
        self.l = float(label[10])  # noqa: E741
        self.loc = np.array([float(x) for x in label[11:14]], dtype=np.float32)
        self.dis_to_cam = float(np.linalg.norm(self.loc))
        self.ry = float(label[14])
        extra = 15 + self.POSE_FIELDS
        self._parse_pose(label)
        self.score = float(label[extra]) if len(label) > extra else -1.0
        self.level, self.level_str = _difficulty(
            self.box2d, self.truncation, self.occlusion
        )

    def _parse_pose(self, label):
        pass


class ObjectPose3d(Object3d):
    """17/18-field SlopedKITTI label with camera-frame pitch/roll."""

    POSE_FIELDS = 2

    def _parse_pose(self, label):
        self.rx = float(label[15])  # pitch
        self.rz = float(label[16])  # roll


def get_objects_from_label(label_file):
    with open(label_file, "r") as f:
        return [Object3d(line) for line in f.readlines() if line.strip()]


def get_objects3d_from_label(label_file):
    with open(label_file, "r") as f:
        return [ObjectPose3d(line) for line in f.readlines() if line.strip()]
