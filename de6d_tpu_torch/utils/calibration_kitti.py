"""KITTI calibration IO + projections (host-side numpy).

Parity: reference utils/calibration_kitti.py:125. The math is the
standard KITTI convention: rect = R0 @ V2C @ lidar_hom; img = P2 @
rect_hom.
"""

from __future__ import annotations

import numpy as np


def get_calib_from_file(calib_file):
    with open(calib_file) as f:
        lines = f.readlines()

    def parse(line):
        return np.array(line.strip().split(" ")[1:], dtype=np.float32)

    return {
        "P2": parse(lines[2]).reshape(3, 4),
        "P3": parse(lines[3]).reshape(3, 4),
        "R0": parse(lines[4]).reshape(3, 3),
        "Tr_velo2cam": parse(lines[5]).reshape(3, 4),
    }


class Calibration:
    def __init__(self, calib_file):
        calib = (
            calib_file
            if isinstance(calib_file, dict)
            else get_calib_from_file(calib_file)
        )
        self.P2 = calib["P2"]
        self.R0 = calib["R0"]
        self.V2C = calib["Tr_velo2cam"]

        self.cu = self.P2[0, 2]
        self.cv = self.P2[1, 2]
        self.fu = self.P2[0, 0]
        self.fv = self.P2[1, 1]
        self.tx = self.P2[0, 3] / (-self.fu)
        self.ty = self.P2[1, 3] / (-self.fv)

    @staticmethod
    def _hom(pts):
        return np.hstack([pts, np.ones((pts.shape[0], 1), dtype=np.float32)])

    def _rect_transform(self):
        """4x4 lidar→rect matrix."""
        r0 = np.eye(4, dtype=np.float32)
        r0[:3, :3] = self.R0
        v2c = np.eye(4, dtype=np.float32)
        v2c[:3, :4] = self.V2C
        return r0 @ v2c

    def lidar_to_rect(self, pts_lidar):
        m = self._rect_transform()
        return (self._hom(pts_lidar) @ m.T)[:, 0:3]

    def rect_to_lidar(self, pts_rect):
        m = np.linalg.inv(self._rect_transform())
        return (self._hom(pts_rect) @ m.T)[:, 0:3]

    def rect_to_img(self, pts_rect):
        hom = self._hom(pts_rect)
        pts_2d = hom @ self.P2.T
        img = pts_2d[:, 0:2] / pts_2d[:, 2:3]
        depth = pts_2d[:, 2] - self.P2.T[3, 2]
        return img, depth

    def lidar_to_img(self, pts_lidar):
        return self.rect_to_img(self.lidar_to_rect(pts_lidar))

    def img_to_rect(self, u, v, depth_rect):
        x = ((u - self.cu) * depth_rect) / self.fu + self.tx
        y = ((v - self.cv) * depth_rect) / self.fv + self.ty
        return np.stack([x, y, depth_rect], axis=1)
