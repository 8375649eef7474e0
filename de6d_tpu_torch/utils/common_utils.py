"""Shared helpers (counterpart of ``de6d_tpu/utils/common_utils.py``):
the numpy geometry helpers of the host pipeline (``limit_period``,
``rotation_matrix_z``, ``rotate_points_along_z``, ``angles_to_matrix``),
``create_logger``, ``set_random_seed``, ``AverageMeter``,
``keep_arrays_by_name`` and ``drop_info_with_name``. The numpy helpers are
copies of the JAX package's, so the batches they shape stay bit-equal."""

from __future__ import annotations

import logging
import random

import numpy as np
import torch


# ---------------------------------------------------------------------------
# geometry helpers (numpy; the torch twins live in ops/geometry.py)
# ---------------------------------------------------------------------------

def limit_period(val, offset: float = 0.5, period: float = 2 * np.pi):
    """Wrap ``val`` into [-offset*period, (1-offset)*period)."""
    return val - np.floor(val / period + offset) * period


def rotation_matrix_z(angle):
    """(..., ) yaw → (..., 3, 3) rotation about +z (counter-clockwise)."""
    angle = np.asarray(angle)
    c, s = np.cos(angle), np.sin(angle)
    zero, one = np.zeros_like(c), np.ones_like(c)
    rot = np.stack(
        [c, -s, zero, s, c, zero, zero, zero, one], axis=-1
    ).reshape(*angle.shape, 3, 3)
    return rot


def rotate_points_along_z(points: np.ndarray, angle: np.ndarray) -> np.ndarray:
    """Rotate (B, N, 3+C) points by per-batch yaw ``angle`` (B,): the
    xyz channels rotate, extra channels pass through."""
    rot = rotation_matrix_z(angle)  # (B, 3, 3)
    xyz = points[..., :3] @ rot.swapaxes(-1, -2)
    return np.concatenate([xyz, points[..., 3:]], axis=-1)


def angles_to_matrix(yaw, pitch=None, roll=None):
    """Euler angles → rotation matrix, R = Rx(roll) @ Ry(pitch) @ Rz(yaw)
    (scipy ``Rotation.from_euler('zyx', [yaw, pitch, roll])``).
    Broadcasts over leading dims."""
    yaw = np.asarray(yaw, dtype=np.float64)
    pitch = np.zeros_like(yaw) if pitch is None else np.asarray(pitch)
    roll = np.zeros_like(yaw) if roll is None else np.asarray(roll)
    cz, sz = np.cos(yaw), np.sin(yaw)
    cy, sy = np.cos(pitch), np.sin(pitch)
    cx, sx = np.cos(roll), np.sin(roll)
    # R = Rx @ Ry @ Rz, written out:
    r00 = cy * cz
    r01 = -cy * sz
    r02 = sy
    r10 = cx * sz + sx * sy * cz
    r11 = cx * cz - sx * sy * sz
    r12 = -sx * cy
    r20 = sx * sz - cx * sy * cz
    r21 = sx * cz + cx * sy * sz
    r22 = cx * cy
    rot = np.stack([r00, r01, r02, r10, r11, r12, r20, r21, r22], axis=-1)
    return rot.reshape(*yaw.shape, 3, 3)


# ---------------------------------------------------------------------------
# logging / seeding / meters
# ---------------------------------------------------------------------------

def create_logger(log_file=None, rank: int = 0, log_level=logging.INFO):
    """Rank-aware console + file logger."""
    logger = logging.getLogger(f"de6d_tpu_torch.r{rank}.{log_file}")
    logger.setLevel(log_level if rank == 0 else logging.ERROR)
    logger.propagate = False
    formatter = logging.Formatter("%(asctime)s  %(levelname)5s  %(message)s")
    if not logger.handlers:
        console = logging.StreamHandler()
        console.setLevel(log_level if rank == 0 else logging.ERROR)
        console.setFormatter(formatter)
        logger.addHandler(console)
        if log_file is not None:
            fh = logging.FileHandler(log_file)
            fh.setLevel(log_level if rank == 0 else logging.ERROR)
            fh.setFormatter(formatter)
            logger.addHandler(fh)
    return logger


def set_random_seed(seed: int):
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


class AverageMeter:
    """Running average of a scalar."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def keep_arrays_by_name(gt_names, used_classes):
    """Indices of gt_names that are in used_classes."""
    inds = [i for i, name in enumerate(gt_names) if name in used_classes]
    return np.array(inds, dtype=np.int64)


def drop_info_with_name(info: dict, name: str) -> dict:
    """Filter a kitti info annos dict, dropping entries whose 'name' is
    ``name`` (e.g. 'DontCare')."""
    ret = {}
    keep = [i for i, n in enumerate(info["name"]) if n != name]
    for key, val in info.items():
        if isinstance(val, np.ndarray) and val.shape[0] == len(info["name"]):
            ret[key] = val[keep]
        else:
            ret[key] = val
    return ret
