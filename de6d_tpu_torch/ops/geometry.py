"""Box geometry of the ported slices (counterpart of
``de6d_tpu/ops/geometry.py``: ``limit_period``,
``rotate_points_along_z``, ``boxes_to_corners_bev``,
``points_in_boxes_mask`` for 7-DoF boxes (its rotation matrix written
out), ``enlarge_box3d``).

7-DoF box: ``[x, y, z, dx, dy, dz, yaw]``, yaw counter-clockwise about
+z. Arithmetic is fp32, written out elementwise so every product and
sum rounds on its own (the CUDA NMS kernels read corners made here).
Where the JAX package's einsum rounds otherwise on the CPU, the same
steps are taken here: its ``rotate_points_along_z`` fuses the second
product into the sum (computed in float64 and rounded once), its
``points_in_boxes_mask`` does not.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ball_query import _fma

# bottom four corners of the box-frame template, in the JAX package's
# order 0:(+x,+y) 1:(+x,-y) 2:(-x,-y) 3:(-x,+y)
CORNER_TEMPLATE_BEV = np.array(
    [[0.5, 0.5], [0.5, -0.5], [-0.5, -0.5], [-0.5, 0.5]], np.float32
)


def limit_period(val, offset=0.5, period=2 * math.pi):
    return val - torch.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """(B, N, 3+C) points, (B,) yaw → rotated points (extra chans pass):
    ``x' = fma(y, -sin, x * cos)``, ``y' = fma(y, cos, x * sin)``."""
    c = torch.cos(angle)[:, None]
    s = torch.sin(angle)[:, None]
    x, y = points[..., 0], points[..., 1]
    xr = _fma(y, -s, x * c)
    yr = _fma(y, c, x * s)
    return torch.cat(
        [xr[..., None], yr[..., None], points[..., 2:]], dim=-1
    )


def boxes_to_corners_bev(boxes):
    """(N, 7+) boxes → (N, 4, 2) BEV rectangle corners."""
    t = torch.as_tensor(CORNER_TEMPLATE_BEV, device=boxes.device)
    lx = boxes[:, None, 3] * t[None, :, 0]  # (N, 4)
    ly = boxes[:, None, 4] * t[None, :, 1]
    c = torch.cos(boxes[:, 6])[:, None]
    s = torch.sin(boxes[:, 6])[:, None]
    x = c * lx + (-s) * ly + boxes[:, None, 0]
    y = s * lx + c * ly + boxes[:, None, 1]
    return torch.stack([x, y], dim=-1)


def points_in_boxes_mask(points, boxes):
    """Oriented-box containment for yaw-only boxes, boundary inclusive
    (``|local| <= half + 1e-6``): points (..., N, 3+), boxes (..., M, 7)
    → (..., M, N) bool. The box-frame coordinates are ``R^T (p - c)``
    with each product and sum rounded on its own."""
    if boxes.shape[-1] != 7:
        raise NotImplementedError(
            "points_in_boxes_mask: only 7-DoF boxes are ported")
    d = points[..., None, :, :3] - boxes[..., :, None, 0:3]  # (..., M, N, 3)
    c = torch.cos(boxes[..., 6])[..., None]
    s = torch.sin(boxes[..., 6])[..., None]
    half = boxes[..., :, None, 3:6] / 2.0 + 1e-6
    lx = c * d[..., 0] + s * d[..., 1]
    ly = (-s) * d[..., 0] + c * d[..., 1]
    return ((lx.abs() <= half[..., 0]) & (ly.abs() <= half[..., 1])
            & (d[..., 2].abs() <= half[..., 2]))


def enlarge_box3d(boxes, extra_width):
    """Grow (dx, dy, dz) by twice ``extra_width``."""
    extra = torch.as_tensor(extra_width, dtype=boxes.dtype,
                            device=boxes.device)
    return torch.cat([boxes[..., :3], boxes[..., 3:6] + 2.0 * extra,
                      boxes[..., 6:]], dim=-1)
