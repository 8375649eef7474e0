"""Box geometry the PointPillars slice needs (counterpart of
``de6d_tpu/ops/geometry.py``: ``limit_period``,
``rotate_points_along_z``, ``boxes_to_corners_bev``).

7-DoF box: ``[x, y, z, dx, dy, dz, yaw]``, yaw counter-clockwise about
+z. Arithmetic is fp32, written out elementwise so every product and
sum rounds on its own (the CUDA NMS kernel reads corners made here).
"""

from __future__ import annotations

import math

import numpy as np
import torch

# bottom four corners of the box-frame template, in the JAX package's
# order 0:(+x,+y) 1:(+x,-y) 2:(-x,-y) 3:(-x,+y)
CORNER_TEMPLATE_BEV = np.array(
    [[0.5, 0.5], [0.5, -0.5], [-0.5, -0.5], [-0.5, 0.5]], np.float32
)


def limit_period(val, offset=0.5, period=2 * math.pi):
    return val - torch.floor(val / period + offset) * period


def rotate_points_along_z(points, angle):
    """(B, N, 3+C) points, (B,) yaw → rotated points (extra chans pass)."""
    c = torch.cos(angle)[:, None]
    s = torch.sin(angle)[:, None]
    x, y = points[..., 0], points[..., 1]
    xr = x * c - y * s
    yr = x * s + y * c
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
