"""Rotated BEV overlap and IoU (counterpart of ``de6d_tpu/ops/iou3d.py``:
``_pairwise_green_pass``, ``boxes_overlap_bev``, ``boxes_iou_bev``,
``boxes_iou3d``), the target assigner's axis-aligned
``boxes3d_nearest_bev_iou`` and the vote head's ``boxes_aligned_iou3d``.

Sort-free exact method: by Green's theorem the boundary of A∩B is A's
edges clipped into B plus B's edges clipped into A, and the shoelace
contributions of the clipped spans sum to the signed area in any order.
Each edge clip is a 4-constraint Liang-Barsky interval. The second pass
tightens the inside test by ``1e-5`` so shared boundary segments count
once; the union is clamped at ``1e-8``.

The arithmetic is spelled out in the same order as the JAX code and
as ``csrc/nms_fused.cu`` (which is built with ``-fmad=false``), so the
NMS kernel's IoU equals :func:`pairwise_iou_packed` bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ball_query import _fma
from .geometry import boxes_to_corners_bev

EPS = 1e-8
SECOND_PASS_EPS = 1e-5
PACKED_ROWS = 9  # cx0..3, cy0..3, area


def pack_bev(boxes):
    """(..., K, 7+) boxes → (..., 9, K) fp32 rows [cx(4); cy(4); area]."""
    lead = boxes.shape[:-2]
    k = boxes.shape[-2]
    flat = boxes.reshape(-1, boxes.shape[-1]).float()
    corners = boxes_to_corners_bev(flat)  # (M, 4, 2)
    area = flat[:, 3] * flat[:, 4]
    packed = torch.cat(
        [corners[..., 0], corners[..., 1], area[:, None]], dim=1
    )  # (M, 9)
    return packed.reshape(*lead, k, PACKED_ROWS).transpose(-1, -2)


def _green_pass(px, py, qx, qy, eps_b):
    """Edges of polygon P clipped inside polygon Q (both clockwise in
    the template orientation, so the orientation sign is -1); inputs
    are lists of 4 per-corner tensors that broadcast to the pair grid."""
    total = None
    for e in range(4):
        p0x, p0y = px[e], py[e]
        dx = px[(e + 1) % 4] - p0x
        dy = py[(e + 1) % 4] - p0y
        t0 = None
        t1 = None
        for c in range(4):
            a0x, a0y = qx[c], qy[c]
            ex = qx[(c + 1) % 4] - a0x
            ey = qy[(c + 1) % 4] - a0y
            f0 = -(ex * (p0y - a0y) - ey * (p0x - a0x)) - eps_b
            fd = -(ex * dy - ey * dx)
            small = torch.abs(fd) < EPS
            denom = torch.where(
                small, torch.where(fd >= 0, EPS, -EPS), fd
            )
            t_cross = -f0 / denom
            lo = torch.where(fd > 0, t_cross, 0.0)
            hi = torch.where(fd < 0, t_cross, 1.0)
            infeasible = small & (f0 < -EPS)
            lo = torch.where(infeasible, 1.0, lo)
            hi = torch.where(infeasible, 0.0, hi)
            t0 = lo if t0 is None else torch.maximum(t0, lo)
            t1 = hi if t1 is None else torch.minimum(t1, hi)
        t0 = torch.clamp(t0, 0.0, 1.0)
        t1 = torch.maximum(t0, torch.clamp(t1, 0.0, 1.0))
        q0x = p0x + t0 * dx
        q0y = p0y + t0 * dy
        q1x = p0x + t1 * dx
        q1y = p0y + t1 * dy
        contrib = 0.5 * (q0x * q1y - q0y * q1x)
        total = contrib if total is None else total + contrib
    return total


def pairwise_overlap_packed(rows, cols):
    """(..., 9, N) row boxes × (..., 9, M) column boxes → (..., N, M)
    overlap areas. The pass order (rows' edges first, with eps 0) is
    part of the result: the JAX code and the kernel use it too."""
    rx = [rows[..., i, :, None] for i in range(4)]
    ry = [rows[..., 4 + i, :, None] for i in range(4)]
    cx = [cols[..., i, None, :] for i in range(4)]
    cy = [cols[..., 4 + i, None, :] for i in range(4)]
    area = _green_pass(rx, ry, cx, cy, 0.0) + _green_pass(
        cx, cy, rx, ry, SECOND_PASS_EPS
    )
    return torch.abs(area)


def pairwise_iou_packed(rows, cols):
    overlap = pairwise_overlap_packed(rows, cols)
    area_r = rows[..., 8, :, None]
    area_c = cols[..., 8, None, :]
    union = torch.clamp(area_r + area_c - overlap, min=EPS)
    return overlap / union


def boxes_overlap_bev(boxes_a, boxes_b):
    """(N, 7+) × (M, 7+) → (N, M) rotated BEV overlap area."""
    return pairwise_overlap_packed(pack_bev(boxes_a), pack_bev(boxes_b))


def boxes_iou_bev(boxes_a, boxes_b):
    """(N, 7+) × (M, 7+) → (N, M) rotated BEV IoU."""
    return pairwise_iou_packed(pack_bev(boxes_a), pack_bev(boxes_b))


def boxes_iou3d(boxes_a, boxes_b):
    """(..., N, 7+) × (..., M, 7+) → (..., N, M) 3D IoU: the rotated BEV
    overlap times the z-extent overlap, over the union of the volumes
    (yaw only, the first 7 columns, also for 9-DoF boxes)."""
    overlap_bev = pairwise_overlap_packed(pack_bev(boxes_a), pack_bev(boxes_b))
    za1 = boxes_a[..., 2] - boxes_a[..., 5] / 2
    za2 = boxes_a[..., 2] + boxes_a[..., 5] / 2
    zb1 = boxes_b[..., 2] - boxes_b[..., 5] / 2
    zb2 = boxes_b[..., 2] + boxes_b[..., 5] / 2
    overlap_h = torch.clamp(
        torch.minimum(za2[..., :, None], zb2[..., None, :])
        - torch.maximum(za1[..., :, None], zb1[..., None, :]), min=0.0)
    overlap_3d = overlap_bev * overlap_h
    vol_a = (boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5])[..., :, None]
    vol_b = (boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5])[..., None, :]
    return overlap_3d / torch.clamp(vol_a + vol_b - overlap_3d, min=EPS)


# Jitted XLA on the CPU, whose labels the assigner must reproduce, rounds
# otherwise than the JAX code reads: it multiplies by the fp32 reciprocal
# where the code divides by pi, and contracts ``yaw * (1/pi) + 0.5``,
# ``yaw - k * pi`` and ``area_a + dx_b * dy_b`` into FMAs (computed here
# in float64 and rounded once). A last-bit difference would move the
# forced matches (exact equality) and the threshold tests.
_PI32 = float(np.float32(math.pi))
_INV_PI32 = float(np.float32(1.0) / np.float32(math.pi))


def _nearest_aabb(boxes):
    """(N, 7+) → (N, 4) [x, y, dx, dy] of the box snapped to its nearest
    axis-aligned orientation (dx, dy swapped beyond 45 degrees)."""
    yaw = boxes[:, 6]
    k = torch.floor(_fma(yaw, torch.full_like(yaw, _INV_PI32),
                         torch.full_like(yaw, 0.5)))
    rot = torch.abs(_fma(-k, torch.full_like(k, _PI32), yaw))
    swap = rot > (math.pi / 4)
    dx = torch.where(swap, boxes[:, 4], boxes[:, 3])
    dy = torch.where(swap, boxes[:, 3], boxes[:, 4])
    return torch.stack([boxes[:, 0], boxes[:, 1], dx, dy], dim=-1)


def boxes3d_nearest_bev_iou(boxes_a, boxes_b):
    """(N, 7+) × (M, 7+) → (N, M) axis-aligned BEV IoU after snapping each
    box to its nearest axis-aligned orientation (the anchor target
    assigner's IoU); bit-equal to the jitted JAX function."""
    a = _nearest_aabb(boxes_a.float())
    b = _nearest_aabb(boxes_b.float())
    a_min = a[:, 0:2] - a[:, 2:4] / 2
    a_max = a[:, 0:2] + a[:, 2:4] / 2
    b_min = b[:, 0:2] - b[:, 2:4] / 2
    b_max = b[:, 0:2] + b[:, 2:4] / 2
    lt = torch.maximum(a_min[:, None], b_min[None])
    rb = torch.minimum(a_max[:, None], b_max[None])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    shape = inter.shape
    area_a = (a[:, 2] * a[:, 3])[:, None].expand(shape)
    union = _fma(b[None, :, 2].expand(shape), b[None, :, 3].expand(shape),
                 area_a) - inter
    return inter / torch.clamp(union, min=EPS)


def boxes_aligned_iou3d(boxes_a, boxes_b):
    """Axis-aligned 3D IoU of matched pairs: (N, 7+) × (N, 7+) → (N,)
    (the yaw is ignored)."""
    a_min = boxes_a[:, 0:3] - boxes_a[:, 3:6] / 2
    a_max = boxes_a[:, 0:3] + boxes_a[:, 3:6] / 2
    b_min = boxes_b[:, 0:3] - boxes_b[:, 3:6] / 2
    b_max = boxes_b[:, 0:3] + boxes_b[:, 3:6] / 2
    whd = torch.clamp(torch.minimum(a_max, b_max)
                      - torch.maximum(a_min, b_min), min=0.0)
    inter = whd[:, 0] * whd[:, 1] * whd[:, 2]
    vol_a = boxes_a[:, 3:6].prod(dim=-1)
    vol_b = boxes_b[:, 3:6].prod(dim=-1)
    return inter / torch.clamp(vol_a + vol_b - inter, min=EPS)
