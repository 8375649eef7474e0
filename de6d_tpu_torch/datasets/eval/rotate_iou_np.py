"""Host-side (numpy) rotated IoU — the eval-protocol oracle.

Same algorithm as the device version (de6d_tpu/ops/iou3d.py): the
intersection of two convex rectangles is the convex hull of corner
containments + edge-edge crossings, area via angle-sorted shoelace.
Replaces the reference's numba-CUDA-style eval kernel
(core/pcdet/datasets/kitti/kitti_object_eval_python/rotate_iou.py:330)
— numba is not available in this image, so this is vectorized numpy.

Box parameterization here matches the EVAL protocol's BEV boxes:
[x, y, dx, dy, angle] (camera-frame 2D rotated rects) as well as lidar
BEV [x, y, dx, dy, yaw] — the math is identical.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-8


def rbbox_to_corners(boxes):
    """(N, 5) [cx, cy, dx, dy, angle] → (N, 4, 2) corners."""
    template = np.array(
        [[1, 1], [1, -1], [-1, -1], [-1, 1]], dtype=np.float64
    ) / 2.0
    corners = boxes[:, None, 2:4] * template[None]
    c, s = np.cos(boxes[:, 4]), np.sin(boxes[:, 4])
    rot = np.stack([c, -s, s, c], axis=-1).reshape(-1, 2, 2)
    corners = np.einsum("nij,nkj->nki", rot, corners)
    return corners + boxes[:, None, 0:2]


def _corners_in_rect(pts, rect):
    a = rect
    b = np.roll(rect, -1, axis=-2)
    e = b - a
    d = pts[..., :, None, :] - a[..., None, :, :]
    cross = e[..., None, :, 0] * d[..., 1] - e[..., None, :, 1] * d[..., 0]
    return np.all(cross >= -EPS, -1) | np.all(cross <= EPS, -1)


def _segment_intersections(ca, cb):
    a0, a1 = ca, np.roll(ca, -1, -2)
    b0, b1 = cb, np.roll(cb, -1, -2)
    p = a0[..., :, None, :]
    r = (a1 - a0)[..., :, None, :]
    q = b0[..., None, :, :]
    s = (b1 - b0)[..., None, :, :]
    rxs = r[..., 0] * s[..., 1] - r[..., 1] * s[..., 0]
    qp = q - p
    qpxr = qp[..., 0] * r[..., 1] - qp[..., 1] * r[..., 0]
    qpxs = qp[..., 0] * s[..., 1] - qp[..., 1] * s[..., 0]
    denom = np.where(np.abs(rxs) < EPS, 1.0, rxs)
    t = qpxs / denom
    u = qpxr / denom
    valid = (
        (np.abs(rxs) >= EPS)
        & (t >= -EPS) & (t <= 1 + EPS)
        & (u >= -EPS) & (u <= 1 + EPS)
    )
    pts = p + t[..., None] * r
    sh = pts.shape[:-3] + (16, 2)
    return pts.reshape(sh), valid.reshape(valid.shape[:-2] + (16,))


def _convex_area(pts, valid):
    n = valid.sum(-1)
    denom = np.maximum(n, 1)[..., None]
    centroid = np.where(valid[..., None], pts, 0.0).sum(-2) / denom
    ang = np.arctan2(
        pts[..., 1] - centroid[..., 1:2], pts[..., 0] - centroid[..., 0:1]
    )
    key = np.where(valid, ang, np.inf)
    order = np.argsort(key, axis=-1)
    pts_s = np.take_along_axis(pts, order[..., None], -2)
    valid_s = np.take_along_axis(valid, order, -1)
    first = pts_s[..., 0:1, :]
    ring = np.where(valid_s[..., None], pts_s, first)
    nxt = np.roll(ring, -1, -2)
    cross = ring[..., 0] * nxt[..., 1] - ring[..., 1] * nxt[..., 0]
    area = 0.5 * np.abs(cross.sum(-1))
    return np.where(n >= 3, area, 0.0)


def rect_overlap(corners_a, corners_b):
    """(..., 4, 2) x (..., 4, 2) → (...,) intersection area."""
    in_b = _corners_in_rect(corners_a, corners_b)
    in_a = _corners_in_rect(corners_b, corners_a)
    ipts, ivalid = _segment_intersections(corners_a, corners_b)
    pts = np.concatenate([corners_a, corners_b, ipts], axis=-2)
    valid = np.concatenate([in_b, in_a, ivalid], axis=-1)
    return _convex_area(pts, valid)


def rotate_iou_matrix(boxes_a, boxes_b, criterion: int = -1,
                      row_chunk: int = 512):
    """(N, 5) x (M, 5) → (N, M) overlap metric.

    criterion: -1 = IoU, 0 = inter/area_a, 1 = inter/area_b — the
    three modes of the reference eval kernel (rotate_iou.py
    devRotateIoUEval).
    """
    n, m = boxes_a.shape[0], boxes_b.shape[0]
    if n == 0 or m == 0:
        return np.zeros((n, m), dtype=np.float32)
    ca = rbbox_to_corners(boxes_a.astype(np.float64))
    cb = rbbox_to_corners(boxes_b.astype(np.float64))
    area_a = boxes_a[:, 2] * boxes_a[:, 3]
    area_b = boxes_b[:, 2] * boxes_b[:, 3]
    out = np.zeros((n, m), dtype=np.float32)
    for s in range(0, n, row_chunk):
        e = min(s + row_chunk, n)
        inter = rect_overlap(
            np.broadcast_to(ca[s:e, None], (e - s, m, 4, 2)),
            np.broadcast_to(cb[None, :], (e - s, m, 4, 2)),
        )
        if criterion == -1:
            denom = area_a[s:e, None] + area_b[None, :] - inter
        elif criterion == 0:
            denom = np.broadcast_to(area_a[s:e, None], inter.shape)
        elif criterion == 1:
            denom = np.broadcast_to(area_b[None, :], inter.shape)
        else:  # raw intersection area (reference criterion=2 used by
            # the 3D-overlap kernel, eval.py d3_box_overlap:150)
            denom = np.ones_like(inter)
        out[s:e] = (inter / np.maximum(denom, EPS)).astype(np.float32)
    return out


def boxes_bev_iou_cpu(boxes_a, boxes_b):
    """Lidar 7-DoF boxes → BEV rotated IoU (N, M). Parity:
    iou3d_nms_utils.boxes_bev_iou_cpu — used by the gt sampler."""
    a = boxes_a[:, [0, 1, 3, 4, 6]]
    b = boxes_b[:, [0, 1, 3, 4, 6]]
    return rotate_iou_matrix(a, b, criterion=-1)


def boxes_iou3d_cpu(boxes_a, boxes_b):
    """Host 3D IoU of lidar 7-DoF boxes."""
    bev = boxes_bev_iou_cpu(boxes_a, boxes_b)
    # recover intersection area from IoU to combine with z overlap
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    inter = bev * (area_a + area_b) / (1.0 + bev)
    za1 = boxes_a[:, 2] - boxes_a[:, 5] / 2
    za2 = boxes_a[:, 2] + boxes_a[:, 5] / 2
    zb1 = boxes_b[:, 2] - boxes_b[:, 5] / 2
    zb2 = boxes_b[:, 2] + boxes_b[:, 5] / 2
    dz = np.clip(
        np.minimum(za2[:, None], zb2[None]) - np.maximum(za1[:, None], zb1[None]),
        0, None,
    )
    inter3d = inter * dz
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter3d / np.maximum(vol_a + vol_b - inter3d, EPS)
