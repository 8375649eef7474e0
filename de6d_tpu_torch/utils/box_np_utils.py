"""Numpy box geometry for the HOST data path.

The augmentor / data-processor / gt-sampler run per-sample on worker
threads; routing them through the jnp versions in ``ops.geometry``
re-traces and re-COMPILES for every distinct gt count (profile: 3.8 s
of XLA compile per 16 samples) and serializes on the GIL-held pjit
dispatch. These are the same algorithms (reference
box_utils.points_in_boxes3d / mask_boxes_outside_range_numpy,
roiaware points_in_boxes CPU path) in plain numpy.

``ops.geometry`` remains the single source for on-device (jit) use;
tests assert these two agree bit-for-bit.
"""

from __future__ import annotations

import numpy as np

from .common_utils import angles_to_matrix, rotation_matrix_z

# bottom 4 then top 4, same ordering as ops.geometry.CORNER_TEMPLATE
CORNER_TEMPLATE = (
    np.array(
        [
            [1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
            [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1],
        ],
        dtype=np.float32,
    )
    / 2.0
)


def boxes_to_rotation_matrix(boxes):
    """(N, 7|9+) → (N, 3, 3)."""
    boxes = np.asarray(boxes)
    if boxes.shape[-1] >= 9:
        return angles_to_matrix(boxes[..., 6], boxes[..., 7], boxes[..., 8])
    return rotation_matrix_z(boxes[..., 6])


def boxes_to_corners_3d(boxes):
    """(N, 7+) yaw-only boxes → (N, 8, 3) corners (reference order)."""
    boxes = np.asarray(boxes)
    corners = boxes[:, None, 3:6] * CORNER_TEMPLATE[None]
    rot = rotation_matrix_z(boxes[:, 6])  # (N, 3, 3)
    corners = np.einsum("nij,nkj->nki", rot, corners)
    return corners + boxes[:, None, 0:3]


def points_in_boxes_mask(points, boxes):
    """(N, 3+), (M, 7|9+) → (M, N) bool, boundary inclusive.

    Same contract as ops.geometry.points_in_boxes_mask (the jnp/device
    version), including the 1e-6 boundary slack.
    """
    points = np.asarray(points)
    boxes = np.asarray(boxes)
    # expanded per-axis broadcasting instead of einsum over an
    # (M, N, 3) temporary: numpy's c_einsum path is ~14x slower here
    # and this mask dominates gt-sampler host prep (57% of a train
    # sample). Accumulation order matches the einsum j-sum, so results
    # stay bit-identical (tests pin parity vs ops.geometry).
    rot = boxes_to_rotation_matrix(boxes)  # (M, 3, 3)
    dx = points[None, :, 0] - boxes[:, None, 0]  # (M, N)
    dy = points[None, :, 1] - boxes[:, None, 1]
    dz = points[None, :, 2] - boxes[:, None, 2]
    hx = boxes[:, None, 3] / 2.0 + 1e-6
    hy = boxes[:, None, 4] / 2.0 + 1e-6
    hz = boxes[:, None, 5] / 2.0 + 1e-6
    r0, r1, r2 = rot[:, 0], rot[:, 1], rot[:, 2]  # rows of R, (M, 3)
    # local_i = (R^T (p-c))_i = R[0,i]*dx + R[1,i]*dy + R[2,i]*dz
    lx = r0[:, 0:1] * dx + r1[:, 0:1] * dy + r2[:, 0:1] * dz
    ly = r0[:, 1:2] * dx + r1[:, 1:2] * dy + r2[:, 1:2] * dz
    lz = r0[:, 2:3] * dx + r1[:, 2:3] * dy + r2[:, 2:3] * dz
    return (
        (np.abs(lx) <= hx) & (np.abs(ly) <= hy) & (np.abs(lz) <= hz)
    )


def points_in_boxes_index(points, boxes, valid_mask=None):
    """(N, 3+), (M, 7|9+) → (N,) int32 containing-box index, -1 if
    none; later boxes win ties (reference points_in_boxes3d sets
    flags[i] in box order)."""
    mask = points_in_boxes_mask(points, boxes)  # (M, N)
    if valid_mask is not None:
        mask = mask & np.asarray(valid_mask)[:, None]
    m = mask.shape[0]
    idx = np.arange(m, dtype=np.int32)[:, None]
    return np.max(
        np.where(mask, idx, np.int32(-1)), axis=0, initial=np.int32(-1)
    ).astype(np.int32)


def mask_boxes_outside_range(boxes, limit_range, min_num_corners: int = 1):
    """(N, 7+), [x0,y0,z0,x1,y1,z1] → (N,) keep mask (reference
    box_utils.mask_boxes_outside_range_numpy)."""
    boxes = np.asarray(boxes)
    corners = boxes_to_corners_3d(boxes[:, :7])
    lo = np.asarray(limit_range[0:3])
    hi = np.asarray(limit_range[3:6])
    inside = np.all((corners >= lo) & (corners <= hi), axis=2)  # (N, 8)
    return np.sum(inside, axis=1) >= min_num_corners
