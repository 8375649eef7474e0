"""Dense grid anchor generation (host-side numpy, computed once; copy
of ``de6d_tpu/models/dense_heads/anchor_generator.py``).

Parity: reference target_assigner/anchor_generator.py:79 — per-class
grids over the BEV feature map, one anchor per (height, size,
rotation) per cell; without align_center the stride is
range/(grid-1) with zero offset; anchor z is shifted from bottom
height to box center.

Deviation: we emit anchors as (ny, nx, A_loc, 7) with A_loc enumerated
(class, height, size, rotation) so the layout matches the conv head's
channel order per location. The reference keeps a z-major layout that
only coincides with its head layout when each class has a single
bottom height — true for every shipped config.
"""

from __future__ import annotations

import numpy as np


def generate_anchors(anchor_generator_cfg, grid_size, point_cloud_range,
                     anchor_ndim: int = 7):
    """Returns:
        anchors: (ny, nx, A_loc, anchor_ndim) float32
        anchor_group: (A_loc,) int32 — index into anchor_generator_cfg
        matched_thr / unmatched_thr: (A_loc,) float32
        num_anchors_per_location: int
    """
    pc = point_cloud_range
    per_loc_anchors = []
    groups = []
    matched = []
    unmatched = []

    # all classes must share a feature-map stride for a single fused
    # grid (true for AnchorHeadSingle configs)
    strides = {int(c["feature_map_stride"]) for c in anchor_generator_cfg}
    assert len(strides) == 1, "per-class feature strides must match"
    stride = strides.pop()
    nx = int(grid_size[0]) // stride
    ny = int(grid_size[1]) // stride

    x_stride = (pc[3] - pc[0]) / (nx - 1)
    y_stride = (pc[4] - pc[1]) / (ny - 1)
    xs = pc[0] + np.arange(nx, dtype=np.float64) * x_stride
    ys = pc[1] + np.arange(ny, dtype=np.float64) * y_stride

    for g, cfg in enumerate(anchor_generator_cfg):
        sizes = np.array(cfg["anchor_sizes"], dtype=np.float64)  # (S, 3)
        rots = np.array(cfg["anchor_rotations"], dtype=np.float64)  # (R,)
        heights = np.array(cfg["anchor_bottom_heights"], dtype=np.float64)
        for h in heights:
            for s in sizes:
                for r in rots:
                    per_loc_anchors.append((h + s[2] / 2.0, s, r))
                    groups.append(g)
                    matched.append(float(cfg["matched_threshold"]))
                    unmatched.append(float(cfg["unmatched_threshold"]))

    a_loc = len(per_loc_anchors)
    anchors = np.zeros((ny, nx, a_loc, anchor_ndim), dtype=np.float32)
    gx, gy = np.meshgrid(xs, ys)  # (ny, nx)
    for k, (zc, s, r) in enumerate(per_loc_anchors):
        anchors[:, :, k, 0] = gx
        anchors[:, :, k, 1] = gy
        anchors[:, :, k, 2] = zc
        anchors[:, :, k, 3:6] = s
        anchors[:, :, k, 6] = r

    return (
        anchors,
        np.array(groups, dtype=np.int32),
        np.array(matched, dtype=np.float32),
        np.array(unmatched, dtype=np.float32),
        a_loc,
    )
