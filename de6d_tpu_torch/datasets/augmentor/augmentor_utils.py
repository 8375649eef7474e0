"""Augmentation math kernels (host-side numpy).

Parity: reference datasets/augmentor/augmentor_utils.py. Boxes are
(N, 7+C) [x, y, z, dx, dy, dz, yaw(, pitch, roll)]; points (M, 3+C).
All functions are PURE (take an np.random.Generator-compatible
RandomState, return new arrays) — unlike the reference's global
np.random use, so the pipeline is reproducible per-sample.

Key kernel: ``random_global_make_slope`` — SlopeAug (reference
:622-694): pick a hinge point at polar distance ~ U(mean±var) along
~U(0±var) bearing, a rotation vector perpendicular to it with slope
angle ~ U(mean±var); every point/box beyond the hinge line (opposite
side from the origin) rotates about that axis; box pitch/roll pick up
the rotation's 'XYZ' intrinsic euler y/x components; angles wrap to
[-pi, pi).
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

from ...utils.common_utils import (
    limit_period, rotate_points_along_z, keep_arrays_by_name,
)


def _uniform_pm(rng, n=1):
    """uniform in [-1, 1]"""
    return (rng.random_sample(n) - 0.5) * 2.0


def random_flip_along_x(gt_boxes, points, rng, enable=None):
    """Mirror y (reference :9-25). 9-DoF: roll flips sign."""
    if enable is None:
        enable = rng.randint(2) == 1
    if enable:
        gt_boxes = gt_boxes.copy()
        points = points.copy()
        gt_boxes[:, 1] = -gt_boxes[:, 1]
        gt_boxes[:, 6] = -gt_boxes[:, 6]
        points[:, 1] = -points[:, 1]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 8] = -gt_boxes[:, 8]
    return gt_boxes, points


def random_flip_along_y(gt_boxes, points, rng, enable=None):
    """Mirror x (reference :28-44). 9-DoF: pitch flips sign."""
    if enable is None:
        enable = rng.randint(2) == 1
    if enable:
        gt_boxes = gt_boxes.copy()
        points = points.copy()
        gt_boxes[:, 0] = -gt_boxes[:, 0]
        gt_boxes[:, 6] = -(gt_boxes[:, 6] + np.pi)
        points[:, 0] = -points[:, 0]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7] = -gt_boxes[:, 7]
    return gt_boxes, points


def global_rotation(gt_boxes, points, rot_range, rng, angle=None):
    """Rotate the world about +z (reference :47-66). 9-DoF: the
    (pitch, roll) pair rotates as a 2-vector — the reference's (typo-
    prone but shipped) behavior, kept for parity."""
    if angle is None:
        angle = rng.uniform(rot_range[0], rot_range[1])
    points = rotate_points_along_z(points[None], np.array([angle]))[0]
    gt_boxes = gt_boxes.copy()
    gt_boxes[:, 0:3] = rotate_points_along_z(
        gt_boxes[None, :, 0:3], np.array([angle])
    )[0]
    gt_boxes[:, 6] += angle
    if gt_boxes.shape[1] > 7:
        pr = np.concatenate(
            [gt_boxes[:, 7:9], np.zeros((gt_boxes.shape[0], 1))], axis=1
        )
        gt_boxes[:, 7:9] = rotate_points_along_z(
            pr[None], np.array([angle])
        )[0][:, 0:2]
    return gt_boxes, points


def global_scaling(gt_boxes, points, scale_range, rng, scale=None):
    """(reference :69-82)"""
    if scale_range[1] - scale_range[0] < 1e-3:
        return gt_boxes, points
    if scale is None:
        scale = rng.uniform(scale_range[0], scale_range[1])
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    points[:, :3] *= scale
    gt_boxes[:, :6] *= scale
    return gt_boxes, points


def random_translation_along_axis(gt_boxes, points, offset_std, axis, rng):
    """World translation (reference random_translation_along_x/y/z)."""
    offset = rng.normal(0, offset_std)
    points = points.copy()
    gt_boxes = gt_boxes.copy()
    points[:, axis] += offset
    gt_boxes[:, axis] += offset
    return gt_boxes, points


def random_local_rotation(gt_boxes, points, rot_range, rng):
    """Per-object rotation about each box center (reference
    random_local_rotation)."""
    from ...utils import box_np_utils

    gt_boxes = gt_boxes.copy()
    points = points.copy()
    mask = box_np_utils.points_in_boxes_index(points[:, :3], gt_boxes)
    for i in range(gt_boxes.shape[0]):
        angle = rng.uniform(rot_range[0], rot_range[1])
        sel = mask == i
        ctr = gt_boxes[i, 0:3]
        pts = points[sel]
        pts[:, 0:3] -= ctr
        pts[:, 0:3] = rotate_points_along_z(
            pts[None, :, 0:3], np.array([angle])
        )[0]
        pts[:, 0:3] += ctr
        points[sel] = pts
        gt_boxes[i, 6] += angle
    return gt_boxes, points


def random_local_scaling(gt_boxes, points, scale_range, rng):
    from ...utils import box_np_utils

    gt_boxes = gt_boxes.copy()
    points = points.copy()
    mask = box_np_utils.points_in_boxes_index(points[:, :3], gt_boxes)
    for i in range(gt_boxes.shape[0]):
        scale = rng.uniform(scale_range[0], scale_range[1])
        sel = mask == i
        ctr = gt_boxes[i, 0:3]
        points[sel, 0:3] = (points[sel, 0:3] - ctr) * scale + ctr
        gt_boxes[i, 3:6] *= scale
    return gt_boxes, points


def random_global_make_slope(
    gt_boxes, points, params, rng,
    rotate_point=None, rotate_angle=None, smooth=False, bins=2,
):
    """SlopeAug (reference :622-694).

    params = (dist_mean, dist_var, angle_mean, angle_var); distances in
    meters, angles in radians. Returns (gt_boxes (N, ≥9), points,
    rotate_point, rotate_angle) — hinge params are persisted as the
    'slope plane' by the SlopedKITTI generator.
    """
    dist_mean, dist_var, angle_mean, angle_var = params
    if rotate_point is None:
        d = dist_mean + _uniform_pm(rng)[0] * dist_var
        bearing = 0.0 + _uniform_pm(rng)[0] * 0.0  # polar var 0 (ref)
        rotate_point = np.array(
            [d * np.cos(bearing), d * np.sin(bearing), 0.0]
        )
    x0, y0 = rotate_point[0], rotate_point[1]
    if rotate_angle is None:
        # rotation axis ⊥ to the hinge-point direction, in the xy plane
        k0 = y0 / x0 if x0 != 0 else 1e6
        k1 = -1.0 / (k0 + 1e-6)
        v = np.array([x0, x0 * k1, 0.0])
        v /= np.linalg.norm(v)
        angle = angle_mean + _uniform_pm(rng)[0] * angle_var
        rotate_angle = v * angle

    if smooth:
        # split the slope arc into `bins` hinge segments of delta each,
        # forming an approximately circular transition (reference
        # :649-666)
        alpha = rotate_angle[1]
        if abs(alpha) < 1e-9:
            return _apply_slope(gt_boxes, points, rotate_point, rotate_angle)
        radius = rotate_point[0] / abs(alpha)
        dist = rotate_point[0]
        rp, ra = rotate_point, rotate_angle
        for theta in np.linspace(0, alpha, bins):
            delta = alpha / bins
            center = np.array([dist, 0.0, radius])
            seg_point = center + np.array(
                [-radius * np.sin(theta), 0.0, -radius * np.cos(theta)]
            )
            seg_angle = np.array([0.0, delta, 0.0])
            gt_boxes, points, _, _ = _apply_slope(
                gt_boxes, points, seg_point, seg_angle
            )
        return gt_boxes, points, rp, ra

    return _apply_slope(gt_boxes, points, rotate_point, rotate_angle)


def _apply_slope(gt_boxes, points, rotate_point, rotate_angle):
    """Rotate everything beyond the hinge line about (point, rotvec)."""
    points = points.copy()
    gt_boxes = np.array(gt_boxes, copy=True)
    x0, y0 = rotate_point[0], rotate_point[1]
    k = rotate_angle[1] / (rotate_angle[0] + 1e-6)
    sign = np.sign(k * (0 - x0) + y0 - 0)

    rot = Rotation.from_rotvec(rotate_angle).as_matrix()

    def beyond(xy):
        return np.sign(k * (xy[:, 0] - x0) + y0 - xy[:, 1]) != sign

    pmask = beyond(points[:, 0:2])
    moved = points[pmask]
    moved[:, 0:3] = (moved[:, 0:3] - rotate_point) @ rot.T + rotate_point
    points[pmask] = moved

    if gt_boxes.shape[1] < 9:
        gt_boxes = np.concatenate(
            [gt_boxes, np.zeros((gt_boxes.shape[0], 2))], axis=1
        )
    bmask = beyond(gt_boxes[:, 0:2])
    gt_boxes[bmask, 0:3] = (
        (gt_boxes[bmask, 0:3] - rotate_point) @ rot.T + rotate_point
    )
    euler = Rotation.from_rotvec(rotate_angle).as_euler("XYZ")
    gt_boxes[bmask, 7] += euler[1]  # pitch
    gt_boxes[bmask, 8] += euler[0]  # roll
    gt_boxes[:, 6:9] = limit_period(
        gt_boxes[:, 6:9], offset=0.5, period=2 * np.pi
    )
    return gt_boxes, points, rotate_point, rotate_angle


def random_local_translation(gt_boxes, points, offset_range, axis, rng):
    """Per-object translation along one axis (reference
    random_local_translation_along_x/y/z)."""
    from ...utils import box_np_utils

    gt_boxes = gt_boxes.copy()
    points = points.copy()
    idx = box_np_utils.points_in_boxes_index(points[:, :3], gt_boxes)
    for i in range(gt_boxes.shape[0]):
        offset = rng.uniform(offset_range[0], offset_range[1])
        sel = idx == i
        points[sel, axis] += offset
        gt_boxes[i, axis] += offset
    return gt_boxes, points


def global_frustum_dropout(gt_boxes, points, intensity_range, rng,
                           direction="top"):
    """Drop a frustum of points above/below/left/right of a random
    gt box (reference global_frustum_dropout_*): removes scene points
    whose bearing falls in the box's angular frustum on the chosen
    side."""
    if gt_boxes.shape[0] == 0:
        return gt_boxes, points
    intensity = rng.uniform(intensity_range[0], intensity_range[1])
    if intensity <= 0:
        return gt_boxes, points
    box = gt_boxes[rng.randint(gt_boxes.shape[0])]
    # angular extent of the box from the sensor
    ang = np.arctan2(box[1], box[0])
    half = np.arctan2(
        np.linalg.norm(box[3:5]) / 2, np.linalg.norm(box[:2])
    )
    pang = np.arctan2(points[:, 1], points[:, 0])
    in_frustum = np.abs(
        (pang - ang + np.pi) % (2 * np.pi) - np.pi
    ) < half * intensity
    if direction == "top":
        side = points[:, 2] > box[2] + box[5] / 2
    elif direction == "bottom":
        side = points[:, 2] < box[2] - box[5] / 2
    elif direction == "left":
        side = ((pang - ang + np.pi) % (2 * np.pi) - np.pi) > 0
    else:
        side = ((pang - ang + np.pi) % (2 * np.pi) - np.pi) < 0
    drop = in_frustum & side
    return gt_boxes, points[~drop]


# ---------------------------------------------------------------------------
# local pyramid augmentations (PA-AUG)
# ---------------------------------------------------------------------------
# Parity: reference local_pyramid_{dropout,sparsify,swap}
# (augmentor_utils.py:496-608). The reference calls
# box_utils.boxes_to_pyramids / points_in_pyramids_mask which are absent
# from its own snapshot (dead upstream imports); the geometry here follows
# the OpenPCDet/PA-AUG semantics: each box splits into 6 square pyramids
# (apex = box center, base = one face), points are parametrized by
# (alpha, beta) in the base plane and gamma along the apex axis.

def boxes_to_pyramids(boxes):
    """(N, 7+) boxes → (N, 6, 15) pyramids [apex(3), c0, c1, c2, c3]."""
    from ...utils import box_np_ops

    corners = box_np_ops.boxes_to_corners_3d(boxes[:, :7])  # (N, 8, 3)
    center = boxes[:, 0:3]
    # faces in our corner template order (geometry.CORNER_TEMPLATE):
    # bottom ring 0..3, top ring 4..7
    faces = np.array([
        [0, 1, 5, 4],  # +x
        [1, 2, 6, 5],  # -y
        [2, 3, 7, 6],  # -x
        [3, 0, 4, 7],  # +y
        [0, 1, 2, 3],  # bottom
        [4, 5, 6, 7],  # top
    ])
    face_corners = corners[:, faces, :]  # (N, 6, 4, 3)
    apex = np.broadcast_to(center[:, None, None, :],
                           face_corners[:, :, :1, :].shape)
    pyr = np.concatenate([apex, face_corners], axis=2)  # (N, 6, 5, 3)
    return pyr.reshape(boxes.shape[0], 6, 15)


def _pyramid_ratios(points, pyramid):
    """points (M, 3+), pyramid (15,) → (alpha, beta, gamma) arrays
    (reference local_pyramid_swap.get_points_ratio :532-539)."""
    surface_center = (
        pyramid[3:6] + pyramid[6:9] + pyramid[9:12] + pyramid[12:]
    ) / 4.0
    v0 = pyramid[6:9] - pyramid[3:6]
    v1 = pyramid[12:] - pyramid[3:6]
    v2 = pyramid[0:3] - surface_center
    alphas = ((points[:, 0:3] - pyramid[3:6]) * v0).sum(-1) / max(
        np.power(v0, 2).sum(), 1e-12
    )
    betas = ((points[:, 0:3] - pyramid[3:6]) * v1).sum(-1) / max(
        np.power(v1, 2).sum(), 1e-12
    )
    gammas = ((points[:, 0:3] - surface_center) * v2).sum(-1) / max(
        np.power(v2, 2).sum(), 1e-12
    )
    return alphas, betas, gammas


def points_in_pyramids_mask(points, pyramids):
    """(M, 3+), (K, 15) → (M, K) bool: inside the square pyramid iff
    gamma ∈ [0, 1] and (alpha, beta) within the linearly shrinking
    cross-section."""
    m, k = points.shape[0], pyramids.shape[0]
    mask = np.zeros((m, k), dtype=bool)
    for i in range(k):
        a, b_, g = _pyramid_ratios(points, pyramids[i])
        shrink = 0.5 * (1.0 - g)
        mask[:, i] = (
            (g >= 0.0) & (g <= 1.0)
            & (np.abs(a - 0.5) <= shrink) & (np.abs(b_ - 0.5) <= shrink)
        )
    return mask


def local_pyramid_dropout(gt_boxes, points, dropout_prob, rng):
    """Drop all points of one random pyramid per selected box
    (reference :496-505)."""
    drop = rng.uniform(0, 1, gt_boxes.shape[0]) <= dropout_prob
    if drop.sum() != 0:
        pyr = boxes_to_pyramids(gt_boxes[drop])
        face = rng.randint(0, 6, pyr.shape[0])
        chosen = pyr[np.arange(pyr.shape[0]), face]
        masks = points_in_pyramids_mask(points, chosen)
        points = points[np.logical_not(masks.any(-1))]
    return gt_boxes, points


def local_pyramid_sparsify(gt_boxes, points, prob, max_num_pts, rng):
    """Subsample one random pyramid per selected box down to
    max_num_pts (reference :507-528)."""
    sel = rng.uniform(0, 1, gt_boxes.shape[0]) <= prob
    if sel.sum() != 0:
        pyr = boxes_to_pyramids(gt_boxes[sel])
        face = rng.randint(0, 6, pyr.shape[0])
        chosen = pyr[np.arange(pyr.shape[0]), face]
        masks = points_in_pyramids_mask(points, chosen)
        num = masks.sum(0)
        valid = num > max_num_pts
        if valid.sum() != 0:
            keep_masks = masks[:, valid]
            remain = points[np.logical_not(keep_masks.any(-1))]
            filtered = np.zeros(
                [valid.sum() * max_num_pts, points.shape[1]],
                dtype=points.dtype,
            )
            for i in range(valid.sum()):
                idx = rng.choice(
                    int(keep_masks[:, i].sum()), size=max_num_pts
                )
                filtered[i * max_num_pts:(i + 1) * max_num_pts] = points[
                    keep_masks[:, i]
                ][idx]
            points = np.concatenate([remain, filtered], axis=0)
    return gt_boxes, points


def local_pyramid_swap(gt_boxes, points, swap_prob, max_num_pts, rng):
    """Swap the points of matching pyramids between two boxes via the
    (alpha, beta, gamma) parametrization, remapping intensity ranges
    (reference :531-608)."""

    def recover(ratios, pyramid):
        alphas, betas, gammas = ratios
        surface_center = (
            pyramid[3:6] + pyramid[6:9] + pyramid[9:12] + pyramid[12:]
        ) / 4.0
        v0 = pyramid[6:9] - pyramid[3:6]
        v1 = pyramid[12:] - pyramid[3:6]
        v2 = pyramid[0:3] - surface_center
        return (
            alphas[:, None] * v0 + betas[:, None] * v1
        ) + pyramid[3:6] + gammas[:, None] * v2

    sel = rng.uniform(0, 1, gt_boxes.shape[0]) <= swap_prob
    if sel.sum() == 0:
        return gt_boxes, points
    pyr = boxes_to_pyramids(gt_boxes[sel]).reshape(-1, 6, 15)
    masks = points_in_pyramids_mask(
        points, pyr.reshape(-1, 15)
    )  # (M, Nb*6)
    nums = masks.sum(0).reshape(pyr.shape[0], 6)
    valid = nums > max_num_pts  # (Nb, 6)
    if valid.sum() == 0:
        return gt_boxes, points
    vb, vp = np.nonzero(valid)
    src_boxes = np.unique(vb)
    src_faces = [rng.choice(vp[vb == i]) for i in src_boxes]
    tgt_boxes = np.array([
        rng.choice(np.where(valid[:, j])[0])
        if np.where(valid[:, j])[0].shape[0] > 0 else i
        for i, j in zip(src_boxes, src_faces)
    ])
    src_faces = np.array(src_faces)
    differ = src_boxes != tgt_boxes
    if differ.sum() == 0:
        return gt_boxes, points
    src_boxes, tgt_boxes = src_boxes[differ], tgt_boxes[differ]
    src_faces = src_faces[differ]
    src_pyr = pyr[src_boxes, src_faces]
    tgt_pyr = pyr[tgt_boxes, src_faces]
    pairs = np.concatenate([src_pyr, tgt_pyr], axis=0)
    swap_masks = points_in_pyramids_mask(points, pairs)
    remain = points[np.logical_not(swap_masks.any(-1))]

    out = []
    npairs = src_pyr.shape[0]
    for i in range(npairs):
        src_pts = points[swap_masks[:, i]]
        tgt_pts = points[swap_masks[:, i + npairs]]

        def iratio(p):
            lo, hi = p[:, -1:].min(), p[:, -1:].max()
            return (p[:, -1:] - lo) / np.clip(hi - lo, 1e-6, 1), hi, lo

        sr, smax, smin = iratio(src_pts)
        tr, tmax, tmin = iratio(tgt_pts)
        new_src = recover(
            _pyramid_ratios(tgt_pts, tgt_pyr[i]), src_pyr[i]
        )
        new_tgt = recover(_pyramid_ratios(src_pts, src_pyr[i]), tgt_pyr[i])
        new_src = np.concatenate(
            [new_src, tr * (smax - smin) + smin], axis=1
        )
        new_tgt = np.concatenate(
            [new_tgt, sr * (tmax - tmin) + tmin], axis=1
        )
        out.append(new_src.astype(points.dtype))
        out.append(new_tgt.astype(points.dtype))
    points = np.concatenate([remain] + out, axis=0)
    return gt_boxes, points
