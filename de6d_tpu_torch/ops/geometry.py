"""Box geometry of the ported slices (counterpart of
``de6d_tpu/ops/geometry.py``: ``limit_period``, ``angles_to_matrix``,
``boxes_to_rotation_matrix``, ``rotate_points_along_z``,
``boxes_to_corners_3d``, ``boxes_to_corners_bev``,
``points_in_boxes_mask``, ``points_in_boxes_index``, ``enlarge_box3d``,
and the rotation conversions ``matrix_to_quat``, ``matrix_to_rotvec``,
``rotvec_to_matrix``, ``matrix_to_euler_zyx``, ``rotvec_to_euler_zyx``,
``euler_zyx_to_rotvec``).

7-DoF box: ``[x, y, z, dx, dy, dz, yaw]``, yaw counter-clockwise about
+z; 9-DoF box: ``[..., yaw, pitch, roll]`` with ``R = Rx(roll) @
Ry(pitch) @ Rz(yaw)``. Arithmetic is fp32, written out elementwise so
every product and sum rounds on its own (the CUDA NMS kernels read
corners made here). Where jitted XLA on the CPU rounds otherwise, the
same steps are taken here: its ``rotate_points_along_z`` fuses the
second product into the sum (computed in float64 and rounded once); in
the containment test its rotation matrix fuses one product of each
two-term entry, and its box-frame z fuses both (x and y do not).

Containment decides every training target, so its sines and cosines
are the ones XLA's CPU backend calls (glibc's ``sinf`` / ``cosf``:
:func:`sin32`, :func:`cos32`), which differ from ``torch.sin`` /
``torch.cos`` in the last bit for ~5 % of arguments.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .ball_query import _fma

# box-frame corner template in the JAX package's order: the bottom face
# 0:(+x,+y) 1:(+x,-y) 2:(-x,-y) 3:(-x,+y), then the top face likewise
CORNER_TEMPLATE = np.array(
    [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
     [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], np.float32) / 2.0
CORNER_TEMPLATE_BEV = np.array(
    [[0.5, 0.5], [0.5, -0.5], [-0.5, -0.5], [-0.5, 0.5]], np.float32
)


def limit_period(val, offset=0.5, period=2 * math.pi):
    return val - torch.floor(val / period + offset) * period


# glibc's single-precision sine / cosine (sysdeps/ieee754/flt-32
# sincosf): float64 polynomials after a reduction by pi/2 for |x| >= 0.75
_COS_POLY = [float.fromhex(h) for h in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16")]
_SIN_POLY = [float.fromhex(h) for h in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13")]
_HPI_INV_2P24 = float.fromhex("0x1.45F306DC9C883p+23")  # 2/pi * 2^24
_HPI = float.fromhex("0x1.921FB54442D18p0")


def _sin_poly(x, x2):
    x3 = x * x2
    s1 = _SIN_POLY[1] + x2 * _SIN_POLY[2]
    return (x + x3 * _SIN_POLY[0]) + (x3 * x2) * s1


def _cos_poly(x2, sign=1.0):
    c0, c1, c2, c3, c4 = (sign * c for c in _COS_POLY)
    x4 = x2 * x2
    return ((c0 + x2 * c1) + x4 * c2) + (x4 * x2) * (c3 + x2 * c4)


def _sincos32(y, cosine: bool):
    """glibc ``cosf`` / ``sinf`` of fp32 ``y``, bit for bit for |y| < 120
    (glibc reduces larger arguments otherwise; there ``torch.cos`` /
    ``torch.sin`` answer, and no box angle comes near)."""
    y = y.float()
    x = y.double()
    top = (y.view(torch.int32) & 0x7FFFFFFF) >> 20  # exponent, 3 bits
    small = top < (0x3F490FDB >> 20)  # |y| < 0.75
    tiny = top < (0x39800000 >> 20)  # |y| < 2^-12
    n = (torch.trunc(x * _HPI_INV_2P24).long() + 0x800000) >> 24
    xr = x - n.double() * _HPI
    q = n & 3
    xs = torch.where((q == 1) | (q == 2), -xr, xr)
    x2r = xr * xr
    odd = (n & 1) == 1 if not cosine else (n & 1) == 0  # cosine poly
    neg = (n & 2) != 0
    red = torch.where(odd, torch.where(neg, _cos_poly(x2r, -1.0),
                                       _cos_poly(x2r)), _sin_poly(xs, x2r))
    if cosine:
        direct = torch.where(tiny, torch.ones_like(x), _cos_poly(x * x))
    else:
        direct = torch.where(tiny, x, _sin_poly(x, x * x))
    out = torch.where(small, direct, red).float()
    far = torch.cos(y) if cosine else torch.sin(y)
    return torch.where(y.abs() < 120.0, out, far)


def cos32(y):
    """fp32 cosine as XLA's CPU backend computes it (glibc ``cosf``)."""
    return _sincos32(y, True)


def sin32(y):
    """fp32 sine as XLA's CPU backend computes it (glibc ``sinf``)."""
    return _sincos32(y, False)


def angles_to_matrix(yaw, pitch=None, roll=None):
    """Euler → (..., 3, 3), ``R = Rx(roll) @ Ry(pitch) @ Rz(yaw)``,
    rounded as jitted XLA computes the JAX package's: glibc trig, and the
    two-term entries with their first product fused."""
    pitch = torch.zeros_like(yaw) if pitch is None else pitch
    roll = torch.zeros_like(yaw) if roll is None else roll
    cz, sz = cos32(yaw), sin32(yaw)
    cy, sy = cos32(pitch), sin32(pitch)
    cx, sx = cos32(roll), sin32(roll)
    sxsy, cxsy = sx * sy, cx * sy
    rot = torch.stack([
        cy * cz, -cy * sz, sy,
        _fma(cx, sz, sxsy * cz), _fma(cx, cz, -(sxsy * sz)), -sx * cy,
        _fma(sx, sz, -(cxsy * cz)), _fma(sx, cz, cxsy * sz), cx * cy,
    ], dim=-1)
    return rot.reshape(*yaw.shape, 3, 3)


def matrix_to_quat(rot):
    """(..., 3, 3) → (..., 4) unit quaternion (w, x, y, z): of the four
    candidates, each stable where its own component is largest, the one
    with the largest ``sqrt(max(1e-12, 1 ± ...)) / 2`` (the first on ties),
    then normalised."""
    m = [[rot[..., i, j] for j in range(3)] for i in range(3)]

    def half_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) / 2

    tr = (m[0][0] + m[1][1]) + m[2][2]
    qw = half_sqrt(1 + tr)
    qx = half_sqrt(((1 + m[0][0]) - m[1][1]) - m[2][2])
    qy = half_sqrt(((1 - m[0][0]) + m[1][1]) - m[2][2])
    qz = half_sqrt(((1 - m[0][0]) - m[1][1]) + m[2][2])
    c0 = [qw, (m[2][1] - m[1][2]) / (4 * qw), (m[0][2] - m[2][0]) / (4 * qw),
          (m[1][0] - m[0][1]) / (4 * qw)]
    c1 = [(m[2][1] - m[1][2]) / (4 * qx), qx, (m[0][1] + m[1][0]) / (4 * qx),
          (m[0][2] + m[2][0]) / (4 * qx)]
    c2 = [(m[0][2] - m[2][0]) / (4 * qy), (m[0][1] + m[1][0]) / (4 * qy), qy,
          (m[1][2] + m[2][1]) / (4 * qy)]
    c3 = [(m[1][0] - m[0][1]) / (4 * qz), (m[0][2] + m[2][0]) / (4 * qz),
          (m[1][2] + m[2][1]) / (4 * qz), qz]
    pick = torch.argmax(torch.stack([qw, qx, qy, qz], -1), dim=-1)
    cands = torch.stack([torch.stack(c, -1) for c in (c0, c1, c2, c3)], -2)
    q = torch.gather(cands, -2, pick[..., None, None].expand(
        *pick.shape, 1, 4))[..., 0, :]
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def matrix_to_rotvec(rot):
    """(..., 3, 3) → (..., 3) axis-angle, the angle in [0, pi] (scipy's
    ``as_rotvec``); below a sine of 1e-8 the vector is twice the
    quaternion's imaginary part."""
    q = matrix_to_quat(rot)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    s = torch.linalg.norm(q[..., 1:], dim=-1)
    angle = 2 * torch.atan2(s, q[..., 0])
    tiny = s < 1e-8
    scale = torch.where(tiny, 2.0, angle / torch.where(tiny, 1.0, s))
    return q[..., 1:] * scale[..., None]


def rotvec_to_matrix(v):
    """(..., 3) axis-angle → (..., 3, 3) (Rodrigues); below an angle of
    1e-8 the first-order ``I + skew(v)``."""
    theta = torch.linalg.norm(v, dim=-1, keepdim=True)
    small = theta[..., 0] < 1e-8
    axis = v / torch.where(theta < 1e-8, 1.0, theta)
    x, y, z = axis.unbind(-1)
    c, s = torch.cos(theta[..., 0]), torch.sin(theta[..., 0])
    one_c = 1 - c
    rot = torch.stack([
        c + x * x * one_c, x * y * one_c - z * s, x * z * one_c + y * s,
        y * x * one_c + z * s, c + y * y * one_c, y * z * one_c - x * s,
        z * x * one_c - y * s, z * y * one_c + x * s, c + z * z * one_c,
    ], -1).reshape(*v.shape[:-1], 3, 3)
    zero = torch.zeros_like(x)
    eye_skew = torch.stack([
        zero + 1, -v[..., 2], v[..., 1],
        v[..., 2], zero + 1, -v[..., 0],
        -v[..., 1], v[..., 0], zero + 1,
    ], -1).reshape(rot.shape)
    return torch.where(small[..., None, None], eye_skew, rot)


def matrix_to_euler_zyx(rot):
    """(..., 3, 3) → (yaw, pitch, roll) of ``R = Rx(roll) @ Ry(pitch) @
    Rz(yaw)`` (scipy's ``as_euler('zyx')`` for such matrices)."""
    pitch = torch.asin(torch.clamp(rot[..., 0, 2], -1.0, 1.0))
    yaw = torch.atan2(-rot[..., 0, 1], rot[..., 0, 0])
    roll = torch.atan2(-rot[..., 1, 2], rot[..., 2, 2])
    return yaw, pitch, roll


def rotvec_to_euler_zyx(v):
    """(..., 3) axis-angle → (..., 3) stacked (yaw, pitch, roll)."""
    return torch.stack(matrix_to_euler_zyx(rotvec_to_matrix(v)), dim=-1)


def euler_zyx_to_rotvec(yaw, pitch, roll):
    """Euler (zyx) → (..., 3) axis-angle, through :func:`angles_to_matrix`
    (glibc-rounded trig, as jitted XLA computes the JAX package's)."""
    return matrix_to_rotvec(angles_to_matrix(yaw, pitch, roll))


def boxes_to_rotation_matrix(boxes):
    """(..., 7 | 9+) boxes → (..., 3, 3): yaw, pitch, roll for 9+ columns,
    the yaw alone for 7 (the same matrix, its zeros exact)."""
    if boxes.shape[-1] >= 9:
        return angles_to_matrix(boxes[..., 6], boxes[..., 7], boxes[..., 8])
    return angles_to_matrix(boxes[..., 6])


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


def boxes_to_corners_3d(boxes):
    """(N, 7+) yaw-only boxes → (N, 8, 3) corners in the JAX package's
    order (bottom face 0-3, top face 4-7)."""
    t = torch.as_tensor(CORNER_TEMPLATE, device=boxes.device,
                        dtype=boxes.dtype)
    local = boxes[:, None, 3:6] * t[None]  # (N, 8, 3)
    c = torch.cos(boxes[:, 6])[:, None]
    s = torch.sin(boxes[:, 6])[:, None]
    x = c * local[..., 0] - s * local[..., 1] + boxes[:, None, 0]
    y = s * local[..., 0] + c * local[..., 1] + boxes[:, None, 1]
    return torch.stack([x, y, local[..., 2] + boxes[:, None, 2]], dim=-1)


def points_in_boxes_mask(points, boxes):
    """Oriented-box containment, 7- or 9-DoF, boundary inclusive
    (``|local| <= half + 1e-6``): points (..., N, 3+), boxes (..., M, 7 |
    9+) → (..., M, N) bool. The box-frame coordinates are ``R^T (p - c)``
    (:func:`boxes_to_rotation_matrix`), x and y with each product and sum
    rounded on its own, z with both later products fused, as jitted XLA
    rounds the JAX package's einsum at these shapes."""
    d = points[..., None, :, :3] - boxes[..., :, None, 0:3]  # (..., M, N, 3)
    rot = boxes_to_rotation_matrix(boxes)[..., None, :, :]  # (..., M, 1, 3, 3)
    half = boxes[..., :, None, 3:6] / 2.0 + 1e-6
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    lx = (rot[..., 0, 0] * dx + rot[..., 1, 0] * dy) + rot[..., 2, 0] * dz
    ly = (rot[..., 0, 1] * dx + rot[..., 1, 1] * dy) + rot[..., 2, 1] * dz
    lz = _fma(rot[..., 2, 2], dz, _fma(rot[..., 1, 2], dy,
                                       rot[..., 0, 2] * dx))
    return ((lx.abs() <= half[..., 0]) & (ly.abs() <= half[..., 1])
            & (lz.abs() <= half[..., 2]))


def points_in_boxes_index(points, boxes, valid_mask=None):
    """(..., N, 3+), (..., M, 7 | 9+) → (..., N) int32 index of the
    containing box, -1 if none; where boxes overlap the last one wins.
    ``valid_mask`` (..., M) drops boxes."""
    mask = points_in_boxes_mask(points, boxes)  # (..., M, N)
    if valid_mask is not None:
        mask = mask & valid_mask[..., :, None]
    idx = torch.arange(boxes.shape[-2], dtype=torch.int32,
                       device=boxes.device)[:, None]
    return torch.where(mask, idx, -1).amax(dim=-2).to(torch.int32)


def enlarge_box3d(boxes, extra_width):
    """Grow (dx, dy, dz) by twice ``extra_width``."""
    extra = torch.as_tensor(extra_width, dtype=boxes.dtype,
                            device=boxes.device)
    return torch.cat([boxes[..., :3], boxes[..., 3:6] + 2.0 * extra,
                      boxes[..., 6:]], dim=-1)
