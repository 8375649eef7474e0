"""Box coders (counterpart of ``de6d_tpu/utils/box_coder_utils.py``):
``ResidualCoder`` (anchor heads, RoI heads), and both ways of
``PointResidualCoder`` (PointRCNN's first stage, Det6D's direct-regression
head), ``PointResidual_BinOri_Coder`` (the IA-SSD head),
``PointBinResidualCoder`` (the 3DSSD / SASA vote head) and
``PointBinResidual6DCoder`` (the Det6D vote head).

The encodes feed training targets, so the yaw bins and the pitch class
round as jitted XLA computes the JAX code on the CPU: it multiplies by
the fp32 reciprocal where the code divides by a constant, and fuses
``k * width + width / 2`` into one FMA (computed here in float64 and
rounded once).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.ball_query import _fma
from ..ops.geometry import cos32, sin32
from ..registry import BOX_CODERS


def _clamp_sizes(boxes):
    """Sizes (columns 3-5) clamped at 1e-5."""
    return torch.cat([boxes[..., :3], torch.clamp(boxes[..., 3:6], min=1e-5),
                      boxes[..., 6:]], dim=-1)


@BOX_CODERS.register
class ResidualCoder:
    """7-DoF anchor residuals (optionally sin/cos-encoded yaw)."""

    def __init__(self, code_size=7, encode_angle_by_sincos=False, **kwargs):
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes, anchors):
        """boxes/anchors: (..., 7+C) → (..., code_size)."""
        anchors = _clamp_sizes(anchors)
        boxes = _clamp_sizes(boxes)
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
        ra = anchors[..., 6]
        xg, yg, zg = boxes[..., 0], boxes[..., 1], boxes[..., 2]
        dxg, dyg, dzg = boxes[..., 3], boxes[..., 4], boxes[..., 5]
        rg = boxes[..., 6]

        diag = torch.sqrt(dxa * dxa + dya * dya)
        parts = [
            (xg - xa) / diag,
            (yg - ya) / diag,
            (zg - za) / dza,
            torch.log(dxg / dxa),
            torch.log(dyg / dya),
            torch.log(dzg / dza),
        ]
        if self.encode_angle_by_sincos:
            parts += [torch.cos(rg) - torch.cos(ra),
                      torch.sin(rg) - torch.sin(ra)]
        else:
            parts += [rg - ra]
        extras = [boxes[..., i] - anchors[..., i]
                  for i in range(7, boxes.shape[-1])]
        return torch.stack(parts + extras, dim=-1)

    def decode(self, encodings, anchors):
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
        ra = anchors[..., 6]
        xt, yt, zt = encodings[..., 0], encodings[..., 1], encodings[..., 2]
        dxt, dyt, dzt = encodings[..., 3], encodings[..., 4], encodings[..., 5]

        diag = torch.sqrt(dxa * dxa + dya * dya)
        xg = xt * diag + xa
        yg = yt * diag + ya
        zg = zt * dza + za
        dxg = torch.exp(dxt) * dxa
        dyg = torch.exp(dyt) * dya
        dzg = torch.exp(dzt) * dza
        if self.encode_angle_by_sincos:
            rg = torch.atan2(
                encodings[..., 7] + torch.sin(ra),
                encodings[..., 6] + torch.cos(ra),
            )
            extra_start = 8
        else:
            rg = encodings[..., 6] + ra
            extra_start = 7
        extras = [
            encodings[..., extra_start + i] + anchors[..., 7 + i]
            for i in range(anchors.shape[-1] - 7)
        ]
        return torch.stack(
            [xg, yg, zg, dxg, dyg, dzg, rg] + extras, dim=-1
        )


def _point_offsets_decode(offsets, points, mean_size=None,
                          pred_classes=None):
    """Point-anchored centers and sizes: offsets (..., 6+) + points
    (..., 3) → [x, y, z, dx, dy, dz]. With ``mean_size`` (classes, 3)
    the offsets are relative to the predicted class's mean box
    (``pred_classes`` 1-based)."""
    xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
    xt, yt, zt = offsets[..., 0], offsets[..., 1], offsets[..., 2]
    dxt, dyt, dzt = offsets[..., 3], offsets[..., 4], offsets[..., 5]
    if mean_size is None:
        return [xt + xa, yt + ya, zt + za,
                torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)]
    anchor = mean_size.to(offsets.device)[pred_classes - 1]
    dxa, dya, dza = anchor[..., 0], anchor[..., 1], anchor[..., 2]
    diag = torch.sqrt(dxa * dxa + dya * dya)
    return [xt * diag + xa, yt * diag + ya, zt * dza + za,
            torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza]


def _point_offsets_encode(gt_boxes, points, mean_size=None,
                          gt_classes=None):
    """The six offsets of the point coders: centre residuals and log sizes
    (relative to the gt class's mean box with ``mean_size``, classes
    1-based)."""
    xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
    if mean_size is None:
        return [gt_boxes[..., 0] - xa, gt_boxes[..., 1] - ya,
                gt_boxes[..., 2] - za, torch.log(gt_boxes[..., 3]),
                torch.log(gt_boxes[..., 4]), torch.log(gt_boxes[..., 5])]
    anchor = mean_size.to(points.device)[gt_classes.long() - 1]
    dxa, dya, dza = anchor[..., 0], anchor[..., 1], anchor[..., 2]
    diag = torch.sqrt(dxa * dxa + dya * dya)
    return [(gt_boxes[..., 0] - xa) / diag, (gt_boxes[..., 1] - ya) / diag,
            (gt_boxes[..., 2] - za) / dza, torch.log(gt_boxes[..., 3] / dxa),
            torch.log(gt_boxes[..., 4] / dya),
            torch.log(gt_boxes[..., 5] / dza)]


def _f32(x):
    return float(np.float32(x))


def _recip32(x):
    """The fp32 reciprocal of the fp32 constant ``x``, as XLA folds it."""
    return float(np.float32(1.0) / np.float32(x))


def _mod(x, period: float):
    """Python's modulus (sign of the divisor): fmod, then + period where
    the remainder is negative, as ``jnp.mod`` computes it."""
    r = torch.fmod(x, period)
    return torch.where(r < 0, r + period, r)


def encode_angle_to_bins(angle, num_bins: int):
    """Angle → (one-hot bin (..., bins), per-bin residual in [-0.5, 0.5]
    at the hot bin, 0 elsewhere)."""
    two_pi = _f32(2.0 * math.pi)
    per = _f32(2.0 * math.pi / num_bins)
    half = _f32(2.0 * math.pi / num_bins / 2.0)
    inv = _recip32(per)
    angle = _mod(angle.float(), two_pi)
    shifted = _mod(angle + half, two_pi)
    cls_f = torch.floor(shifted * inv)
    centre = _fma(cls_f, torch.full_like(cls_f, per),
                  torch.full_like(cls_f, half))
    res = (shifted - centre) * inv
    onehot = torch.nn.functional.one_hot(cls_f.long(), num_bins).to(
        angle.dtype)
    return onehot, onehot * res[..., None]


def _mean_size(use_mean_size, mean_size):
    """(classes, 3) per-class mean box sizes, or None."""
    if not use_mean_size:
        return None
    mean_size = torch.tensor(mean_size, dtype=torch.float32)
    if not float(mean_size.min()) > 0:
        raise ValueError("point box coder: mean sizes must be > 0")
    return mean_size


@BOX_CODERS.register
class PointResidualCoder:
    """8-column point-to-box code with cos/sin yaw: 6 offsets (relative to
    per-class mean sizes when ``use_mean_size``), then cos and sin of the
    yaw; further columns pass through."""

    def __init__(self, code_size=8, use_mean_size=True, mean_size=None,
                 **kwargs):
        self.code_size = code_size
        self.mean_size = _mean_size(use_mean_size, mean_size)

    def encode(self, gt_boxes, points, gt_classes=None):
        """gt boxes (..., 7+) at points (..., 3) → (..., 8 + extras); the
        yaw's cosine and sine are glibc's (as jitted XLA's on the CPU)."""
        gt_boxes = _clamp_sizes(gt_boxes)
        parts = _point_offsets_encode(gt_boxes, points, self.mean_size,
                                      gt_classes)
        rg = gt_boxes[..., 6]
        parts += [cos32(rg), sin32(rg)]
        parts += [gt_boxes[..., i] for i in range(7, gt_boxes.shape[-1])]
        return torch.stack(parts, dim=-1)

    def decode(self, encodings, points, pred_classes=None):
        out = _point_offsets_decode(encodings, points, self.mean_size,
                                    pred_classes)
        out.append(torch.atan2(encodings[..., 7], encodings[..., 6]))
        out += [encodings[..., i] for i in range(8, encodings.shape[-1])]
        return torch.stack(out, dim=-1)


def decode_angle_from_bins(cls_logits, res):
    """(..., bins) bin scores + per-bin residuals → angle: (first argmax
    bin + its residual) * 2π / bins."""
    num_bins = cls_logits.shape[-1]
    idx = torch.argmax(cls_logits, dim=-1)
    res_sel = torch.gather(res, -1, idx[..., None])[..., 0]
    return (idx.to(res.dtype) + res_sel) * (2.0 * math.pi / num_bins)


@BOX_CODERS.register
class PointBinResidualCoder:
    """Yaw bin classification + residual point coder (3DSSD / SASA).
    Code: [6 offsets | yaw bin cls x B | yaw bin res x B | velocity x 2
    (``pred_velo``)]; decode gives (..., 7) plus the columns past the
    bins."""

    def __init__(self, use_mean_size=True, mean_size=None, angle_bin_num=12,
                 pred_velo=False, **kwargs):
        self.mean_size = _mean_size(use_mean_size, mean_size)
        self.angle_bin_num = angle_bin_num
        self.code_size = 6 + 2 * angle_bin_num + (2 if pred_velo else 0)

    def encode(self, gt_boxes, points, gt_classes=None):
        """gt boxes (..., 7+) at points (..., 3) → (..., code); columns past
        the yaw pass through."""
        gt_boxes = _clamp_sizes(gt_boxes)
        parts = _point_offsets_encode(gt_boxes, points, self.mean_size,
                                      gt_classes)
        onehot, res = encode_angle_to_bins(gt_boxes[..., 6],
                                           self.angle_bin_num)
        return torch.cat([torch.stack(parts, -1), onehot, res,
                          gt_boxes[..., 7:]], dim=-1)

    def decode(self, encodings, points, pred_classes=None):
        nb = self.angle_bin_num
        out = _point_offsets_decode(encodings, points, self.mean_size,
                                    pred_classes)
        out.append(decode_angle_from_bins(encodings[..., 6:6 + nb],
                                          encodings[..., 6 + nb:6 + 2 * nb]))
        return torch.cat([torch.stack(out, dim=-1),
                          encodings[..., 6 + 2 * nb:]], dim=-1)


@BOX_CODERS.register
class PointResidual_BinOri_Coder:
    """IA-SSD bin-orientation point coder. Code: [6 offsets | bin logits x
    B | bin residuals x B], residuals in half bins; the yaw is the chosen
    bin's centre in [-pi, pi) plus its residual. Decode output (..., 7);
    the encode writes the one-hot bin and its residual in the same
    layout."""

    def __init__(self, code_size=8, use_mean_size=True, mean_size=None,
                 bin_size=12, **kwargs):
        self.mean_size = _mean_size(use_mean_size, mean_size)
        self.bin_size = int(bin_size)
        self.code_size = 6 + 2 * self.bin_size
        self.bin_inter = 2 * math.pi / self.bin_size

    def encode(self, gt_boxes, points, gt_classes=None):
        """gt boxes (..., 7+) at points (..., 3) → (..., 6 + 2B): the yaw
        clamped to (-pi, pi) by 1e-5, its bin ``floor((yaw + pi) * 1 /
        inter)`` (the fp32 reciprocal XLA folds the division into) and
        residual ``(yaw + pi - fma(bin, inter, inter / 2)) * 1 / (inter /
        2)``."""
        gt_boxes = _clamp_sizes(gt_boxes)
        parts = _point_offsets_encode(gt_boxes, points, self.mean_size,
                                      gt_classes)
        pi = _f32(math.pi)
        inter, half = _f32(self.bin_inter), _f32(self.bin_inter / 2)
        rg = torch.clamp(gt_boxes[..., 6], _f32(-math.pi + 1e-5),
                         _f32(math.pi - 1e-5))
        shifted = rg + pi
        bin_f = torch.floor(shifted * _recip32(self.bin_inter))
        centre = _fma(bin_f, torch.full_like(bin_f, inter),
                      torch.full_like(bin_f, half))
        res = (shifted - centre) * _recip32(self.bin_inter / 2)
        onehot = torch.nn.functional.one_hot(bin_f.long(), self.bin_size).to(
            rg.dtype)
        return torch.cat([torch.stack(parts, -1), onehot,
                          onehot * res[..., None]], dim=-1)

    def decode(self, encodings, points, pred_classes=None):
        nb = self.bin_size
        out = _point_offsets_decode(encodings, points, self.mean_size,
                                    pred_classes)
        bin_id = torch.argmax(encodings[..., 6:6 + nb], dim=-1)
        res = torch.gather(encodings[..., 6 + nb:6 + 2 * nb], -1,
                           bin_id[..., None])[..., 0]
        rg = (bin_id.to(res.dtype) * self.bin_inter - math.pi
              + self.bin_inter / 2 + res * (self.bin_inter / 2))
        return torch.stack(out + [rg], dim=-1)


@BOX_CODERS.register
class PointBinResidual6DCoder:
    """Det6D ground-aware full-pose point coder. Code: [6 offsets | yaw
    bin cls x B | yaw bin res x B | pitch cls, pitch res (ground aware) or
    pitch]. Ground-aware encode: a pitch below -threshold (``minus``: a
    |pitch| above it) is class 1 with residual ``(-threshold - pitch) /
    factor`` (``minus``: ``pitch / factor``), else class 0 and residual
    0. Decode zeroes the pitch where sigmoid(pitch cls) < 0.5; roll is
    always 0. Decode output (..., 9)."""

    def __init__(self, use_mean_size=True, mean_size=None,
                 ground_aware=True, angle_bin_num=12, minus=False,
                 threshold=10, factor=45, **kwargs):
        self.mean_size = _mean_size(use_mean_size, mean_size)
        self.ground_aware = ground_aware
        self.angle_bin_num = angle_bin_num
        self.minus = minus
        # the JAX package's np.deg2rad constants, rounded to float32 where
        # they meet a tensor
        self.ground_threshold = float(np.deg2rad(threshold))
        self.ground_factor = float(np.deg2rad(factor))
        self.code_size = 6 + 2 * angle_bin_num + (2 if ground_aware else 1)

    def encode_pitch(self, pitch):
        """→ (cls {0, 1}, res) under ground-aware coding, or (pitch,)."""
        if not self.ground_aware:
            return (pitch,)
        thr = _f32(self.ground_threshold)
        inv = _recip32(self.ground_factor)
        if self.minus:
            cls = pitch.abs() > thr
            res = torch.where(cls, pitch * inv, 0.0)
        else:
            cls = pitch < -thr
            res = torch.where(cls, (-thr - pitch) * inv, 0.0)
        return cls.to(pitch.dtype), res

    def decode_pitch_roll(self, code):
        """code (..., 2 | 1) → (pitch, roll) with inference-time gating."""
        if self.ground_aware:
            cls_logit, res = code[..., 0], code[..., 1]
            if self.minus:
                pitch = res * self.ground_factor
            else:
                pitch = -self.ground_threshold - res * self.ground_factor
            pitch = torch.where(torch.sigmoid(cls_logit) < 0.5, 0.0, pitch)
        else:
            pitch = code[..., 0]
        return pitch, torch.zeros_like(pitch)

    def encode(self, gt_boxes, points, gt_classes=None):
        """9-DoF gt boxes (..., 9+: the pitch is column 7) at points
        (..., 3) → (..., code). On 7-column boxes the JAX package's
        ``gt_boxes[..., 7]`` is clamped to the last column, so the yaw
        stands in for the pitch; the port reads the same column."""
        gt_boxes = _clamp_sizes(gt_boxes)
        parts = _point_offsets_encode(gt_boxes, points, self.mean_size,
                                      gt_classes)
        onehot, res = encode_angle_to_bins(gt_boxes[..., 6],
                                           self.angle_bin_num)
        pitch = self.encode_pitch(gt_boxes[..., min(7, gt_boxes.shape[-1]
                                                    - 1)])
        return torch.cat([torch.stack(parts, -1), onehot, res]
                         + [p[..., None] for p in pitch], dim=-1)

    def decode(self, encodings, points, pred_classes=None):
        nb = self.angle_bin_num
        out = _point_offsets_decode(encodings, points, self.mean_size,
                                    pred_classes)
        rz = decode_angle_from_bins(encodings[..., 6:6 + nb],
                                    encodings[..., 6 + nb:6 + 2 * nb])
        pitch, roll = self.decode_pitch_roll(encodings[..., 6 + 2 * nb:])
        return torch.stack(out + [rz, pitch, roll], dim=-1)


def build_box_coder(name, **kwargs):
    return BOX_CODERS.get(name)(**kwargs)
