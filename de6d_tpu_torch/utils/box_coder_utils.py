"""Box coders (counterpart of ``de6d_tpu/utils/box_coder_utils.py``;
the slice needs ``ResidualCoder`` only)."""

from __future__ import annotations

import torch

from ..registry import BOX_CODERS


@BOX_CODERS.register
class ResidualCoder:
    """7-DoF anchor residuals (optionally sin/cos-encoded yaw)."""

    def __init__(self, code_size=7, encode_angle_by_sincos=False, **kwargs):
        self.code_size = code_size + (1 if encode_angle_by_sincos else 0)
        self.encode_angle_by_sincos = encode_angle_by_sincos

    def encode(self, boxes, anchors):
        """boxes/anchors: (..., 7+C) → (..., code_size)."""
        anchors = torch.cat(
            [anchors[..., :3], torch.clamp(anchors[..., 3:6], min=1e-5),
             anchors[..., 6:]], dim=-1,
        )
        boxes = torch.cat(
            [boxes[..., :3], torch.clamp(boxes[..., 3:6], min=1e-5),
             boxes[..., 6:]], dim=-1,
        )
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


def build_box_coder(name, **kwargs):
    return BOX_CODERS.get(name)(**kwargs)
