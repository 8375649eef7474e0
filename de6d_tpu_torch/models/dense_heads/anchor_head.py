"""Anchor-based dense head (counterpart of
``de6d_tpu/models/dense_heads/anchor_head.py``: ``AnchorHeadSingle``,
``decode_boxes_with_dir``, ``add_sin_difference``,
``get_direction_target``, ``anchor_head_loss``).

In train mode (``self.training``) the head writes the raw predictions in
the JAX order, ``cls_preds`` (B, A, num_class), ``box_preds`` (B, A, 7)
and ``dir_cls_preds`` (B, A, bins) with A ordered (h, w, anchor of the
location), in fp32, and the targets of the dense assigner
(``axis_aligned_assigner.assign_targets``, no gradient); it decodes
nothing unless a RoI head follows (below). The windowed and ATSS
assigners and height matching are not ported: the head raises
``NotImplementedError`` on a config that asks for them.

Alone, the head hands ``post_processing`` a lazy decode (the candidates'
rows only). With ``predict_boxes_when_training`` (set when a RoI head
follows), it decodes every anchor into ``batch_box_preds``, in eval and
in train mode, and writes no lazy dict, as the JAX head does: the
proposal layer reads those boxes.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ...ops import geometry
from ...ops.ball_query import _fma
from ...registry import DENSE_HEADS
from ...utils import box_coder_utils, loss_utils
from ..model_utils.dtype_utils import compute_dtype
from ..model_utils.layers import Conv, constant, normal
from . import anchor_generator
from .axis_aligned_assigner import assign_targets

# jitted XLA multiplies by the fp32 reciprocal of 2 pi (and of a bin's
# width) where the JAX code divides, and fuses ``r - k * 2pi`` into one
# FMA; the bins at their edges follow that rounding
_TWO_PI32 = float(np.float32(2 * math.pi))
_INV_TWO_PI32 = float(np.float32(1.0) / np.float32(2 * math.pi))


def decode_boxes_with_dir(coder, dir_cfg, box_preds, dir_preds, anchors):
    """Residual decode + direction-bin yaw correction on matching
    (..., S) / (..., 7+) shapes; fp32."""
    batch_box = coder.decode(box_preds, anchors)
    if dir_preds is not None and dir_cfg is not None:
        dir_offset, dir_limit, num_bins = dir_cfg
        dir_labels = torch.argmax(dir_preds, dim=-1)
        period = 2 * math.pi / num_bins
        yaw = geometry.limit_period(
            batch_box[..., 6] - dir_offset, dir_limit, period
        )
        yaw = yaw + dir_offset + period * dir_labels.to(yaw.dtype)
        batch_box = torch.cat(
            [batch_box[..., :6], yaw[..., None], batch_box[..., 7:]], dim=-1
        )
    return batch_box


def add_sin_difference(preds, targets, dim: int = 6):
    """sin(a - b) = sin(a)cos(b) - cos(a)sin(b) split between the yaw code
    of the predictions and of the targets."""
    rad_p = torch.sin(preds[..., dim:dim + 1]) * torch.cos(
        targets[..., dim:dim + 1])
    rad_t = torch.cos(preds[..., dim:dim + 1]) * torch.sin(
        targets[..., dim:dim + 1])
    p = torch.cat([preds[..., :dim], rad_p, preds[..., dim + 1:]], dim=-1)
    t = torch.cat([targets[..., :dim], rad_t, targets[..., dim + 1:]], dim=-1)
    return p, t


def get_direction_target(anchors, reg_targets, dir_offset: float,
                         num_bins: int):
    """(B or 1, A, 7+) anchors + (B, A, 7+) reg targets → (B, A) int64
    direction bins."""
    rot_gt = reg_targets[..., 6] + anchors[..., 6]
    offset_rot = rot_gt - dir_offset
    k = torch.floor(offset_rot * _INV_TWO_PI32)
    offset_rot = _fma(-k, torch.full_like(k, _TWO_PI32), offset_rot)
    inv_width = float(np.float32(1.0) / np.float32(2 * math.pi / num_bins))
    bins = torch.floor(offset_rot * inv_width).long()
    return torch.clamp(bins, 0, num_bins - 1)


@DENSE_HEADS.register
class AnchorHeadSingle(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, class_names,
                 grid_size, point_cloud_range,
                 predict_boxes_when_training=False):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.predict_boxes_when_training = predict_boxes_when_training
        tgt_cfg = model_cfg["TARGET_ASSIGNER_CONFIG"]
        self.box_coder = box_coder_utils.build_box_coder(
            tgt_cfg["BOX_CODER"], **dict(tgt_cfg.get("BOX_CODER_CONFIG", {}))
        )
        anchors, groups, matched, unmatched, a_loc = (
            anchor_generator.generate_anchors(
                model_cfg["ANCHOR_GENERATOR_CONFIG"], grid_size,
                point_cloud_range))
        self.num_anchors_per_location = a_loc
        self.register_buffer(
            "anchors", torch.from_numpy(anchors.reshape(-1, anchors.shape[-1])),
            persistent=False,
        )
        # per-anchor class group and thresholds, in the anchors' order
        cells = anchors.shape[0] * anchors.shape[1]
        for name, arr in (("anchor_group", groups), ("matched_thr", matched),
                          ("unmatched_thr", unmatched)):
            self.register_buffer(name, torch.from_numpy(np.tile(arr, cells)),
                                 persistent=False)
        dt = compute_dtype(model_cfg)
        # flax's initialisers of the JAX head: the focal prior pi = 0.01 on
        # the class bias, a small normal on the box kernel
        self.conv_cls = Conv(
            input_channels, a_loc * num_class, 1, dtype=dt,
            bias_init=constant(-np.log((1 - 0.01) / 0.01)),
        )
        self.conv_box = Conv(
            input_channels, a_loc * self.box_coder.code_size, 1, dtype=dt,
            kernel_init=normal(0.001),
        )
        self.use_dir = model_cfg.get("USE_DIRECTION_CLASSIFIER", False)
        self.num_dir_bins = int(model_cfg.get("NUM_DIR_BINS", 2))
        if self.use_dir:
            self.conv_dir = Conv(
                input_channels, a_loc * self.num_dir_bins, 1, dtype=dt
            )

    def dir_cfg(self):
        if not self.use_dir:
            return None
        return (
            float(self.model_cfg.get("DIR_OFFSET", 0.78539)),
            float(self.model_cfg.get("DIR_LIMIT_OFFSET", 0.0)),
            self.num_dir_bins,
        )

    def forward(self, batch_dict):
        x = batch_dict["spatial_features_2d"]  # (B, H, W, C) NHWC view
        b, h, w = x.shape[0], x.shape[1], x.shape[2]
        x = x.permute(0, 3, 1, 2)

        def head(conv):  # raw predictions back to fp32, NHWC cell rows
            return conv(x).float().permute(0, 2, 3, 1).reshape(b, h * w, -1)

        cls_cell = head(self.conv_cls)
        box_cell = head(self.conv_box)
        dir_cell = head(self.conv_dir) if self.use_dir else None
        if self.training:
            batch_dict = self.training_targets(batch_dict, cls_cell,
                                               box_cell, dir_cell)
            if not self.predict_boxes_when_training:
                return batch_dict
        batch_dict["batch_cls_preds"] = cls_cell.reshape(b, -1, self.num_class)
        batch_dict["cls_preds_normalized"] = False
        if self.predict_boxes_when_training:
            # a RoI head follows, in eval and in train mode: every anchor
            # decoded, (B, A, 7)
            code = self.box_coder.code_size
            dir_preds = (None if dir_cell is None
                         else dir_cell.reshape(b, -1, self.num_dir_bins))
            batch_dict["batch_box_preds"] = decode_boxes_with_dir(
                self.box_coder, self.dir_cfg(), box_cell.reshape(b, -1, code),
                dir_preds, self.anchors[None])
            return batch_dict
        # post_processing decodes only the top-`pre` candidates; the full
        # (B, A, 7) decode of every anchor is never built
        batch_dict["lazy_box_decode"] = {
            "raw_cell": box_cell,
            "dir_cell": dir_cell,
            "anchors_cell": self.anchors.reshape(h * w, -1),
            "a_loc": self.num_anchors_per_location,
            "code_size": self.box_coder.code_size,
            "coder": self.box_coder,
            "dir_cfg": self.dir_cfg(),
        }
        return batch_dict

    def training_targets(self, batch_dict, cls_cell, box_cell, dir_cell):
        """The train-mode outputs: raw (B, A, ·) predictions, the anchors
        and the dense assigner's targets for ``gt_boxes``."""
        tgt_cfg = self.model_cfg["TARGET_ASSIGNER_CONFIG"]
        for key, asks in (
            ("NAME", str(tgt_cfg.get("NAME")) == "ATSSTargetAssigner"),
            ("WINDOWED_ASSIGN", bool(tgt_cfg.get("WINDOWED_ASSIGN", False))),
            ("MATCH_HEIGHT", bool(tgt_cfg.get("MATCH_HEIGHT", False))),
        ):
            if asks:
                raise NotImplementedError(
                    f"AnchorHeadSingle: TARGET_ASSIGNER_CONFIG.{key} = "
                    f"{tgt_cfg.get(key)!r} is not ported; the port trains "
                    "with the dense axis-aligned assigner (nearest-BEV IoU)")
        b = cls_cell.shape[0]
        batch_dict["cls_preds"] = cls_cell.reshape(b, -1, self.num_class)
        batch_dict["box_preds"] = box_cell.reshape(
            b, -1, self.box_coder.code_size)
        batch_dict["dir_cls_preds"] = (
            None if dir_cell is None
            else dir_cell.reshape(b, -1, self.num_dir_bins))
        batch_dict["anchors"] = self.anchors
        batch_dict.update(assign_targets(
            self.anchors, self.anchor_group, self.matched_thr,
            self.unmatched_thr, batch_dict["gt_boxes"].detach(),
            self.box_coder))
        return batch_dict


def anchor_head_loss(batch_dict, loss_cfg, num_class: int,
                     dir_cfg: dict | None = None):
    """Focal classification + sin-difference smooth-L1 regression +
    direction cross-entropy, each normalised by the sample's positives
    and averaged over the batch. Returns (total, dict of scalar terms)."""
    cls_preds = batch_dict["cls_preds"]
    box_preds = batch_dict["box_preds"]
    dir_preds = batch_dict.get("dir_cls_preds")
    labels = batch_dict["box_cls_labels"].long()  # (B, A)
    reg_targets = batch_dict["box_reg_targets"]
    anchors = batch_dict["anchors"]  # (A, 7)
    b = cls_preds.shape[0]
    weights = loss_cfg["LOSS_WEIGHTS"]

    cared = labels >= 0
    positives = labels > 0
    negatives = labels == 0
    pos_w = float(weights.get("pos_cls_weight", 1.0))
    neg_w = float(weights.get("neg_cls_weight", 1.0))
    cls_weights = neg_w * negatives.float() + pos_w * positives.float()
    reg_weights = positives.float()
    pos_norm = torch.clamp(positives.sum(1, keepdim=True).float(), min=1.0)
    cls_weights = cls_weights / pos_norm
    reg_weights = reg_weights / pos_norm

    cls_targets = torch.where(cared, labels, 0)
    if num_class == 1:
        cls_targets = torch.where(positives, 1, cls_targets)
    one_hot = torch.nn.functional.one_hot(
        cls_targets, num_class + 1)[..., 1:].float()
    cls_loss = loss_utils.sigmoid_focal_loss(cls_preds, one_hot,
                                             weights=cls_weights)
    cls_loss = cls_loss.sum() / b * float(weights["cls_weight"])

    preds_sin, targets_sin = add_sin_difference(box_preds, reg_targets)
    loc_loss = loss_utils.smooth_l1_loss(
        preds_sin, targets_sin, weights=reg_weights,
        code_weights=weights["code_weights"])
    loc_loss = loc_loss.sum() / b * float(weights["loc_weight"])

    tb = {"rpn_loss_cls": cls_loss, "rpn_loss_loc": loc_loss}
    total = cls_loss + loc_loss
    if dir_preds is not None and dir_cfg is not None:
        num_bins = int(dir_cfg["NUM_DIR_BINS"])
        dir_targets = get_direction_target(
            anchors[None], reg_targets,
            dir_offset=float(dir_cfg.get("DIR_OFFSET", 0.78539)),
            num_bins=num_bins)
        dir_onehot = torch.nn.functional.one_hot(dir_targets, num_bins).float()
        w = positives.float()
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1.0)
        dir_loss = loss_utils.softmax_cross_entropy(dir_preds, dir_onehot,
                                                    weights=w)
        dir_loss = dir_loss.sum() / b * float(weights["dir_weight"])
        total = total + dir_loss
        tb["rpn_loss_dir"] = dir_loss
    tb["rpn_loss"] = total
    return total, tb
