"""Det6D's direct-regression head, the D.R. row of the paper's ablation
(counterpart of ``de6d_tpu/models/dense_heads/point_head_box6d.py``:
``assign_rot_targets``, ``PointHeadBox6D``, ``point_head_box6d_loss``).

Four FC stacks over the backbone's point features: class logits, the
7-DoF ``PointResidualCoder`` code, a 2-way slope class (has pitch) and a
3-D rotation vector. Eval decode: the code is decoded at the points, the
rotation vector turned into Euler angles, the pitch zeroed where the
slope classifier says flat, and (pitch, roll) appended: 9 columns, the
yaw always the coder's.

Targets: the point targets of ``PointHeadBox`` (containment in the 9-DoF
gt boxes, the ``GT_EXTRA_WIDTH`` ring ignored, the box's first 7 columns
encoded) and the rotation targets (the owning box's Euler angles as a
rotation vector, slope class pitch < -0.1). Loss: the focal class and
smooth-L1 box terms, the rotation vector's mean squared error over the
positives, and a focal (gamma 1) slope class term.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import geometry
from ...registry import POINT_HEADS
from ...utils import box_coder_utils, loss_utils
from ..model_utils.dtype_utils import compute_dtype
from ..model_utils.mlp import FCStack
from .point_head_box import assign_point_targets, point_head_box_loss


@torch.no_grad()
def assign_rot_targets(points, valid, gt_boxes):
    """(B, N, 3) points vs (B, M, 7 | 9 + class) gt boxes → (rot_cls (B,
    N) int32: -1 off the foreground, 1 where the owning box's pitch is
    below -0.1, else 0; rot_reg (B, N, 3): the owning box's (yaw, pitch,
    roll) as a rotation vector, 0 off the foreground).

    On boxes with fewer than 9 columns the JAX package reads columns 7
    and 8 past the row's end, which XLA clamps to the last (the yaw):
    the angles are then (yaw, yaw, yaw), and the port reads the same."""
    boxes = gt_boxes[..., :-1]
    gt_valid = torch.any(boxes[..., :7].abs() > 0, dim=-1)
    idx = geometry.points_in_boxes_index(points, boxes[..., :9], gt_valid)
    fg = (idx >= 0) & valid
    own = torch.gather(boxes, 1, idx.clamp(min=0).long()[..., None].expand(
        -1, -1, boxes.shape[-1]))
    last = boxes.shape[-1] - 1
    pitch, roll = own[..., min(7, last)], own[..., min(8, last)]
    rotvec = geometry.euler_zyx_to_rotvec(own[..., 6], pitch, roll)
    rot_reg = torch.where(fg[..., None], rotvec, 0.0)
    rot_cls = torch.where(fg, (pitch < -0.1).to(torch.int32), -1)
    return rot_cls.to(torch.int32), rot_reg


@POINT_HEADS.register
class PointHeadBox6D(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class,
                 predict_boxes_when_training=False, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.predict_boxes_when_training = predict_boxes_when_training
        target_cfg = model_cfg["TARGET_CONFIG"]
        self.box_coder = box_coder_utils.build_box_coder(
            target_cfg["BOX_CODER"],
            **dict(target_cfg.get("BOX_CODER_CONFIG", {})))
        use_bn = model_cfg.get("USE_BN", True)
        dt = compute_dtype(model_cfg)
        for name, key, out in (
                ("cls_layers", "CLS_FC", num_class),
                ("box_layers", "REG_FC", self.box_coder.code_size),
                ("rot_cls_layers", "ROT_CLS_FC", 2),
                ("rot_reg_layers", "ROT_REG_FC", 3)):
            setattr(self, name, FCStack(input_channels, model_cfg[key], out,
                                        use_bn=use_bn, dtype=dt))

    def forward(self, batch_dict):
        key = ("point_features_before_fusion"
               if self.model_cfg.get("USE_POINT_FEATURES_BEFORE_FUSION",
                                     False) else "point_features")
        feats = batch_dict[key]  # (B, N, C) fp32
        coords = batch_dict["point_coords"]  # (B, N, 3)
        cls_preds = self.cls_layers(feats)  # fp32 raw predictions
        box_preds = self.box_layers(feats)
        rot_cls_preds = self.rot_cls_layers(feats)
        rot_reg_preds = self.rot_reg_layers(feats)
        batch_dict.update(
            point_cls_preds=cls_preds, point_reg_preds=box_preds,
            point_rot_cls_preds=rot_cls_preds,
            point_rot_reg_preds=rot_reg_preds,
            point_cls_scores=torch.sigmoid(cls_preds).amax(dim=-1))
        if self.training:
            valid = batch_dict.get("point_valid")
            if valid is None:
                valid = torch.ones(coords.shape[:2], dtype=torch.bool,
                                   device=coords.device)
            gt = batch_dict["gt_boxes"].detach()
            pts = coords.detach()
            cls_l, reg_l, box_l = assign_point_targets(
                pts, valid, gt,
                extra_width=self.model_cfg["TARGET_CONFIG"].get(
                    "GT_EXTRA_WIDTH"),
                box_coder=self.box_coder, num_class=self.num_class,
                encode_dims=7)
            rot_cls_l, rot_reg_l = assign_rot_targets(pts, valid, gt)
            batch_dict.update(
                point_cls_labels=cls_l, point_reg_labels=reg_l,
                point_box_labels=box_l, point_rot_cls_labels=rot_cls_l,
                point_rot_reg_labels=rot_reg_l)
        if not self.training or self.predict_boxes_when_training:
            boxes7 = self.box_coder.decode(
                box_preds, coords, torch.argmax(cls_preds, dim=-1) + 1)
            euler = geometry.rotvec_to_euler_zyx(rot_reg_preds)
            flat = torch.argmax(rot_cls_preds, dim=-1) == 0
            pitch = torch.where(flat, 0.0, euler[..., 1])
            boxes9 = torch.cat([boxes7, pitch[..., None], euler[..., 2:3]],
                               dim=-1)
            batch_dict.update(batch_cls_preds=cls_preds,
                              batch_box_preds=boxes9,
                              point_box_preds=boxes9,
                              cls_preds_normalized=False)
        return batch_dict


def point_head_box6d_loss(batch_dict, model_cfg, num_class, box_coder):
    """:func:`point_head_box_loss`, plus the rotation vector's squared
    error averaged over the positives' 3 entries and the slope class's
    focal loss (gamma 1) over its labelled points. Returns (loss,
    terms)."""
    total, tb = point_head_box_loss(batch_dict, model_cfg, num_class,
                                    box_coder)
    w = model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
    pos = batch_dict["point_cls_labels"].reshape(-1) > 0
    sq = (batch_dict["point_rot_reg_preds"].reshape(-1, 3)
          - batch_dict["point_rot_reg_labels"].reshape(-1, 3)) ** 2
    n_pos = torch.clamp(pos.float().sum(), min=1.0)
    rot_reg = (torch.where(pos[:, None], sq, 0.0).sum() / (n_pos * 3)
               ) * float(w["point_rot_reg_weight"])
    labels = batch_dict["point_rot_cls_labels"].reshape(-1)
    cls_w = (labels >= 0).float()
    cls_w = cls_w / torch.clamp(cls_w.sum(), min=1.0)
    one_hot = torch.nn.functional.one_hot(labels.clamp(min=0).long(),
                                          2).float()
    rot_cls = loss_utils.sigmoid_focal_loss(
        batch_dict["point_rot_cls_preds"].reshape(-1, 2), one_hot,
        weights=cls_w, alpha=0.25, gamma=1.0).sum() * float(
            w["point_rot_cls_weight"])
    tb["point_loss_rot_reg"] = rot_reg
    tb["point_loss_rot_cls"] = rot_cls
    return total + rot_reg + rot_cls, tb
