"""Per-point heads (counterpart of
``de6d_tpu/models/dense_heads/point_head_box.py``: ``assign_point_targets``,
``PointHeadBox``, PointRCNN's first stage, in eval, and
``PointHeadSimple``, PV-RCNN's keypoint segmentation, in eval and train).

``PointHeadBox``: two fp32 FC stacks on the backbone's point features
give class logits and box codes; the codes are decoded at the points
with the head's box coder (per-class mean sizes picked by the first
argmax of the logits); its targets and loss are not ported yet.
``PointHeadSimple``: one fp32 FC stack gives the keypoints' foreground
logits and scores; in train mode it also writes ``point_cls_labels``
(:func:`assign_point_targets`: containment in the gt boxes, the
``GT_EXTRA_WIDTH`` ring ignored), which PV-RCNN's loss reads.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import geometry
from ...registry import POINT_HEADS
from ...utils import box_coder_utils
from ..model_utils.mlp import FCStack


@torch.no_grad()
def assign_point_targets(points, valid, gt_boxes, extra_width=None):
    """(B, N, 3) points vs (B, M, 7 | 9 + class) gt boxes → (B, N) int32
    class-agnostic labels: 1 inside a gt box, 0 outside every box, -1 in
    the ``extra_width`` ring around a box and at invalid points (the JAX
    ``assign_point_targets``' labels for one class). Containment is 9-DoF
    where the boxes have 9 columns. No gradient."""
    boxes = gt_boxes[..., :-1]
    gt_valid = torch.any(boxes[..., :7].abs() > 0, dim=-1)
    use = boxes[..., :9] if boxes.shape[-1] >= 9 else boxes[..., :7]
    fg = (geometry.points_in_boxes_index(points, use, gt_valid) >= 0) & valid
    if extra_width is not None:
        big = geometry.enlarge_box3d(use, extra_width)
        inside_big = geometry.points_in_boxes_index(points, big,
                                                    gt_valid) >= 0
        ignore = (fg ^ (inside_big & valid)) & valid
    else:
        ignore = torch.zeros_like(fg)
    label = torch.where(fg, 1, torch.where(ignore | ~valid, -1, 0))
    return label.to(torch.int32)


@POINT_HEADS.register
class PointHeadBox(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        target_cfg = model_cfg["TARGET_CONFIG"]
        self.box_coder = box_coder_utils.build_box_coder(
            target_cfg["BOX_CODER"],
            **dict(target_cfg.get("BOX_CODER_CONFIG", {})),
        )
        use_bn = model_cfg.get("USE_BN", True)
        self.cls_layers = FCStack(input_channels, model_cfg["CLS_FC"],
                                  num_class, use_bn=use_bn)
        self.box_layers = FCStack(input_channels, model_cfg["REG_FC"],
                                  self.box_coder.code_size, use_bn=use_bn)

    def forward(self, batch_dict):
        feats = batch_dict["point_features"]  # (B, N, C) fp32
        coords = batch_dict["point_coords"]  # (B, N, 3)
        cls_preds = self.cls_layers(feats)  # (B, N, ncls) fp32
        box_preds = self.box_layers(feats)  # (B, N, code) fp32
        boxes = self.box_coder.decode(
            box_preds, coords, torch.argmax(cls_preds, dim=-1) + 1)
        batch_dict["point_cls_preds"] = cls_preds
        batch_dict["point_reg_preds"] = box_preds
        batch_dict["point_cls_scores"] = torch.sigmoid(cls_preds).amax(dim=-1)
        batch_dict["batch_cls_preds"] = cls_preds
        batch_dict["batch_box_preds"] = boxes
        batch_dict["point_box_preds"] = boxes
        batch_dict["cls_preds_normalized"] = False
        return batch_dict


@POINT_HEADS.register
class PointHeadSimple(nn.Module):
    """Keypoint foreground scores. Like the JAX head it reads
    ``point_features_before_fusion`` wherever the batch has it (a PFE ran),
    else ``point_features``; the flax child is ``FCStack_0``. In train
    mode the scores keep their gradient (PV-RCNN's RoI head weights the
    keypoint features by them) and ``point_cls_labels`` are written."""

    def __init__(self, model_cfg, input_channels, num_class, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg
        self.FCStack_0 = FCStack(input_channels, model_cfg["CLS_FC"],
                                 num_class,
                                 use_bn=model_cfg.get("USE_BN", True))

    def forward(self, batch_dict):
        feats = batch_dict.get("point_features_before_fusion")
        if feats is None:
            feats = batch_dict["point_features"]
        cls_preds = self.FCStack_0(feats)  # (B, N, ncls) fp32
        batch_dict["point_cls_preds"] = cls_preds
        batch_dict["point_cls_scores"] = torch.sigmoid(cls_preds).amax(dim=-1)
        if self.training:
            coords = batch_dict["point_coords"]
            valid = batch_dict.get("point_valid")
            if valid is None:
                valid = torch.ones(coords.shape[:2], dtype=torch.bool,
                                   device=coords.device)
            batch_dict["point_cls_labels"] = assign_point_targets(
                coords, valid, batch_dict["gt_boxes"],
                extra_width=self.model_cfg["TARGET_CONFIG"].get(
                    "GT_EXTRA_WIDTH"))
        return batch_dict
