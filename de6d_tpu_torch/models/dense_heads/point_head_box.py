"""Per-point heads (counterpart of
``de6d_tpu/models/dense_heads/point_head_box.py``: ``assign_point_targets``,
``point_head_box_loss``, ``PointHeadBox``, PointRCNN's first stage, and
``PointHeadSimple``, PV-RCNN's keypoint segmentation, both in eval and
train).

``PointHeadBox``: two fp32 FC stacks on the backbone's point features
give class logits and box codes; the codes are decoded at the points
with the head's box coder (per-class mean sizes picked by the first
argmax of the logits), in train mode too (a RoI head follows and reads
the decoded boxes). In train mode it also writes ``point_cls_labels``,
``point_reg_labels`` and ``point_box_labels``
(:func:`assign_point_targets` with the head's coder, ``GT_EXTRA_WIDTH``
and its class count), which :func:`point_head_box_loss` reads.
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
from ...utils import box_coder_utils, loss_utils
from ..model_utils.mlp import FCStack


@torch.no_grad()
def assign_point_targets(points, valid, gt_boxes, extra_width=None,
                         box_coder=None, num_class=1, encode_dims=None):
    """(B, N, 3) points vs (B, M, 7 | 9 + class) gt boxes → (B, N) int32
    labels: inside a gt box 1 (``num_class`` 1) or the box's class, 0
    outside every box, -1 in the ``extra_width`` ring around a box and at
    invalid points. Containment is 9-DoF where the boxes have 9 columns;
    where boxes overlap the last one owns the point. No gradient.

    With a ``box_coder`` returns (labels, reg labels (B, N, code): the
    owning box's first ``encode_dims`` columns (all without) encoded at
    the point, box labels (B, N, 7 | 9): the owning box), zero off the
    foreground, as the JAX ``assign_point_targets`` returns them."""
    boxes = gt_boxes[..., :-1]
    cls_ids = gt_boxes[..., -1].long()
    gt_valid = torch.any(boxes[..., :7].abs() > 0, dim=-1)
    use = boxes[..., :9] if boxes.shape[-1] >= 9 else boxes[..., :7]
    idx = geometry.points_in_boxes_index(points, use, gt_valid)
    fg = (idx >= 0) & valid
    if extra_width is not None:
        big = geometry.enlarge_box3d(use, extra_width)
        inside_big = geometry.points_in_boxes_index(points, big,
                                                    gt_valid) >= 0
        ignore = (fg ^ (inside_big & valid)) & valid
    else:
        ignore = torch.zeros_like(fg)
    safe = idx.clamp(min=0).long()
    cls_at = torch.gather(cls_ids, 1, safe)
    label = torch.where(fg, 1 if num_class == 1 else cls_at,
                        torch.where(ignore | ~valid, -1, 0)).to(torch.int32)
    if box_coder is None:
        return label
    own = torch.gather(boxes, 1, safe[..., None].expand(-1, -1,
                                                         boxes.shape[-1]))
    src = own if encode_dims is None else own[..., :encode_dims]
    enc = box_coder.encode(src, points, cls_at)[..., :box_coder.code_size]
    return (label, torch.where(fg[..., None], enc, 0.0),
            torch.where(fg[..., None], own, 0.0))


def point_head_box_loss(batch_dict, model_cfg, num_class, box_coder):
    """Focal class loss over the positives and negatives and smooth-L1 box
    codes over the positives, each normalised by the positives' count
    (the JAX ``point_head_box_loss``). Returns (loss, terms)."""
    w = model_cfg["LOSS_CONFIG"]["LOSS_WEIGHTS"]
    labels = batch_dict["point_cls_labels"].reshape(-1)
    cls_preds = batch_dict["point_cls_preds"].reshape(-1, num_class)
    pos = labels > 0
    cls_w = (pos | (labels == 0)).float()
    pos_norm = torch.clamp(pos.float().sum(), min=1.0)
    one_hot = torch.nn.functional.one_hot(
        labels.clamp(min=0).long(), num_class + 1)[..., 1:].float()
    cls_loss = loss_utils.sigmoid_focal_loss(
        cls_preds, one_hot, weights=cls_w / pos_norm).sum() * float(
            w["point_cls_weight"])
    code = box_coder.code_size
    reg_loss = loss_utils.smooth_l1_loss(
        batch_dict["point_reg_preds"].reshape(-1, code),
        batch_dict["point_reg_labels"].reshape(-1, code),
        weights=pos.float() / pos_norm,
        code_weights=w.get("code_weights")).sum() * float(
            w["point_box_weight"])
    return cls_loss + reg_loss, {"point_loss_cls": cls_loss,
                                 "point_loss_box": reg_loss}


@POINT_HEADS.register
class PointHeadBox(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class,
                 predict_boxes_when_training=False, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.predict_boxes_when_training = predict_boxes_when_training
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
        batch_dict["point_cls_preds"] = cls_preds
        batch_dict["point_reg_preds"] = box_preds
        batch_dict["point_cls_scores"] = torch.sigmoid(cls_preds).amax(dim=-1)
        if not self.training or self.predict_boxes_when_training:
            boxes = self.box_coder.decode(
                box_preds, coords, torch.argmax(cls_preds, dim=-1) + 1)
            batch_dict["batch_cls_preds"] = cls_preds
            batch_dict["batch_box_preds"] = boxes
            batch_dict["point_box_preds"] = boxes
            batch_dict["cls_preds_normalized"] = False
        if self.training:
            valid = batch_dict.get("point_valid")
            if valid is None:
                valid = torch.ones(coords.shape[:2], dtype=torch.bool,
                                   device=coords.device)
            (batch_dict["point_cls_labels"], batch_dict["point_reg_labels"],
             batch_dict["point_box_labels"]) = assign_point_targets(
                coords, valid, batch_dict["gt_boxes"],
                extra_width=self.model_cfg["TARGET_CONFIG"].get(
                    "GT_EXTRA_WIDTH"),
                box_coder=self.box_coder, num_class=self.num_class)
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
