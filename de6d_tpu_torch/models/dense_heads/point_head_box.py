"""Per-point heads, inference only (counterpart of
``de6d_tpu/models/dense_heads/point_head_box.py``: ``PointHeadBox``,
PointRCNN's first stage, and ``PointHeadSimple``, PV-RCNN's keypoint
segmentation, in eval).

``PointHeadBox``: two fp32 FC stacks on the backbone's point features
give class logits and box codes; the codes are decoded at the points
with the head's box coder (per-class mean sizes picked by the first
argmax of the logits). ``PointHeadSimple``: one fp32 FC stack gives the
keypoints' foreground logits and scores. The targets and losses come
with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from ...registry import POINT_HEADS
from ...utils import box_coder_utils
from ..model_utils.mlp import FCStack


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
    else ``point_features``; the flax child is ``FCStack_0``."""

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
        return batch_dict
