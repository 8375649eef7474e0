"""IA-SSD head, inference only (counterpart of
``de6d_tpu/models/dense_heads/iassd_head.py``: ``IASSD_Head.__call__`` in
eval). FC stacks over the vote centres' features (fp32): class logits,
the bin-orientation box code and, with ``IOU_FC``, an IoU branch; boxes
decoded at the centres with the head's box coder. Targets and losses
come with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from ...registry import POINT_HEADS
from ...utils import box_coder_utils
from ..model_utils.mlp import FCStack


@POINT_HEADS.register
class IASSD_Head(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, **kwargs):
        super().__init__()
        tcfg = model_cfg["TARGET_CONFIG"]
        self.box_coder = box_coder_utils.build_box_coder(
            tcfg["BOX_CODER"], **dict(tcfg.get("BOX_CODER_CONFIG", {})))
        use_bn = model_cfg.get("USE_BN", True)
        self.cls_center_layers = FCStack(input_channels, model_cfg["CLS_FC"],
                                         num_class, use_bn=use_bn)
        self.box_center_layers = FCStack(input_channels, model_cfg["REG_FC"],
                                         self.box_coder.code_size,
                                         use_bn=use_bn)
        self.box_iou3d_layers = None
        if model_cfg.get("IOU_FC") is not None:
            self.box_iou3d_layers = FCStack(input_channels,
                                            model_cfg["IOU_FC"], 1,
                                            use_bn=use_bn)

    def forward(self, batch_dict):
        feats = batch_dict["centers_features"]  # (B, Nc, C) fp32
        centers = batch_dict["centers"]  # (B, Nc, 3)
        cls_preds = self.cls_center_layers(feats)
        box_preds = self.box_center_layers(feats)
        batch_dict["center_cls_preds"] = cls_preds
        batch_dict["center_box_preds"] = box_preds
        batch_dict["box_iou3d_preds"] = (
            self.box_iou3d_layers(feats)
            if self.box_iou3d_layers is not None else None)
        batch_dict["point_cls_scores"] = torch.sigmoid(cls_preds).amax(dim=-1)
        point_box_preds = self.box_coder.decode(
            box_preds, centers, torch.argmax(cls_preds, dim=-1) + 1)
        batch_dict["point_box_preds"] = point_box_preds
        batch_dict["batch_cls_preds"] = cls_preds
        batch_dict["batch_box_preds"] = point_box_preds
        batch_dict["cls_preds_normalized"] = False
        return batch_dict
