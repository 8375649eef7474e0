"""PV-RCNN (counterpart of ``de6d_tpu/models/detectors/pv_rcnn.py``):
MeanVFE → VoxelBackBone8x → HeightCompression → VoxelSetAbstraction →
BaseBEVBackbone → AnchorHeadSingle (every anchor decoded) →
PointHeadSimple → PVRCNNHead. The loss sums the anchor head's, the
keypoints' foreground focal loss and the RoI head's."""

from __future__ import annotations

import torch

from ...registry import DETECTORS
from ...utils import loss_utils
from ..dense_heads.anchor_head import anchor_head_loss
from ..roi_heads.roi_head_utils import roi_head_loss
from .detector3d_template import Detector3DTemplate


@DETECTORS.register
class PVRCNN(Detector3DTemplate):
    TRAINABLE = True

    def get_training_loss(self, batch_dict):
        """(loss, terms): ``rpn_loss_*`` of the anchor head,
        ``point_loss_cls`` (sigmoid focal loss on the keypoints' labels,
        ignored ones left out, normalised by the positives) and
        ``rcnn_loss_*`` of the RoI head."""
        dense_cfg = self.model_cfg["DENSE_HEAD"]
        loss_rpn, tb = anchor_head_loss(
            batch_dict, dense_cfg["LOSS_CONFIG"], num_class=self.num_class,
            dir_cfg=(dense_cfg if dense_cfg.get("USE_DIRECTION_CLASSIFIER",
                                                False) else None))
        w = self.model_cfg["POINT_HEAD"]["LOSS_CONFIG"]["LOSS_WEIGHTS"]
        labels = batch_dict["point_cls_labels"].reshape(-1)
        preds = batch_dict["point_cls_preds"].reshape(-1, 1)
        positives = labels > 0
        cls_weights = (positives | (labels == 0)).float()
        pos_norm = torch.clamp(positives.float().sum(), min=1.0)
        one_hot = torch.clamp(labels, 0, 1).float()[:, None]
        loss_point = (loss_utils.sigmoid_focal_loss(
            preds, one_hot, weights=cls_weights / pos_norm).sum()
            * float(w["point_cls_weight"]))
        tb["point_loss_cls"] = loss_point
        loss_rcnn, tb_rcnn = roi_head_loss(
            batch_dict["roi_targets_dict"],
            self.model_cfg["ROI_HEAD"]["LOSS_CONFIG"])
        tb.update(tb_rcnn)
        loss = loss_rpn + loss_point + loss_rcnn
        tb["loss"] = loss
        return loss, tb
