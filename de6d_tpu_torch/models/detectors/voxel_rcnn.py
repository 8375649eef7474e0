"""Voxel-RCNN (counterpart of ``de6d_tpu/models/detectors/voxel_rcnn.py``):
MeanVFE → VoxelBackBone8x → HeightCompression → BaseBEVBackbone →
AnchorHeadSingle (every anchor decoded) → VoxelRCNNHead. The loss sums
the anchor head's, with its direction classifier, and the RoI head's."""

from __future__ import annotations

from ...registry import DETECTORS
from ..dense_heads.anchor_head import anchor_head_loss
from ..roi_heads.roi_head_utils import roi_head_loss
from .detector3d_template import Detector3DTemplate


@DETECTORS.register
class VoxelRCNN(Detector3DTemplate):
    TRAINABLE = True

    def get_training_loss(self, batch_dict):
        dense_cfg = self.model_cfg["DENSE_HEAD"]
        loss_rpn, tb = anchor_head_loss(
            batch_dict, dense_cfg["LOSS_CONFIG"], num_class=self.num_class,
            dir_cfg=(dense_cfg if dense_cfg.get("USE_DIRECTION_CLASSIFIER",
                                                False) else None))
        loss_rcnn, tb_rcnn = roi_head_loss(
            batch_dict["roi_targets_dict"],
            self.model_cfg["ROI_HEAD"]["LOSS_CONFIG"])
        tb.update(tb_rcnn)
        loss = loss_rpn + loss_rcnn
        tb["loss"] = loss
        return loss, tb
