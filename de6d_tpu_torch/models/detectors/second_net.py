"""SECOND detector (counterpart of
``de6d_tpu/models/detectors/second_net.py``): MeanVFE → VoxelBackBone8x →
HeightCompression → BaseBEVBackbone → AnchorHeadSingle; the loss is the
dense head's alone.
"""

from __future__ import annotations

from ...registry import DETECTORS
from ..dense_heads.anchor_head import anchor_head_loss
from .detector3d_template import Detector3DTemplate


@DETECTORS.register
class SECONDNet(Detector3DTemplate):
    TRAINABLE = True

    def get_training_loss(self, batch_dict):
        head_cfg = self.model_cfg["DENSE_HEAD"]
        loss, tb = anchor_head_loss(
            batch_dict, head_cfg["LOSS_CONFIG"], num_class=self.num_class,
            dir_cfg=(head_cfg if head_cfg.get("USE_DIRECTION_CLASSIFIER",
                                              False) else None),
        )
        tb["loss"] = loss
        return loss, tb
