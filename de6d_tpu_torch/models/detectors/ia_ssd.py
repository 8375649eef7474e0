"""IA-SSD (counterpart of ``de6d_tpu/models/detectors/ia_ssd.py``):
IASSD_Backbone → IASSD_Head; the training loss is the head's
(``iassd_head_loss``)."""

from __future__ import annotations

from ...registry import DETECTORS
from ..dense_heads.iassd_head import iassd_head_loss
from .detector3d_template import Detector3DTemplate


@DETECTORS.register
class IASSD(Detector3DTemplate):
    TRAINABLE = True

    def get_training_loss(self, batch_dict):
        loss, tb = iassd_head_loss(batch_dict, self.model_cfg["POINT_HEAD"],
                                   self.point_head.num_class)
        tb["loss"] = loss
        return loss, tb
