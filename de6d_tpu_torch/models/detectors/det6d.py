"""Det6D and the 3DSSD / SASA single-stage point detectors (counterpart
of ``de6d_tpu/models/detectors/det6d.py``): PointNet2FSMSG backbone →
PointHeadBox(6D)Vote. The training loss is the point head's alone
(``point_vote_head_loss``), the same function for both."""

from __future__ import annotations

from ...registry import DETECTORS
from ..dense_heads.point_head_vote import point_vote_head_loss
from .detector3d_template import Detector3DTemplate


class _PointVoteDetector(Detector3DTemplate):
    TRAINABLE = True

    def get_training_loss(self, batch_dict):
        loss, tb = point_vote_head_loss(batch_dict,
                                        self.model_cfg["POINT_HEAD"],
                                        self.point_head.num_class,
                                        self.point_head.box_coder)
        tb["loss"] = loss
        return loss, tb


@DETECTORS.register
class Det6D(_PointVoteDetector):
    """Full-pose detector."""


@DETECTORS.register
class SSD3D(_PointVoteDetector):
    """3DSSD / 3DSSD-SASA: the same spine with the 7-DoF vote head."""
