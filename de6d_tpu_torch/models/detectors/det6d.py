"""Det6D and the 3DSSD / SASA single-stage point detectors (counterpart
of ``de6d_tpu/models/detectors/det6d.py``): PointNet2FSMSG backbone →
PointHeadBox(6D)Vote, or Det6D's direct-regression ``PointHeadBox6D``.
The training loss is the point head's alone: ``point_head_box6d_loss``
where ``POINT_HEAD.NAME`` is ``PointHeadBox6D``, else
``point_vote_head_loss``."""

from __future__ import annotations

from ...registry import DETECTORS
from ..dense_heads.point_head_box6d import point_head_box6d_loss
from ..dense_heads.point_head_vote import point_vote_head_loss
from .detector3d_template import Detector3DTemplate


class _PointVoteDetector(Detector3DTemplate):
    TRAINABLE = True

    def get_training_loss(self, batch_dict):
        head_cfg = self.model_cfg["POINT_HEAD"]
        loss_fn = (point_head_box6d_loss
                   if head_cfg["NAME"] == "PointHeadBox6D"
                   else point_vote_head_loss)
        loss, tb = loss_fn(batch_dict, head_cfg, self.point_head.num_class,
                           self.point_head.box_coder)
        tb["loss"] = loss
        return loss, tb


@DETECTORS.register
class Det6D(_PointVoteDetector):
    """Full-pose detector."""


@DETECTORS.register
class SSD3D(_PointVoteDetector):
    """3DSSD / 3DSSD-SASA: the same spine with the 7-DoF vote head."""
