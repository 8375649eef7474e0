"""PointRCNN (counterpart of ``de6d_tpu/models/detectors/point_rcnn.py``):
PointNet2MSG backbone → PointHeadBox (stage 1) → PointRCNNHead (stage 2).
The loss sums the point head's (focal class loss, smooth-L1 box codes)
and the RoI head's."""

from __future__ import annotations

from ...registry import DETECTORS
from ...utils import box_coder_utils
from ..dense_heads.point_head_box import point_head_box_loss
from ..roi_heads.roi_head_utils import roi_head_loss
from .detector3d_template import Detector3DTemplate


@DETECTORS.register
class PointRCNN(Detector3DTemplate):
    TRAINABLE = True

    def get_training_loss(self, batch_dict):
        """(loss, terms): ``point_loss_cls`` and ``point_loss_box`` of the
        point head (one class where ``CLASS_AGNOSTIC``), ``rcnn_loss_*``
        of the RoI head, and ``loss``."""
        head_cfg = self.model_cfg["POINT_HEAD"]
        tcfg = head_cfg["TARGET_CONFIG"]
        coder = box_coder_utils.build_box_coder(
            tcfg["BOX_CODER"], **dict(tcfg.get("BOX_CODER_CONFIG", {})))
        num_class = 1 if head_cfg.get("CLASS_AGNOSTIC", False) \
            else self.num_class
        loss_point, tb = point_head_box_loss(batch_dict, head_cfg, num_class,
                                             coder)
        loss_rcnn, tb_rcnn = roi_head_loss(
            batch_dict["roi_targets_dict"],
            self.model_cfg["ROI_HEAD"]["LOSS_CONFIG"])
        tb.update(tb_rcnn)
        loss = loss_point + loss_rcnn
        tb["loss"] = loss
        return loss, tb
