"""PointRCNN (counterpart of ``de6d_tpu/models/detectors/point_rcnn.py``),
inference only: PointNet2MSG backbone → PointHeadBox (stage 1) →
PointRCNNHead (stage 2). The training loss comes with the training
slice."""

from __future__ import annotations

from ...registry import DETECTORS
from .detector3d_template import Detector3DTemplate


@DETECTORS.register
class PointRCNN(Detector3DTemplate):
    pass
