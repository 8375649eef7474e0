"""Det6D (counterpart of ``de6d_tpu/models/detectors/det6d.py``),
inference only: PointNet2FSMSG backbone → PointHeadBox6DVote. The
training loss comes with the training slice."""

from __future__ import annotations

from ...registry import DETECTORS
from .detector3d_template import Detector3DTemplate


@DETECTORS.register
class Det6D(Detector3DTemplate):
    pass
