"""PointPillars detector (counterpart of
``de6d_tpu/models/detectors/pointpillar.py``), inference only."""

from __future__ import annotations

from ...registry import DETECTORS
from .detector3d_template import Detector3DTemplate


@DETECTORS.register
class PointPillar(Detector3DTemplate):
    pass
