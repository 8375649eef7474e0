"""Det6D and the 3DSSD / SASA single-stage point detectors (counterpart
of ``de6d_tpu/models/detectors/det6d.py``), inference only:
PointNet2FSMSG backbone → PointHeadBox(6D)Vote. The training losses come
with the training slice."""

from __future__ import annotations

from ...registry import DETECTORS
from .detector3d_template import Detector3DTemplate


@DETECTORS.register
class Det6D(Detector3DTemplate):
    """Full-pose detector."""


@DETECTORS.register
class SSD3D(Detector3DTemplate):
    """3DSSD / 3DSSD-SASA: the same spine with the 7-DoF vote head."""
