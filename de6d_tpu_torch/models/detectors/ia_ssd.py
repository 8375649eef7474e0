"""IA-SSD (counterpart of ``de6d_tpu/models/detectors/ia_ssd.py``),
inference only: IASSD_Backbone → IASSD_Head. The training loss comes
with the training slice."""

from __future__ import annotations

from ...registry import DETECTORS
from .detector3d_template import Detector3DTemplate


@DETECTORS.register
class IASSD(Detector3DTemplate):
    pass
