"""SECOND detector (counterpart of
``de6d_tpu/models/detectors/second_net.py``), inference only: MeanVFE →
VoxelBackBone8x → HeightCompression → BaseBEVBackbone → AnchorHeadSingle.
"""

from __future__ import annotations

from ...registry import DETECTORS
from .detector3d_template import Detector3DTemplate


@DETECTORS.register
class SECONDNet(Detector3DTemplate):
    pass
