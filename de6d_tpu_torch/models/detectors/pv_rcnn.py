"""PV-RCNN (counterpart of ``de6d_tpu/models/detectors/pv_rcnn.py``),
inference only: MeanVFE → VoxelBackBone8x → HeightCompression →
VoxelSetAbstraction → BaseBEVBackbone → AnchorHeadSingle (every anchor
decoded) → PointHeadSimple → PVRCNNHead. The training loss comes with
the training slice."""

from __future__ import annotations

from ...registry import DETECTORS
from .detector3d_template import Detector3DTemplate


@DETECTORS.register
class PVRCNN(Detector3DTemplate):
    pass
