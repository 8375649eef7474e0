"""Mean voxel feature encoder (counterpart of
``de6d_tpu/models/backbones_3d/vfe/mean_vfe.py:MeanVFE``): the mean of
the points in each voxel. ``DynamicMeanVFE`` is not ported yet.
"""

from __future__ import annotations

import torch
from torch import nn

from ....ops import voxelize
from ....registry import VFE


@VFE.register
class MeanVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_point_features = num_point_features

    @property
    def output_feature_dim(self):
        return self.num_point_features

    def forward(self, batch_dict):
        """Builds the (B, V, P, C) voxel buffer from the voxelizer's
        sorted-order metadata and writes ``voxel_features`` (B, V, C):
        sum over P / clip(num_points, 1), summed point by point in order
        as XLA does."""
        num_points = batch_dict["voxel_num_points"]  # (B, V)
        voxels = voxelize.voxel_buffer(
            batch_dict["points"], batch_dict["order"],
            batch_dict["voxel_starts"], num_points,
            int(batch_dict["_points_per_voxel_cap"]),
        )
        total = voxels[:, :, 0]
        for i in range(1, voxels.shape[2]):
            total = total + voxels[:, :, i]
        denom = torch.clamp(num_points[..., None], min=1).to(voxels.dtype)
        batch_dict["voxel_features"] = total / denom
        return batch_dict
