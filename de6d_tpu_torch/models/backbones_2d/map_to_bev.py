"""Map-to-BEV (counterpart of
``de6d_tpu/models/backbones_2d/map_to_bev.py``: ``PointPillarScatter``,
``HeightCompression``). The canvas is NHWC ``(B, ny, nx, C)`` as in the
JAX package."""

from __future__ import annotations

import torch
from torch import nn

from ...ops.kernels.canvas import scatter_canvas
from ...registry import MAP_TO_BEV


def cell_ids(coords, ny: int, nx: int):
    """(B, V, 3) zyx voxel coords → (B, V) int32 linear BEV cell ids,
    ``ny * nx`` for empty slots. The voxelizer emits slots in ascending
    key order with the empty (-1) slots as a tail, so the ids are the
    canvas kernel's input contract."""
    return torch.where(
        coords[..., 0] >= 0, coords[..., 1] * nx + coords[..., 2], ny * nx
    ).to(torch.int32)


@MAP_TO_BEV.register
class PointPillarScatter(nn.Module):
    """Scatter (B, V, C) pillars into a dense (B, ny, nx, C) canvas
    through the canvas kernel (its plain version on CPU tensors)."""

    def __init__(self, model_cfg, grid_size):
        super().__init__()
        self.model_cfg = model_cfg
        self.nx, self.ny = int(grid_size[0]), int(grid_size[1])

    @property
    def num_bev_features(self):
        return int(self.model_cfg["NUM_BEV_FEATURES"])

    def forward(self, batch_dict):
        pillars = batch_dict["pillar_features"]  # (B, V, C)
        coords = batch_dict["voxel_coords"]  # (B, V, 3) zyx
        batch_dict["spatial_features"] = scatter_canvas(
            pillars, cell_ids(coords, self.ny, self.nx), self.ny, self.nx
        )
        batch_dict["spatial_features_stride"] = 1
        return batch_dict


@MAP_TO_BEV.register
class HeightCompression(nn.Module):
    """Fold the z axis of the sparse backbone's dense (B, nz, ny, nx, C)
    volume into channels: (B, ny, nx, nz * C) with the channel order
    (z, C), as the JAX module's ``transpose(0, 2, 3, 1, 4)`` gives (the
    reference's is (C, z)); the converted 2D weights expect (z, C)."""

    def __init__(self, model_cfg, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg

    @property
    def num_bev_features(self):
        return int(self.model_cfg["NUM_BEV_FEATURES"])

    def forward(self, batch_dict):
        vol = batch_dict["encoded_spconv_tensor"]  # (B, nz, ny, nx, C)
        b, nz, ny, nx, c = vol.shape
        batch_dict["spatial_features"] = vol.permute(0, 2, 3, 1, 4).reshape(
            b, ny, nx, nz * c)
        batch_dict["spatial_features_stride"] = batch_dict.get(
            "encoded_spconv_tensor_stride", 8)
        return batch_dict
