"""Pillar feature network (counterpart of
``de6d_tpu/models/backbones_3d/vfe/pillar_vfe.py``), fused sorted-point
path in eval mode: per-point PFN over the key-sorted point stream plus a
windowed segmented max — the ``(V, P, C)`` voxel buffer is never built.
"""

from __future__ import annotations

import torch
from torch import nn

from ....ops import voxelize
from ....registry import VFE
from ...model_utils.dtype_utils import compute_dtype
from ...model_utils.layers import BatchNorm, Dense


class PFNLayer(nn.Module):
    """One PFN stage: linear + BN + ReLU (the caller does the max)."""

    def __init__(self, in_channels, out_channels, use_norm=True,
                 last_layer=False, dtype=torch.float32):
        super().__init__()
        self.last_layer = last_layer
        self.use_norm = use_norm
        out_dim = out_channels if last_layer else out_channels // 2
        self.dense = Dense(in_channels, out_dim, use_bias=not use_norm,
                           dtype=dtype)
        if use_norm:
            self.bn = BatchNorm(out_dim, dtype=dtype)

    def forward(self, x):
        x = self.dense(x)
        if self.use_norm:
            x = self.bn(x)
        return torch.relu(x)


def pillar_centers_from_coords(voxel_coords, voxel_size, pc_range, dtype):
    """(..., 3) zyx integer coords → (..., 3) xyz pillar centers."""
    vx, vy, vz = voxel_size
    x0, y0, z0 = pc_range[0], pc_range[1], pc_range[2]
    cx = voxel_coords[..., 2:3].to(dtype) * vx + (vx / 2 + x0)
    cy = voxel_coords[..., 1:2].to(dtype) * vy + (vy / 2 + y0)
    cz = voxel_coords[..., 0:1].to(dtype) * vz + (vz / 2 + z0)
    return torch.cat([cx, cy, cz], dim=-1)


@VFE.register
class PillarVFE(nn.Module):
    def __init__(self, model_cfg, num_point_features, voxel_size,
                 point_cloud_range):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(float(x) for x in voxel_size)
        self.point_cloud_range = tuple(float(x) for x in point_cloud_range)
        self.use_absolute_xyz = model_cfg.get("USE_ABSLOTE_XYZ", True)
        self.with_distance = model_cfg.get("WITH_DISTANCE", False)
        num_filters = list(model_cfg["NUM_FILTERS"])
        in_ch = num_point_features + 6 - (0 if self.use_absolute_xyz else 3)
        in_ch += 1 if self.with_distance else 0
        dt = compute_dtype(model_cfg)
        for i, nf in enumerate(num_filters):
            layer = PFNLayer(
                in_ch, nf, use_norm=model_cfg.get("USE_NORM", True),
                last_layer=(i == len(num_filters) - 1), dtype=dt,
            )
            self.add_module(f"PFNLayer_{i}", layer)
            in_ch = nf
        self.num_layers = len(num_filters)

    @property
    def output_feature_dim(self):
        return int(self.model_cfg["NUM_FILTERS"][-1])

    def forward(self, batch_dict):
        points = batch_dict["points"]  # (B, N, 3+C)
        order = batch_dict["order"].long()  # (B, N)
        slot = batch_dict["sorted_slot"]  # (B, N), -1 invalid
        starts = batch_dict["voxel_starts"]  # (B, V)
        counts = batch_dict["voxel_num_points"]  # (B, V) capped
        coords = batch_dict["voxel_coords"]  # (B, V, 3) zyx
        v = coords.shape[1]
        cap = int(batch_dict.get("_points_per_voxel_cap", 32))

        pts_sorted = torch.gather(
            points, 1, order[..., None].expand(-1, -1, points.shape[-1])
        )
        xyz = pts_sorted[..., :3]
        extra = pts_sorted[..., 3:]
        valid = slot >= 0

        seg_sum = voxelize.sorted_segment_sum(
            torch.where(valid[..., None], xyz, 0.0), slot, starts, counts,
            window=cap,
        )
        centroid_v = seg_sum / torch.clamp(counts[..., None], min=1).to(
            xyz.dtype
        )
        slot_c = torch.clamp(slot, 0, v - 1).long()
        centroid = torch.gather(
            centroid_v, 1, slot_c[..., None].expand(-1, -1, 3)
        )
        pt_coords = torch.gather(
            coords, 1, slot_c[..., None].expand(-1, -1, 3)
        )
        center = pillar_centers_from_coords(
            pt_coords, self.voxel_size, self.point_cloud_range, xyz.dtype
        )
        feats = [xyz, extra] if self.use_absolute_xyz else [extra]
        feats += [xyz - centroid, xyz - center]
        if self.with_distance:
            feats.append(torch.linalg.norm(xyz, dim=-1, keepdim=True))
        feats = torch.where(valid[..., None], torch.cat(feats, dim=-1), 0.0)

        for i in range(self.num_layers):
            layer = getattr(self, f"PFNLayer_{i}")
            x = torch.where(valid[..., None], layer(feats), 0.0)
            x_max = voxelize.sorted_segment_max(
                x, slot, starts, counts, window=cap
            )  # (B, V, out)
            if layer.last_layer:
                feats = x_max
            else:
                x_rep = torch.gather(
                    x_max, 1, slot_c[..., None].expand(-1, -1, x.shape[-1])
                )
                feats = torch.cat([x, x_rep], dim=-1)
        batch_dict["pillar_features"] = feats  # (B, V, C_out)
        return batch_dict
