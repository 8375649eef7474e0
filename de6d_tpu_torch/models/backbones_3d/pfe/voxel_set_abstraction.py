"""Voxel set abstraction, PV-RCNN's keypoint features (counterpart of
``de6d_tpu/models/backbones_3d/pfe/voxel_set_abstraction.py``:
``bilinear_interpolate_bev``, ``VoxelSetAbstraction``).

d-fps picks ``NUM_KEYPOINTS`` keypoints from the raw points (the FPS
kernel; the picks carry no gradient); each keypoint gathers the bilinear
BEV feature, an SA group over the raw points and one over the voxel
centres of every ``x_conv*`` source; the concatenation
(``point_features_before_fusion``) goes through one shared MLP to
``point_features``. In train mode the SA layers group every ball and
their MLPs and the fusion MLP normalise by the batch's statistics, and
the gradient flows into the BEV map and into every stage's features (none
into the rows of a stage's invalid sites, which no ball holds).

The feature order is the JAX module's, not ``FEATURES_SOURCE``'s: ``bev``,
then ``raw_points``, then the ``x_conv*`` sources in list order. The SA
layers are ``PointnetSAModuleFSMSG_0`` (raw points), ``_1`` ... (the
voxel sources), the fusion MLP ``SharedMLP_0``, as flax names them. All
of it is fp32, whatever the model's compute dtype: the JAX module builds
its layers without a dtype.

Geometry rounds as jitted XLA does on the CPU, since the ball query's
membership turns on the last bit of a centre: a voxel centre is one
fused multiply-add ``fma(c + 0.5, vs * stride, pc0)`` (XLA folds the two
constants), and the BEV cell index multiplies by the reciprocals of the
voxel size and the stride.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ....ops import sampling, sparse
from ....registry import PFE
from ...model_utils.mlp import SharedMLP
from ..pointnet2_modules import PointnetSAModuleFSMSG


def bilinear_interpolate_bev(bev, xy, pc_range, voxel_size, stride):
    """bev (B, H, W, C) [H = y, W = x]; xy (B, K, 2) world coordinates →
    (B, K, C). Cells outside the map clamp to its edge."""
    inv_x, inv_y = (float(np.float32(1.0) / np.float32(v))
                    for v in voxel_size[:2])  # the fp32 reciprocals
    x_idx = (xy[..., 0] - pc_range[0]) * inv_x * (1.0 / stride)
    y_idx = (xy[..., 1] - pc_range[1]) * inv_y * (1.0 / stride)
    x0 = torch.floor(x_idx).to(torch.int64)
    y0 = torch.floor(y_idx).to(torch.int64)
    x1, y1 = x0 + 1, y0 + 1
    h, w = bev.shape[1], bev.shape[2]
    x0c, x1c = x0.clamp(0, w - 1), x1.clamp(0, w - 1)
    y0c, y1c = y0.clamp(0, h - 1), y1.clamp(0, h - 1)
    wa = (x1 - x_idx) * (y1 - y_idx)
    wb = (x1 - x_idx) * (y_idx - y0)
    wc = (x_idx - x0) * (y1 - y_idx)
    wd = (x_idx - x0) * (y_idx - y0)
    rows = torch.arange(bev.shape[0], device=bev.device)[:, None]
    return (bev[rows, y0c, x0c] * wa[..., None]
            + bev[rows, y1c, x0c] * wb[..., None]
            + bev[rows, y0c, x1c] * wc[..., None]
            + bev[rows, y1c, x1c] * wd[..., None])


def voxel_centres(keys, grid, voxel_size, pc_range, stride):
    """(B, V) sorted site keys of ``grid`` (zyx) → (B, V, 3) xyz centres
    ``(c + 0.5) * voxel_size * stride + pc_range[:3]`` with one rounding
    per axis, as jitted XLA fuses them, and the (B, V) validity."""
    c = sparse.keys_to_coords(keys, grid).float() + 0.5  # zyx
    # fp32 constants; at these magnitudes the product and the sum are
    # exact in float64, then rounded once to fp32: the fused multiply-add
    step = [float(np.float32(v) * np.float32(stride)) for v in voxel_size]
    pc0 = [float(np.float32(v)) for v in pc_range[:3]]
    xyz = torch.stack([(c[..., 2 - i].double() * step[i] + pc0[i]).float()
                       for i in range(3)], dim=-1)
    return xyz, keys != sparse.INVALID


@PFE.register
class VoxelSetAbstraction(nn.Module):
    def __init__(self, model_cfg, voxel_size, point_cloud_range,
                 num_bev_features=0, num_rawpoint_features=1,
                 multi_scale_channels=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.point_cloud_range = tuple(float(v) for v in point_cloud_range)
        method = str(model_cfg.get("SAMPLE_METHOD", "FPS"))
        if method != "FPS":
            raise NotImplementedError(
                f"VoxelSetAbstraction SAMPLE_METHOD {method!r} is not "
                "ported yet (only FPS)")
        self.sources = list(model_cfg["FEATURES_SOURCE"])
        sa_cfg = model_cfg.get("SA_LAYER", {})
        multi_scale_channels = dict(multi_scale_channels or {})
        # the JAX module's order: raw points first, then the voxel sources
        self.sa_names = []
        if "raw_points" in self.sources:
            self.sa_names.append("raw_points")
        self.sa_names += [s for s in self.sources if s in multi_scale_channels]
        width = int(num_bev_features) if "bev" in self.sources else 0
        for i, name in enumerate(self.sa_names):
            src = sa_cfg[name]
            if str(src.get("NAME", "")) == "VectorPoolAggregationModuleMSG":
                raise NotImplementedError(
                    "VectorPoolAggregationModuleMSG (PV-RCNN++) is not "
                    "ported yet")
            cin = (int(num_rawpoint_features) if name == "raw_points"
                   else int(multi_scale_channels[name]))
            sa = PointnetSAModuleFSMSG(
                in_channels=cin,
                radii=tuple(float(r) for r in src["POOL_RADIUS"]),
                nsamples=tuple(int(s) for s in src["NSAMPLE"]),
                mlps=tuple(tuple(m) for m in src["MLPS"]),
                use_xyz=True,
                pc_range=self.point_cloud_range,
            )
            self.add_module(f"PointnetSAModuleFSMSG_{i}", sa)
            width += sa.out_channels
        self.num_point_features_before_fusion = width
        self.SharedMLP_0 = SharedMLP(
            width, (int(model_cfg["NUM_OUTPUT_FEATURES"]),), use_bn=True)

    @property
    def num_point_features(self):
        return int(self.model_cfg["NUM_OUTPUT_FEATURES"])

    def forward(self, batch_dict):
        points = batch_dict["points"]  # (B, N, 3 + C)
        mask = batch_dict.get("points_mask")
        if mask is None:
            mask = torch.any(points[..., :3] != 0, dim=-1)
        xyz = points[..., :3].contiguous()
        idx = sampling.farthest_point_sample(
            xyz, int(self.model_cfg["NUM_KEYPOINTS"]), mask)
        keypoints = sampling.gather_points(xyz, idx)
        kp_valid = torch.gather(mask, 1, idx.long())

        features = []
        if "bev" in self.sources:
            features.append(bilinear_interpolate_bev(
                batch_dict["spatial_features"], keypoints[..., :2],
                self.point_cloud_range, self.voxel_size,
                batch_dict.get("spatial_features_stride", 8)))
        ms = batch_dict.get("multi_scale_3d_features", {})
        strides = batch_dict.get("multi_scale_3d_strides", {})
        for i, name in enumerate(self.sa_names):
            if name == "raw_points":
                src_xyz, src_valid = xyz, mask
                feats = points[..., 3:] if points.shape[-1] > 3 else None
            else:
                feats, keys, grid = ms[name]
                src_xyz, src_valid = voxel_centres(
                    keys, grid, self.voxel_size, self.point_cloud_range,
                    strides.get(name, 1))
            sa = getattr(self, f"PointnetSAModuleFSMSG_{i}")
            _, f, _, _, _ = sa(src_xyz, feats, src_valid, new_xyz=keypoints,
                               new_valid=kp_valid)
            features.append(f)
        before = torch.cat(features, dim=-1)
        batch_dict["point_features_before_fusion"] = before
        batch_dict["point_features"] = self.SharedMLP_0(before)
        batch_dict["point_coords"] = keypoints
        batch_dict["point_valid"] = kp_valid
        batch_dict["keypoint_idx"] = idx
        return batch_dict
