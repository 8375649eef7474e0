"""Voxel-RCNN's RoI head with voxel-query grid pooling (counterpart of
``de6d_tpu/models/roi_heads/voxelrcnn_head.py``: ``NEIGHBOR_OFFSETS``,
``voxel_query_pool`` and ``VoxelRCNNHead``, in eval and train).

The proposal layer and, in train mode, the RoI sampler are PV-RCNN's
(``roi_head_utils``). Each RoI carries a G x G x G grid of points
(``pvrcnn_head.roi_grid_points``). For every backbone scale in
``FEATURES_SOURCE`` the cell of each grid point and its 26 neighbours are
looked up among the scale's active voxels, one lookup launch for the
scale and the batch; a miss gathers zeros. A bias-carrying MLP per scale
runs over the 27 neighbours, misses included, and their max is the grid
point's feature; the scales are concatenated, grid index outermost, and
go through the shared FCs to the class and box FCs. Everything is fp32
(the backbone's features are cast by the MLP, as JAX's ``SharedMLP``
casts them).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ...ops import sparse
from ...ops.ball_query import group_points
from ...registry import ROI_HEADS
from ..model_utils.mlp import FCStack, SharedMLP
from . import roi_head_utils
from .pvrcnn_head import roi_grid_points

NEIGHBOR_OFFSETS = [
    (dz, dy, dx)
    for dz in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dx in (-1, 0, 1)
]


def cell_scales(voxel_size, stride: int):
    """(3,) fp32 factors, x y z, that turn a point's offset from the range
    corner into cell units at ``stride``: the fp32 reciprocal of
    ``voxel_size * stride``. JAX divides by that constant inside the
    jitted model, and XLA compiles the division into this product, whose
    floor parts from a true division's on points near a cell face."""
    cell = np.asarray(voxel_size, np.float32) * np.float32(stride)
    return np.float32(1.0) / cell


def voxel_query_pool(feats, keys, grid, grid_pts, voxel_size, pc_min,
                     stride: int):
    """The 3³ neighbourhoods of active voxels around each query point.

    feats (B, V, C), keys (B, V) int32 ascending with an ``INVALID`` tail,
    grid (nz, ny, nx), grid_pts (B, Q, 3) xyz, the voxel size and range
    corner (x, y, z) and the scale's stride → (B, Q, 27, C): the features
    of the voxel at each neighbour cell, z-major offsets, zero where no
    active voxel is (or the neighbour lies outside the grid), and
    (B, Q, 27) bool hits. Each offset's coordinates are built first and
    keyed after, so a centre outside the grid still finds its neighbours
    inside. One lookup launch for all the batch's queries."""
    scale = torch.as_tensor(cell_scales(voxel_size, stride),
                            device=grid_pts.device)
    corner = torch.as_tensor(np.asarray(pc_min, np.float32),
                             device=grid_pts.device)
    cell = torch.floor((grid_pts - corner) * scale).to(torch.int32)
    centre = cell.flip(-1)  # zyx
    offsets = torch.tensor(NEIGHBOR_OFFSETS, dtype=torch.int32,
                           device=grid_pts.device)
    coords = centre[:, :, None, :] + offsets  # (B, Q, 27, 3)
    b, q, k, _ = coords.shape
    qkeys = sparse.coords_to_keys(coords, grid).reshape(b, q * k)
    idx, hit = sparse.lookup(keys, qkeys)
    idx, hit = idx.reshape(b, q, k), hit.reshape(b, q, k)
    return torch.where(hit[..., None], group_points(feats, idx), 0.0), hit


@ROI_HEADS.register
class VoxelRCNNHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class=1,
                 voxel_size=None, point_cloud_range=None,
                 multi_scale_channels=None, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg
        self.voxel_size = tuple(float(v) for v in voxel_size)
        self.pc_min = tuple(float(p) for p in point_cloud_range[:3])
        use_bn = model_cfg.get("USE_BN", True)
        pool_cfg = model_cfg["ROI_GRID_POOL"]
        self.grid_size = int(pool_cfg.get("GRID_SIZE", 6))
        self.sources = list(pool_cfg.get("FEATURES_SOURCE",
                                         ["x_conv3", "x_conv4"]))
        mlps = pool_cfg.get("POOL_MLPS", {})
        width = 0
        for i, name in enumerate(self.sources):
            mlp = SharedMLP(multi_scale_channels[name],
                            mlps.get(name, [32, 32]), use_bn=use_bn)
            self.add_module(f"SharedMLP_{i}", mlp)
            width += mlp.out_channels
        n = len(self.sources)
        self.add_module(f"SharedMLP_{n}", SharedMLP(
            self.grid_size ** 3 * width, model_cfg.get("SHARED_FC",
                                                       [256, 256]),
            use_bn=use_bn))
        cin = getattr(self, f"SharedMLP_{n}").out_channels
        self.FCStack_0 = FCStack(cin, model_cfg.get("CLS_FC", [256, 256]),
                                 num_class, use_bn=use_bn)
        self.FCStack_1 = FCStack(cin, model_cfg.get("REG_FC", [256, 256]), 7,
                                 use_bn=use_bn)

    def forward(self, batch_dict):
        train = self.training
        nms_cfg = self.model_cfg["NMS_CONFIG"]["TRAIN" if train else "TEST"]
        num_rois = int(nms_cfg.get("NMS_POST_MAXSIZE", 512))
        batch_dict = roi_head_utils.proposal_layer(batch_dict, nms_cfg,
                                                   num_rois)
        if train:  # the JAX head passes only ROI_PER_IMAGE to the sampler
            targets = roi_head_utils.sample_rois(
                batch_dict, roi_per_image=int(self.model_cfg[
                    "TARGET_CONFIG"].get("ROI_PER_IMAGE", 128)))
        rois = batch_dict["rois"]
        b, r = rois.shape[:2]
        grid_pts = roi_grid_points(rois[..., :7], self.grid_size)
        flat_pts = grid_pts.reshape(b, r * grid_pts.shape[2], 3)
        ms = batch_dict["multi_scale_3d_features"]
        strides = batch_dict.get("multi_scale_3d_strides", {})
        pooled = []
        for i, name in enumerate(self.sources):
            feats, keys, grid = ms[name]
            nb, _ = voxel_query_pool(feats, keys, grid, flat_pts,
                                     self.voxel_size, self.pc_min,
                                     int(strides.get(name, 1)))
            h = getattr(self, f"SharedMLP_{i}")(nb)
            pooled.append(h.amax(dim=2))
        pooled = torch.cat(pooled, dim=-1).reshape(b, r, -1)
        shared = getattr(self, f"SharedMLP_{len(self.sources)}")(pooled)
        rcnn_cls = self.FCStack_0(shared).squeeze(-1)  # (B, R)
        rcnn_reg = self.FCStack_1(shared)  # (B, R, 7)
        batch_dict["rcnn_cls"] = rcnn_cls
        batch_dict["rcnn_reg"] = rcnn_reg
        if train:
            targets["rcnn_cls"] = rcnn_cls
            targets["rcnn_reg"] = rcnn_reg
            batch_dict["roi_targets_dict"] = targets
            return batch_dict
        # the anchor head's outputs, which the RoI stage's replace, stay
        # readable for the parity checks
        batch_dict["rpn_cls_preds"] = batch_dict["batch_cls_preds"]
        batch_dict["rpn_box_preds"] = batch_dict["batch_box_preds"]
        batch_dict["batch_box_preds"] = roi_head_utils.rcnn_box_decode(
            rois[..., :7], rcnn_reg)
        batch_dict["batch_cls_preds"] = rcnn_cls[..., None]
        batch_dict["cls_preds_normalized"] = False
        return batch_dict
