"""Point backbones (counterpart of
``de6d_tpu/models/backbones_3d/pointnet2_backbone.py``: ``_build_sa_stack``,
``_PointNet2Base.run_backbone``, ``PointNet2MSG`` (SA + FP, PointRCNN),
``PointNet2FSMSG`` (fusion sampling, Det6D)).

Batch keys written:
  point_coords (B, M, 3), point_features (B, M, C) fp32, point_valid
  (B, M), point_scores (B, M) or None, and per SA layer
  point_coords_list / point_scores_list / point_valid_list, plus
  point_sample_idx_list (each layer's picks into the previous layer's
  points; the JAX package keeps them internal). In train mode the
  scores carry autograd (the SASA loss trains the confidence layers
  through them); the picks do not.
"""

from __future__ import annotations

import torch
from torch import nn

from ...registry import BACKBONES_3D
from ..model_utils.dtype_utils import compute_dtype
from .pointnet2_modules import PointnetFPModule, PointnetSAModuleFSMSG


def _build_sa_stack(model_cfg, input_channels):
    """Per-layer kwargs of the SA stack from SA_CONFIG (with each layer's
    ``in_channels``) and the feature channels of every level: the input
    points', then each SA layer's output."""
    sa_cfg = model_cfg["SA_CONFIG"]
    agg_mlps = sa_cfg.get("AGGREGATION_MLPS", None)
    conf_mlps = sa_cfg.get("CONFIDENCE_MLPS", None)
    if sa_cfg.get("SKIP_CONNECTION", False):
        raise NotImplementedError("SA skip connections are not ported yet")
    if "NPOINT_LIST" in sa_cfg:
        npoint_lists = sa_cfg["NPOINT_LIST"]
        range_lists = sa_cfg["SAMPLE_RANGE_LIST"]
        method_lists = sa_cfg["SAMPLE_METHOD_LIST"]
    else:  # plain-MSG keys
        npoint_lists = [[int(x)] for x in sa_cfg["NPOINTS"]]
        range_lists = [[[0, -1]] for _ in sa_cfg["NPOINTS"]]
        method_lists = [["d-fps"] for _ in sa_cfg["NPOINTS"]]
    cell_cap = (int(sa_cfg.get("BIN_CELL_CAP", 128))
                if sa_cfg.get("BINNED_QUERY", True) else 0)
    spill_cap = int(sa_cfg.get("BIN_SPILL_CAP", 256))

    layers = []
    channel_in = input_channels - 3
    level_channels = [channel_in]
    for k in range(len(npoint_lists)):
        mlps = [list(m) for m in sa_cfg["MLPS"][k]]
        channel_out = sum(m[-1] for m in mlps)
        agg = tuple(agg_mlps[k]) if agg_mlps and agg_mlps[k] else ()
        if agg:
            channel_out = agg[-1]
        conf = tuple(conf_mlps[k]) if conf_mlps and conf_mlps[k] else ()
        layers.append(dict(
            in_channels=channel_in,
            npoint_list=tuple(int(x) for x in npoint_lists[k]),
            sample_range_list=tuple(tuple(int(v) for v in r)
                                    for r in range_lists[k]),
            sample_method_list=tuple(method_lists[k]),
            radii=tuple(float(r) for r in sa_cfg["RADIUS"][k]),
            nsamples=tuple(int(s) for s in sa_cfg["NSAMPLE"][k]),
            mlps=tuple(tuple(m) for m in mlps),
            use_xyz=sa_cfg.get("USE_XYZ", True),
            dilated_radius_group=sa_cfg.get("DILATED_RADIUS_GROUP", False),
            weight_gamma=float(sa_cfg.get("WEIGHT_GAMMA", 1.0)),
            aggregation_mlp=agg,
            confidence_mlp=conf,
            bin_cell_cap=cell_cap,
            bin_spill_cap=spill_cap,
        ))
        level_channels.append(channel_out)
        channel_in = channel_out
    return layers, level_channels


class _PointNet2Base(nn.Module):
    """SA stack, then (with ``FP_MLPS``) the FP stack that carries the
    features back down to an earlier level."""

    def __init__(self, model_cfg, input_channels, point_cloud_range=(),
                 **kwargs):
        super().__init__()
        dt = compute_dtype(model_cfg)
        layers, levels = _build_sa_stack(model_cfg, input_channels)
        self.sa_modules = nn.ModuleList(
            PointnetSAModuleFSMSG(dtype=dt, pc_range=tuple(point_cloud_range),
                                  **kw)
            for kw in layers
        )
        self.num_point_features = levels[-1]
        fp_mlps = model_cfg.get("FP_MLPS") or []
        # fp_modules[i] (i = -1, -2, ...) propagates level i onto level
        # i - 1; its known features are the deepest SA output for i = -1
        # and the previous FP layer's output otherwise
        fp = []
        for k, mlp in enumerate(fp_mlps):
            i = k - len(fp_mlps)
            known = levels[-1] if i == -1 else fp_mlps[k + 1][-1]
            fp.append(PointnetFPModule(known + levels[i - 1], mlp, dtype=dt))
        self.fp_modules = nn.ModuleList(fp)
        if fp:
            self.num_point_features = fp_mlps[0][-1]

    def forward(self, batch_dict):
        points = batch_dict["points"]  # (B, N, 3 + C)
        valid = batch_dict.get("points_mask")
        if valid is None:
            valid = torch.any(points[..., :3] != 0, dim=-1)
        xyz = points[..., :3]
        features = points[..., 3:] if points.shape[-1] > 3 else None
        l_xyz, l_feat, l_scores, l_valid, l_idx = [xyz], [features], [None], \
            [valid], []
        for sa in self.sa_modules:
            nxyz, nfeat, nscores, nvalid, idx = sa(
                l_xyz[-1], l_feat[-1], l_valid[-1], scores=l_scores[-1])
            l_xyz.append(nxyz)
            l_feat.append(nfeat)
            l_scores.append(nscores)
            l_valid.append(nvalid)
            l_idx.append(idx)
        batch_dict["point_coords_list"] = l_xyz[1:]
        batch_dict["point_scores_list"] = l_scores[1:]
        batch_dict["point_valid_list"] = l_valid[1:]
        batch_dict["point_sample_idx_list"] = l_idx
        out = -1
        for i in range(-1, -(len(self.fp_modules) + 1), -1):
            l_feat[i - 1] = self.fp_modules[i](
                l_xyz[i - 1], l_xyz[i], l_feat[i - 1], l_feat[i], l_valid[i])
            out = i - 1
        batch_dict["point_coords"] = l_xyz[out]
        # heads read fp32 features; the SA/FP MLPs may have run in bf16
        batch_dict["point_features"] = l_feat[out].float()
        batch_dict["point_valid"] = l_valid[out]
        batch_dict["point_scores"] = l_scores[-1]
        return batch_dict


@BACKBONES_3D.register
class PointNet2MSG(_PointNet2Base):
    """SA + FP backbone (PointRCNN)."""


@BACKBONES_3D.register
class PointNet2FSMSG(_PointNet2Base):
    """Fusion-sampling SA backbone (SASA / Det6D)."""
