"""IA-SSD encoder (counterpart of
``de6d_tpu/models/backbones_3d/iassd_backbone.py``: ``SampleOnlyLayer``,
``VoteLayer``, ``run_sampling_iassd``, ``IASSD_Backbone``).

Layer plumbing from SA_CONFIG: ``LAYER_TYPE`` ('SA_Layer' | 'Vote_Layer'),
``LAYER_INPUT`` (which earlier output feeds each layer) and ``CTR_INDEX``
(aggregate at that output's points instead of sampling). An SA layer
without radii only samples and gathers. The confidence MLPs emit
``num_class`` logits per point, which the next layer's centre-aware
sampling ranks. The vote layer shifts its input points by clamped
offsets; the last SA layer aggregates at the votes. In train mode the SA
layers, the confidence MLPs and the vote layer take their BatchNorm
statistics from the batch (``self.training``), the confidence logits
keep their gradient for the head's instance-aware losses, and the picks
(FPS, the centre-aware top-k) carry none.

Batch keys written: centers, centers_origin, ctr_offsets,
centers_features (fp32), centers_valid, encoder_coords, encoder_valid,
sa_ins_preds (all three with the input in slot 0), the point-head keys
point_coords / point_features / point_valid, and point_sample_idx_list
(each sampling layer's picks into its input points, None elsewhere; the
JAX package keeps them internal).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import sampling
from ...registry import BACKBONES_3D
from ..model_utils.dtype_utils import compute_dtype
from ..model_utils.layers import Dense
from ..model_utils.mlp import FCStack, SharedMLP
from .pointnet2_modules import PointnetSAModuleFSMSG


class SampleOnlyLayer(nn.Module):
    """SA layer without groupers: the backbone samples and gathers, the
    layer passes the features on and scores them with an optional
    confidence MLP (flax children ``SharedMLP_0``, ``Dense_0``)."""

    def __init__(self, in_channels: int, confidence_mlp=(),
                 confidence_num_class: int = 1):
        super().__init__()
        self.has_confidence = bool(confidence_mlp)
        if confidence_mlp:
            self.SharedMLP_0 = SharedMLP(in_channels, confidence_mlp)
            self.Dense_0 = Dense(self.SharedMLP_0.out_channels,
                                 confidence_num_class)

    def forward(self, feats):
        if not self.has_confidence:
            return feats, None
        return feats, self.Dense_0(self.SharedMLP_0(feats))


class VoteLayer(FCStack):
    """Shared MLP → 3 offsets, clamped per axis to
    ``max_translate_range``; fp32 (votes are geometry). The flax module's
    children carry ``FCStack``'s names: ``Dense_i`` / ``BatchNorm_i``, then
    the biased ``Dense_L``."""

    def __init__(self, in_channels: int, mlp_list, max_translate_range=()):
        super().__init__(in_channels, mlp_list, 3)
        self.register_buffer(
            "max_translate_range",
            torch.tensor([float(v) for v in max_translate_range]),
            persistent=False,
        )

    def forward(self, xyz, features):
        offsets = super().forward(features)  # (B, N, 3)
        if self.max_translate_range.numel():
            lim = self.max_translate_range.to(offsets.dtype)
            offsets = torch.clamp(offsets, -lim, lim)
        return xyz + offsets, offsets


def _part_fps(xyz, keys, npoint: int, valid, parts: int = 4):
    """ds-FPS / ry-FPS: sort by key (invalid points last), split into
    ``parts`` contiguous chunks, d-fps ``npoint // parts`` in each."""
    b, n, _ = xyz.shape
    order = torch.argsort(torch.where(valid, keys, torch.inf), dim=1,
                          stable=True)
    xyz_s = sampling.gather_points(xyz, order)
    valid_s = torch.gather(valid, 1, order)
    per = n // parts
    m = npoint // parts
    xyz_div = xyz_s[:, : per * parts].reshape(b * parts, per, 3)
    valid_div = valid_s[:, : per * parts].reshape(b * parts, per)
    idx = sampling.farthest_point_sample(xyz_div, m, valid_div)
    idx = idx.reshape(b, parts, m) + (
        torch.arange(parts, dtype=torch.int32, device=xyz.device)[None, :,
                                                                   None]
        * per)
    return torch.gather(order, 1, idx.reshape(b, parts * m).long()).to(
        torch.int32)


def run_sampling_iassd(method, xyz, features, cls_logits, valid, npoint: int,
                       sample_range):
    """One sampling group on a slice of the point axis; (B, npoint), or
    (B, 2 * npoint) for FS, int32 indices into the full point axis."""
    lo, hi = sample_range
    hi = xyz.shape[1] if hi == -1 else hi
    xyz_s = xyz[:, lo:hi]
    valid_s = valid[:, lo:hi]

    if ("cls" in method) or ("ctr" in method):
        logits = cls_logits[:, lo:hi]
        if logits.ndim == 3:  # (B, N, num_class) → max class logit
            logits = logits.amax(dim=-1)
        idx = sampling.sample_top_k_by_score(torch.sigmoid(logits), npoint,
                                             valid_s)
    elif method in ("D-FPS", "DFS", "d-fps"):
        idx = sampling.farthest_point_sample(xyz_s, npoint, valid_s)
    elif method in ("F-FPS", "FFS", "f-fps", "FS"):
        # fp32 keys: the picks must not depend on the compute dtype
        dm = sampling.calc_dist_matrix_for_sampling(
            xyz_s, features[:, lo:hi].float())
        idx = sampling.matrix_farthest_point_sample(dm, npoint, valid_s)
        if method == "FS":
            idx = torch.cat([idx, sampling.farthest_point_sample(
                xyz_s, npoint, valid_s)], dim=-1)
    elif "Rand" in method:
        # a fixed stride, as the JAX package has it
        n = xyz_s.shape[1]
        stride = max(1, n // npoint)
        idx = (torch.arange(npoint, dtype=torch.int32, device=xyz.device)
               * stride % n)[None].expand(xyz.shape[0], npoint)
    elif method in ("ds_FPS", "ds-FPS"):
        keys = torch.linalg.norm(xyz_s, dim=-1) - 5.0
        idx = _part_fps(xyz_s, keys, npoint, valid_s)
    elif method in ("ry_FPS", "ry-FPS"):
        y = xyz_s[..., 1]
        keys = torch.arctan(xyz_s[..., 0]
                            / torch.where(y.abs() < 1e-6, 1e-6, y))
        idx = _part_fps(xyz_s, keys, npoint, valid_s)
    else:
        raise NotImplementedError(f"IASSD sampling {method}")
    return idx + lo


@BACKBONES_3D.register
class IASSD_Backbone(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class=3,
                 point_cloud_range=(), **kwargs):
        super().__init__()
        sa = model_cfg["SA_CONFIG"]
        self.layer_types = list(sa["LAYER_TYPE"])
        n_layers = len(self.layer_types)
        self.layer_inputs = list(sa["LAYER_INPUT"])
        self.ctr_indexes = list(sa.get("CTR_INDEX", [-1] * n_layers))
        self.npoint_list = list(sa["NPOINT_LIST"])
        self.range_list = list(sa.get("SAMPLE_RANGE_LIST",
                                      [[0, -1]] * n_layers))
        self.method_list = list(sa["SAMPLE_METHOD_LIST"])
        agg_mlps = sa.get("AGGREGATION_MLPS")
        conf_mlps = sa.get("CONFIDENCE_MLPS")
        dilated = sa.get("DILATED_GROUP", [False] * n_layers)
        cell_cap = (int(sa.get("BIN_CELL_CAP", 128))
                    if sa.get("BINNED_QUERY", True) else 0)

        modules = []
        channels = [int(input_channels) - 3]  # per encoder output
        for k, ltype in enumerate(self.layer_types):
            cin = channels[self.layer_inputs[k]]
            if ltype == "Vote_Layer":
                modules.append(VoteLayer(
                    cin, sa["MLPS"][k],
                    tuple(sa.get("MAX_TRANSLATE_RANGE", ()))))
                channels.append(cin)
                continue
            if ltype != "SA_Layer":
                raise NotImplementedError(ltype)
            conf = tuple(conf_mlps[k]) if conf_mlps and conf_mlps[k] else ()
            radii = tuple(float(r) for r in sa["RADIUS_LIST"][k])
            if not radii:
                modules.append(SampleOnlyLayer(cin, conf, num_class))
                channels.append(cin)
                continue
            modules.append(PointnetSAModuleFSMSG(
                in_channels=cin, radii=radii,
                nsamples=sa["NSAMPLE_LIST"][k], mlps=sa["MLPS"][k],
                use_xyz=True, dilated_radius_group=bool(dilated[k]),
                aggregation_mlp=(tuple(agg_mlps[k])
                                 if agg_mlps and agg_mlps[k] else ()),
                confidence_mlp=conf, confidence_num_class=num_class,
                dtype=compute_dtype(model_cfg),
                pc_range=tuple(point_cloud_range), bin_cell_cap=cell_cap,
                bin_spill_cap=int(sa.get("BIN_SPILL_CAP", 256)),
            ))
            channels.append(modules[-1].out_channels)
        self.sa_modules = nn.ModuleList(modules)
        # the last grouping SA layer's width (sampling-only and vote
        # layers keep their input's)
        self.num_point_features = next(
            m.out_channels for m in reversed(modules)
            if isinstance(m, PointnetSAModuleFSMSG))

    def _sample(self, k, xyz, feats, cls_logits, valid):
        ranges = self.range_list[k]
        if not isinstance(ranges[0], (list, tuple)):
            ranges = [ranges]
        return torch.cat([
            run_sampling_iassd(m, xyz, feats, cls_logits, valid, int(np_),
                               rng_)
            for m, np_, rng_ in zip(self.method_list[k], self.npoint_list[k],
                                    ranges)
        ], dim=-1)

    def forward(self, batch_dict):
        points = batch_dict["points"]  # (B, N, 3 + C)
        valid = batch_dict.get("points_mask")
        if valid is None:
            valid = torch.ones(points.shape[:2], dtype=torch.bool,
                               device=points.device)
        enc_xyz, enc_feats, enc_valid = [points[..., :3]], [points[..., 3:]], \
            [valid]
        sa_ins_preds, picks = [None], []
        cls_logits = None
        centers = centers_origin = ctr_offsets = None

        for k, mod in enumerate(self.sa_modules):
            inp = self.layer_inputs[k]
            xyz_in, feat_in, valid_in = enc_xyz[inp], enc_feats[inp], \
                enc_valid[inp]
            sample_idx = None
            if isinstance(mod, VoteLayer):
                li_xyz, ctr_offsets = mod(xyz_in, feat_in)
                centers, centers_origin = li_xyz, xyz_in
                li_feats, li_valid, li_cls = feat_in, valid_in, None
            else:
                ctr_i = self.ctr_indexes[k]
                if ctr_i != -1 and not isinstance(mod, SampleOnlyLayer):
                    new_xyz, new_valid = enc_xyz[ctr_i], enc_valid[ctr_i]
                else:
                    sample_idx = self._sample(k, xyz_in, feat_in, cls_logits,
                                              valid_in)
                    new_xyz = sampling.gather_points(xyz_in, sample_idx)
                    new_valid = torch.gather(valid_in, 1, sample_idx.long())
                if isinstance(mod, SampleOnlyLayer):
                    li_xyz, li_valid = new_xyz, new_valid
                    li_feats, li_cls = mod(
                        sampling.gather_points(feat_in, sample_idx))
                else:
                    li_xyz, li_feats, li_cls, li_valid, _ = mod(
                        xyz_in, feat_in, valid_in, new_xyz=new_xyz,
                        new_valid=new_valid)
                cls_logits = li_cls
            enc_xyz.append(li_xyz)
            enc_feats.append(li_feats)
            enc_valid.append(li_valid)
            sa_ins_preds.append(li_cls)
            picks.append(sample_idx)

        # heads read fp32 features; the SA MLPs may have run in bf16
        feats = enc_feats[-1].float()
        batch_dict.update(
            centers=centers, centers_origin=centers_origin,
            ctr_offsets=ctr_offsets, centers_features=feats,
            centers_valid=enc_valid[-1], encoder_coords=enc_xyz,
            encoder_valid=enc_valid, sa_ins_preds=sa_ins_preds,
            point_sample_idx_list=picks, point_coords=centers,
            point_features=feats, point_valid=enc_valid[-1],
        )
        return batch_dict
