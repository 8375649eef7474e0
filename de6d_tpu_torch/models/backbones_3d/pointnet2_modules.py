"""PointNet++ set abstraction with fusion sampling and feature
propagation (counterpart of
``de6d_tpu/models/backbones_3d/pointnet2_modules.py``: ``run_sampling``,
``PointnetSAModuleFSMSG``, ``PointnetFPModule``).

Batched (B, N, ...) tensors with validity masks. Geometry (sampling,
ball query, grouped offsets) stays fp32; the MLPs run in the compute
dtype; the confidence head's final Dense is fp32. Where the JAX package
takes its fused binned path (eval, a pc_range, and a 3x3 window that
prunes: :meth:`PointnetSAModuleFSMSG._binned_ok`), the port runs the
folded-BN MLP of ``ops/binned.py``; elsewhere, and always in train mode,
it groups every scale's ball (padding slots included, which BatchNorm's
batch statistics read) through Dense → fp32 BN → ReLU, then max-pools
the groups with a hit. The sampling picks carry no gradient.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import ball_query as bq
from ...ops import binned
from ...ops import sampling
from ..model_utils.layers import Dense
from ..model_utils.mlp import SharedMLP


def run_sampling(method: str, xyz, features, scores, valid, npoint: int,
                 sample_range, weight_gamma: float = 1.0):
    """One entry of SAMPLE_METHOD_LIST on a slice of the point axis;
    (B, npoint) int32 indices into the full point axis. d-fps, f-fps,
    s-fps and c-fps are ported; df-fps, sectorized-fps and the
    ground-aware methods raise."""
    lo, hi = int(sample_range[0]), int(sample_range[1])
    if hi == -1:
        hi = xyz.shape[1]
    xyz_s = xyz[:, lo:hi]
    valid_s = valid[:, lo:hi]
    if method == "d-fps":
        idx = sampling.farthest_point_sample(xyz_s, npoint, valid_s)
    elif method == "f-fps":
        # fp32 distance keys whatever the compute dtype: the picks must
        # not depend on it
        dm = sampling.calc_dist_matrix_for_sampling(
            xyz_s, features[:, lo:hi].float(), weight_gamma)
        idx = sampling.matrix_farthest_point_sample(dm, npoint, valid_s)
    elif method in ("s-fps", "c-fps"):
        if scores is None:
            raise ValueError(f"{method} needs confidence scores")
        w = torch.sigmoid(scores[:, lo:hi]) ** weight_gamma
        if method == "s-fps":
            idx = sampling.weighted_farthest_point_sample(xyz_s, w, npoint,
                                                          valid_s)
        else:
            idx = sampling.sample_top_k_by_score(w, npoint, valid_s)
    else:
        raise NotImplementedError(
            f"sampling method {method!r} is not ported yet")
    return idx + lo


class PointnetSAModuleFSMSG(nn.Module):
    """Multi-scale-grouping SA layer with fusion sampling (max pooling; no
    config sets another pool or a skip connection).

    Children follow the flax names: ``SharedMLP_0..S-1`` per scale, then
    the aggregation MLP, then the confidence MLP, and ``Dense_0`` for
    the confidence logits: one per point, or ``confidence_num_class``
    per-class logits (IA-SSD)."""

    def __init__(self, in_channels: int, radii, nsamples, mlps,
                 npoint_list=(), sample_range_list=(), sample_method_list=(),
                 use_xyz=True, dilated_radius_group=False, weight_gamma=1.0,
                 aggregation_mlp=(), confidence_mlp=(),
                 confidence_num_class=0, use_bn=True, dtype=torch.float32,
                 pc_range=(), bin_cell_cap=128, bin_spill_cap=256):
        super().__init__()
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(s) for s in nsamples)
        self.npoint_list = tuple(int(x) for x in npoint_list)
        self.sample_range_list = tuple(tuple(r) for r in sample_range_list)
        self.sample_method_list = tuple(sample_method_list)
        self.use_xyz = use_xyz
        self.dilated_radius_group = dilated_radius_group
        self.weight_gamma = float(weight_gamma)
        self.dtype = dtype
        self.pc_range = tuple(pc_range)
        self.bin_cell_cap = int(bin_cell_cap)
        self.bin_spill_cap = int(bin_spill_cap)
        self.n_scales = len(mlps)
        cin = int(in_channels) + (3 if use_xyz else 0)
        out = 0
        for i, mlp in enumerate(mlps):
            m = SharedMLP(cin, mlp, use_bn=use_bn, dtype=dtype)
            self.add_module(f"SharedMLP_{i}", m)
            out += m.out_channels
        n = self.n_scales
        self.has_aggregation = bool(aggregation_mlp)
        if aggregation_mlp:
            m = SharedMLP(out, aggregation_mlp, use_bn=use_bn, dtype=dtype)
            self.add_module(f"SharedMLP_{n}", m)
            out = m.out_channels
            n += 1
        self.has_confidence = bool(confidence_mlp)
        self.confidence_num_class = int(confidence_num_class)
        if confidence_mlp:
            m = SharedMLP(out, confidence_mlp, use_bn=use_bn, dtype=dtype)
            self.add_module(f"SharedMLP_{n}", m)
            self.Dense_0 = Dense(m.out_channels,
                                 max(self.confidence_num_class, 1))
        self.out_channels = out

    def _scale_tuples(self):
        """(radii, inner radii, nsamples) per scale; inner radii are the
        previous scale's radius when the radius groups are dilated."""
        r_ins, prev = [], 0.0
        for r in self.radii:
            r_ins.append(prev if self.dilated_radius_group else 0.0)
            prev = r
        return self.radii, tuple(r_ins), self.nsamples

    def _binned_ok(self, n: int) -> bool:
        """The JAX package's choice of its fused path: a pc_range, a cap,
        and a 3x3 window of at most 9*cap + spill candidates that is
        smaller than the N brute-force columns."""
        if not (self.pc_range and self.bin_cell_cap > 0):
            return False
        gx, gy = binned.grid_dims(self.pc_range, max(self.radii))
        cand = 9 * self.bin_cell_cap + max(0, self.bin_spill_cap)
        return gx * gy >= 64 and cand < n

    def forward(self, xyz, features=None, valid=None, scores=None,
                new_xyz=None, new_valid=None):
        """xyz (B, N, 3); features (B, N, C) or None; valid (B, N); scores
        (B, N) or None; optional externally supplied centers.

        Returns (new_xyz (B, M, 3), new_features (B, M, C'), new_scores
        (B, M) or (B, M, confidence_num_class) fp32 or None, new_valid
        (B, M), sample_idx (B, M) int32 or None when the centers were
        given)."""
        b, n, _ = xyz.shape
        if valid is None:
            valid = torch.ones(b, n, dtype=torch.bool, device=xyz.device)
        sample_idx = None
        if new_xyz is None:
            sample_idx = torch.cat([
                run_sampling(m, xyz, features, scores, valid, np_i, rng,
                             self.weight_gamma)
                for m, np_i, rng in zip(self.sample_method_list,
                                        self.npoint_list,
                                        self.sample_range_list)
            ], dim=-1)
            new_xyz = sampling.gather_points(xyz, sample_idx)
            new_valid = torch.gather(valid, 1, sample_idx.long())
        elif new_valid is None:
            new_valid = torch.ones(new_xyz.shape[:2], dtype=torch.bool,
                                   device=xyz.device)

        scale_mlps = [getattr(self, f"SharedMLP_{i}")
                      for i in range(self.n_scales)]
        radii, r_ins, nsamples = self._scale_tuples()
        if not self.training and self._binned_ok(n):
            pooled_list, _ = binned.brute_sa_infer(
                xyz, features, new_xyz, [m.folded() for m in scale_mlps],
                valid, new_valid, radii, nsamples, r_ins,
                use_xyz=self.use_xyz, dtype=self.dtype,
            )
            pooled_list = list(pooled_list)
        else:
            idx_cnt = bq.ball_query_scales(
                xyz, new_xyz, list(zip(radii, r_ins, nsamples)), valid,
                new_valid)
            pooled_list = []
            for mlp, (idx, cnt) in zip(scale_mlps, idx_cnt):
                grouped = bq.group_with_idx(xyz, new_xyz, features, idx,
                                            use_xyz=self.use_xyz)
                out = mlp(grouped)  # (B, M, ns, C_s)
                mask = (cnt > 0)[..., None, None]
                pooled = torch.where(mask, out, -torch.inf).amax(dim=2)
                pooled_list.append(
                    torch.where(torch.isfinite(pooled), pooled, 0.0))

        new_features = torch.cat(pooled_list, dim=-1)
        n_named = self.n_scales
        if self.has_aggregation:
            new_features = getattr(self, f"SharedMLP_{n_named}")(new_features)
            n_named += 1
        new_scores = None
        if self.has_confidence:
            h = getattr(self, f"SharedMLP_{n_named}")(new_features)
            new_scores = self.Dense_0(h.float())
            if self.confidence_num_class == 0:
                new_scores = new_scores.squeeze(-1)
        return new_xyz, new_features, new_scores, new_valid, sample_idx


class PointnetFPModule(nn.Module):
    """Feature propagation: 3-NN inverse-distance interpolation of the
    known points' features onto the unknown points, concatenated with
    the unknown points' own features, then a shared MLP (flax child
    ``SharedMLP_0``)."""

    def __init__(self, in_channels: int, mlp, use_bn=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.SharedMLP_0 = SharedMLP(in_channels, mlp, use_bn=use_bn,
                                     dtype=dtype)
        self.out_channels = self.SharedMLP_0.out_channels

    def forward(self, unknown, known, unknown_feats, known_feats,
                known_valid=None):
        """unknown (B, N, 3), known (B, M, 3), unknown_feats (B, N, C1) or
        None, known_feats (B, M, C2) → (B, N, mlp[-1])."""
        dist, idx = bq.three_nn(unknown, known, known_valid)
        weight = bq.three_nn_interpolate_weights(dist)
        new_features = bq.three_interpolate(known_feats, idx, weight)
        if unknown_feats is not None:
            new_features = torch.cat([new_features.to(self.dtype),
                                      unknown_feats.to(self.dtype)], dim=-1)
        return self.SharedMLP_0(new_features)
