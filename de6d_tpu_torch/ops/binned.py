"""Fused SA inference with the folded-BN MLP (counterpart of
``de6d_tpu/ops/binned.py``: ``_affine_mlp_pool``, ``brute_sa_infer`` and
``binned_sa_infer``).

The JAX package's binned query (cell sort, 3x3 windows, spill table) is
a TPU device for pruning candidates; its ``(idx, cnt)`` are
bit-identical to the brute-force ball query by contract, and its spill
overflow falls back to :func:`brute_sa_infer`. The port therefore runs
the brute-force query for both (``ops/ball_query.py``: centers in
chunks, one ``d²`` shared by every scale of the layer), then the same
grouping, folded affine MLP and masked pool.
"""

from __future__ import annotations

import math

import torch

from . import ball_query as bq


def grid_dims(pc_range, cell: float):
    """(Gx, Gy) of a 2-D binning of ``pc_range`` at ``cell``: decides,
    with the cell cap, where the JAX package takes its fused path."""
    gx = max(1, int(math.ceil((pc_range[3] - pc_range[0]) / cell)))
    gy = max(1, int(math.ceil((pc_range[4] - pc_range[1]) / cell)))
    return gx, gy


def _affine_mlp_pool(grouped, cnt, folded, dtype):
    """Folded ``[(W (in, out), b), ...]`` MLP + max pool over the group
    axis (-2), 0 for centers without a hit. Slots past ``cnt`` already
    repeat the first hit."""
    h = grouped.to(dtype)
    for w, bias in folded:
        h = torch.relu(torch.matmul(h, w.to(dtype)) + bias.to(dtype))
    return torch.where((cnt > 0)[..., None], h.amax(dim=-2), 0.0)


def brute_sa_infer(xyz, features, new_xyz, folded, valid_mask,
                   new_valid_mask, radii: tuple, nsamples: tuple,
                   radius_in_list: tuple, use_xyz: bool = True,
                   dtype=torch.float32):
    """Multi-scale SA inference with folded-affine MLPs: query every scale
    (one shared ``d²``), group, MLP, pool. Returns (pooled per scale
    (B, M, C_s), cnt per scale (B, M))."""
    scales = list(zip(radii, radius_in_list, nsamples))
    idx_cnt = bq.ball_query_scales(xyz, new_xyz, scales, valid_mask,
                                   new_valid_mask)
    pooled, cnts = [], []
    for (idx, cnt), fold in zip(idx_cnt, folded):
        grouped = bq.group_with_idx(xyz, new_xyz, features, idx,
                                    use_xyz=use_xyz)
        pooled.append(_affine_mlp_pool(grouped, cnt, fold, dtype))
        cnts.append(cnt)
    return tuple(pooled), tuple(cnts)
