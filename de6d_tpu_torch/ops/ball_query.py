"""Ball query, grouping and 3-NN interpolation (counterpart of
``de6d_tpu/ops/ball_query.py``: ``_pairwise_sqdist``, ``ball_query``,
``group_points``, ``group_with_idx``, ``three_nn``,
``three_nn_interpolate_weights``, ``three_interpolate``).

Contract (the reference's ``ball_query_kernel_fast``): per center, the
FIRST ``nsample`` points in point order with ``r_in² <= d² < r²``,
padded with the first hit, index 0 when there is no hit, and the hit
count capped at ``nsample`` (0 for an invalid center).

``d²`` is the JAX package's ``max(|c|² + |p|² - 2 c·p, 0)`` with the
rounding the JAX package gets on the CPU, where XLA contracts the
three-term sums into fused multiply-adds: ``|p|² = fma(z, z, fma(y, y,
x*x))`` and ``c·p`` likewise. The cross term cancels heavily (|c|, |p|
are tens of metres, d under one), so another rounding moves points that
sit near a radius in or out of the ball; the fused steps are computed
here exactly in float64 and rounded once to float32.

All scales of an MSG layer share one ``d²`` per chunk of centers
(:func:`ball_query_scales`); the first hits come from a running count
of hits and a binary search per slot, as in the JAX package.
"""

from __future__ import annotations

import torch

# centers per chunk are chosen so a chunk's (B, chunk, N) tensors hold
# at most this many elements
CHUNK_ELEMS = 1 << 25
INF = 1e10


def _fma(a, b, c):
    """float32 fused multiply-add, computed in float64 and rounded once."""
    return (a.double() * b.double() + c.double()).float()


def sq_norm(p):
    """(..., 3) → (...) ``fma(z, z, fma(y, y, x*x))``."""
    x, y, z = p.float().unbind(-1)
    return _fma(z, z, _fma(y, y, x * x))


def pairwise_sqdist(c, p, nc=None, np_=None):
    """(B, M, 3) centers x (B, N, 3) points → (B, M, N) squared distances,
    rounded as the JAX package's ``_pairwise_sqdist`` on the CPU.
    ``nc`` / ``np_`` are the precomputed :func:`sq_norm` of each side."""
    nc = sq_norm(c) if nc is None else nc
    np_ = sq_norm(p) if np_ is None else np_
    c = c.float()[:, :, None, :]
    p = p.float()[:, None, :, :]
    cross = c[..., 0] * p[..., 0]
    cross = _fma(c[..., 1], p[..., 1], cross)
    cross = _fma(c[..., 2], p[..., 2], cross)
    return torch.clamp((nc[:, :, None] + np_[:, None, :]) - 2.0 * cross,
                       min=0.0)


def _first_hits(in_ball, nsample: int):
    """(B, C, N) bool → (idx (B, C, nsample) int32, cnt (B, C) int32)."""
    n = in_ball.shape[-1]
    rank = torch.cumsum(in_ball, dim=-1, dtype=torch.int32)
    ks = torch.arange(1, nsample + 1, dtype=torch.int32,
                      device=in_ball.device)
    first = torch.searchsorted(
        rank, ks.expand(*rank.shape[:-1], nsample).contiguous()
    )  # n = no k-th hit
    cnt = torch.clamp(rank[..., -1], max=nsample)
    fill = torch.where(cnt > 0, first[..., 0], 0)
    idx = torch.where(first < n, first, fill[..., None])
    return idx.to(torch.int32), cnt


def ball_query_scales(xyz, new_xyz, scales, valid_mask=None,
                      new_valid_mask=None):
    """Ball query for several ``(radius, radius_in, nsample)`` scales that
    share one ``d²``. Returns ``[(idx (B, M, ns) int32, cnt (B, M)
    int32), ...]``, one pair per scale."""
    b, n, _ = xyz.shape
    m = new_xyz.shape[1]
    dev = xyz.device
    if valid_mask is None:
        valid_mask = torch.ones(b, n, dtype=torch.bool, device=dev)
    if new_valid_mask is None:
        new_valid_mask = torch.ones(b, m, dtype=torch.bool, device=dev)
    # thresholds as float32, as the JAX package compares them
    bounds = [
        (torch.tensor(float(r) * float(r), dtype=torch.float32, device=dev),
         torch.tensor(float(ri) * float(ri), dtype=torch.float32, device=dev),
         int(ns))
        for r, ri, ns in scales
    ]
    np_ = sq_norm(xyz)
    nc = sq_norm(new_xyz)
    chunk = max(1, min(m, CHUNK_ELEMS // max(1, b * n)))
    outs = [([], []) for _ in scales]
    for c0 in range(0, m, chunk):
        ctr = new_xyz[:, c0:c0 + chunk]
        d2 = pairwise_sqdist(ctr, xyz, nc[:, c0:c0 + chunk], np_)
        ok = valid_mask[:, None, :] & new_valid_mask[:, c0:c0 + chunk, None]
        for (r2, ri2, ns), (idx_l, cnt_l) in zip(bounds, outs):
            idx, cnt = _first_hits(ok & (d2 < r2) & (d2 >= ri2), ns)
            idx_l.append(idx)
            cnt_l.append(cnt)
    return [(torch.cat(i, dim=1), torch.cat(c, dim=1)) for i, c in outs]


def ball_query(xyz, new_xyz, radius: float, nsample: int, valid_mask=None,
               new_valid_mask=None, radius_in: float = 0.0):
    """One scale of :func:`ball_query_scales`: (idx (B, M, nsample) int32,
    cnt (B, M) int32)."""
    return ball_query_scales(xyz, new_xyz, [(radius, radius_in, nsample)],
                             valid_mask, new_valid_mask)[0]


def group_points(features, idx):
    """features (B, N, C), idx (B, M, ns) → (B, M, ns, C). A gather along
    the point axis, whose backward is one scatter-add (advanced indexing's
    backward sorts its indices: ~35 ms a call at PV-RCNN's RoI-grid pool
    on an H100)."""
    b, m, ns = idx.shape
    flat = idx.reshape(b, m * ns).long()[..., None].expand(
        -1, -1, features.shape[-1])
    return torch.gather(features, 1, flat).reshape(b, m, ns, -1)


def group_with_idx(xyz, new_xyz, features, idx, use_xyz: bool = True):
    """Relative-xyz grouping for precomputed ball-query indices: one
    gather of ``[xyz, features]`` (features promoted to fp32, as JAX's
    concatenate promotes them), centers subtracted from the xyz part."""
    if features is not None and use_xyz:
        g = group_points(torch.cat([xyz.float(), features.float()], -1), idx)
        return torch.cat([g[..., :3] - new_xyz[:, :, None, :], g[..., 3:]],
                         dim=-1)
    if features is not None:
        return group_points(features, idx)
    return group_points(xyz, idx) - new_xyz[:, :, None, :]


def three_nn(unknown, known, valid_mask=None):
    """Brute-force 3-NN: unknown (B, M, 3) queries, known (B, N, 3) →
    dist (B, M, 3) fp32 distances (not squared) and idx (B, M, 3) int32,
    nearest first. ``d²`` is :func:`pairwise_sqdist` (the ball query's),
    invalid known points sit at ``INF``, and each of the three argmin
    passes takes the first index on ties."""
    b, n, _ = known.shape
    m = unknown.shape[1]
    np_ = sq_norm(known)
    nu = sq_norm(unknown)
    chunk = max(1, min(m, CHUNK_ELEMS // max(1, b * n)))
    dists, idxs = [], []
    for c0 in range(0, m, chunk):
        d2 = pairwise_sqdist(unknown[:, c0:c0 + chunk], known,
                             nu[:, c0:c0 + chunk], np_)
        if valid_mask is not None:
            d2 = torch.where(valid_mask[:, None, :], d2, INF)
        d_l, i_l = [], []
        for _ in range(3):
            d, i = torch.min(d2, dim=-1, keepdim=True)
            d_l.append(d)
            i_l.append(i)
            d2.scatter_(-1, i, INF)
        dists.append(torch.cat(d_l, dim=-1))
        idxs.append(torch.cat(i_l, dim=-1))
    dist = torch.sqrt(torch.clamp(torch.cat(dists, dim=1), min=0.0))
    return dist, torch.cat(idxs, dim=1).to(torch.int32)


def three_nn_interpolate_weights(dist):
    """Inverse-distance weights of the FP layers: ``(1/d) / Σ(1/d)``."""
    recip = 1.0 / torch.clamp(dist, min=1e-8)
    return recip / recip.sum(dim=-1, keepdim=True)


def three_interpolate(features, idx, weight):
    """features (B, N, C), idx / weight (B, M, 3) → (B, M, C)."""
    gathered = group_points(features, idx)  # (B, M, 3, C)
    return (gathered * weight[..., None]).sum(dim=2)
