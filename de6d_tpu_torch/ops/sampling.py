"""Farthest-point sampling (counterpart of ``de6d_tpu/ops/sampling.py``:
``farthest_point_sample`` (d-fps), ``weighted_farthest_point_sample``
(s-fps), ``gather_points``).

Both samplers go through ``ops/kernels/fps.py``: the CUDA kernel for
tensors on the card, its plain per-pick loop for tensors on the CPU.
Semantics: d-fps seeds at index 0, s-fps at the first argmax of the
valid weights and scores candidates by ``min_dist * max(w, 1e-12)``
while updating the running minimum unweighted; invalid points are never
picked while a valid one is left. Picks carry no gradient.
"""

from __future__ import annotations

import torch

from .kernels.fps import fps


def _valid(xyz, valid_mask):
    if valid_mask is None:
        return torch.ones(xyz.shape[:2], dtype=torch.bool, device=xyz.device)
    return valid_mask


@torch.no_grad()
def farthest_point_sample(xyz, npoint: int, valid_mask=None):
    """(B, N, 3) → (B, npoint) int32 indices, seeded at index 0."""
    return fps(xyz.float(), _valid(xyz, valid_mask), int(npoint))


@torch.no_grad()
def weighted_farthest_point_sample(xyz, weights, npoint: int,
                                   valid_mask=None):
    """s-fps (SASA): (B, N, 3), (B, N) weights → (B, npoint) int32
    indices, seeded at the first argmax of the weights."""
    return fps(xyz.float(), _valid(xyz, valid_mask), int(npoint),
               weights=weights.float())


def gather_points(points, idx):
    """points (B, N, C), idx (B, M) → (B, M, C)."""
    return torch.gather(
        points, 1, idx.long()[..., None].expand(-1, -1, points.shape[-1])
    )
