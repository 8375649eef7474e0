"""Point sampling (counterpart of ``de6d_tpu/ops/sampling.py``:
``farthest_point_sample`` (d-fps), ``weighted_farthest_point_sample``
(s-fps), ``matrix_farthest_point_sample`` (f-fps) with
``calc_dist_matrix_for_sampling``, ``sample_top_k_by_score`` (c-fps /
centre-aware), ``gather_points``).

d-fps and s-fps go through ``ops/kernels/fps.py``, f-fps through
``ops/kernels/matrix_fps.py``: the CUDA kernel for tensors on the card,
its plain per-pick loop for tensors on the CPU. Semantics: d-fps and
f-fps seed at index 0, s-fps at the first argmax of the valid weights
and scores candidates by ``min_dist * max(w, 1e-12)`` while updating the
running minimum unweighted; invalid points are never picked while a
valid one is left. Picks carry no gradient.
"""

from __future__ import annotations

import torch

from .kernels.fps import INF, fps
from .kernels.matrix_fps import matrix_fps
from .nms import stable_top_k


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
    indices, seeded at the first argmax of the weights. The weights reach
    the kernel detached: the picks carry no gradient (nor do they in the
    JAX package), whatever the confidence logits' graph."""
    return fps(xyz.float(), _valid(xyz, valid_mask), int(npoint),
               weights=weights.detach().float())


@torch.no_grad()
def matrix_farthest_point_sample(dist_matrix, npoint: int, valid_mask=None):
    """f-fps: FPS over a precomputed (B, N, N) distance matrix →
    (B, npoint) int32 indices, seeded at index 0."""
    return matrix_fps(dist_matrix.float(), _valid(dist_matrix, valid_mask),
                      int(npoint))


def _add_sqdist(out, a, scale: float):
    """``out (N, N) += scale * max(|a_i|² + |a_j|² − 2 a_i·a_j, 0)`` for
    one sample's (N, C) fp32 rows, in the JAX package's operation order:
    the norms are added first, then the doubled cross term subtracted."""
    norm = (a * a).sum(dim=-1)
    d = torch.matmul(a, a.t())
    d.mul_(-2.0)
    d.add_(norm[:, None] + norm[None, :])
    d.clamp_(min=0.0)
    if scale != 1.0:
        d.mul_(scale)
    out.add_(d)


@torch.no_grad()
def calc_dist_matrix_for_sampling(xyz, features=None, gamma: float = 1.0):
    """Fused distance matrix for f-fps: squared euclidean distance of
    the coordinates plus ``gamma`` times that of the features. xyz
    (B, N, 3), features (B, N, C) or None → (B, N, N) fp32.

    Always fp32 with TF32 off, whatever the compute dtype: the matrix
    decides picks. Built sample by sample into one output buffer, so the
    temporaries are (N, N), not (B, N, N)."""
    b, n, _ = xyz.shape
    xyz = xyz.float()
    out = torch.zeros((b, n, n), dtype=torch.float32, device=xyz.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(b):
            _add_sqdist(out[i], xyz[i], 1.0)
            if features is not None:
                _add_sqdist(out[i], features[i].float(), float(gamma))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


@torch.no_grad()
def sample_top_k_by_score(scores, npoint: int, valid_mask=None):
    """c-fps / centre-aware sampling: the indices of the ``npoint``
    largest scores, (B, N) → (B, npoint) int32; equal scores keep the
    lower index first, invalid points score ``-INF``."""
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores, -INF)
    return stable_top_k(scores, int(npoint))[1].to(torch.int32)


def gather_points(points, idx):
    """points (B, N, C), idx (B, M) → (B, M, C)."""
    return torch.gather(
        points, 1, idx.long()[..., None].expand(-1, -1, points.shape[-1])
    )
