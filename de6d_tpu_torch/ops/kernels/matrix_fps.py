"""f-fps: farthest-point sampling over a precomputed distance matrix,
whole pick loop in one launch.

Replaces the TPU kernel ``de6d_tpu/ops/pallas/fps.py:matrix_fps_pallas``.
The CUDA kernel is ``csrc/matrix_fps.cu``: a thread-block cluster of C
CTAs per sample, each CTA on a slice of the columns with its running
minima in registers; per pick every CTA reads its slice of the last
pick's row, and the argmax runs through ``csrc/cluster_argmax.cuh``
(shared with ``csrc/fps.cu``): one 8-byte DSMEM message per CTA pair,
while each CTA prefetches its own winner's row into L2. Only the picked
rows are read, :func:`bytes_moved` of them; the picks are a dependency
chain, so the kernel is held by latency.

Dispatch (``csrc/matrix_fps.cu:choose_cluster``, read back by
:func:`dispatch`): one CTA per sample for N <= 1024; else C is the
largest of 16, 8, 4, 2 that leaves each CTA at least 512 columns, keeps
B·C within the SM count and lets all B clusters be resident at once;
otherwise 1. SA2 (8 × 4096) runs on clusters of 8,
SA3 (8 × 512) on one CTA per sample.
"""

from __future__ import annotations

import torch

from . import build
from .fps import INF, MAX_N

CLUSTER_SIZES = (1, 2, 4, 8, 16)


def matrix_fps_plain(dist_matrix, valid, npoint: int):
    """Plain PyTorch version (the per-pick loop of the JAX package's
    ``sampling._fps_loop`` over ``dm[last]``), batched: (B, N, N) fp32
    matrix, (B, N) bool valid → (B, npoint) int32."""
    b = dist_matrix.shape[0]
    dev = dist_matrix.device
    md = torch.where(valid, INF, -1.0).to(torch.float32)
    rows = torch.arange(b, device=dev)
    last = torch.zeros(b, dtype=torch.long, device=dev)
    picks = [last]
    for _ in range(1, npoint):
        md = torch.where(valid, torch.minimum(md, dist_matrix[rows, last]),
                         -1.0)
        last = md.argmax(dim=1)  # first maximum
        picks.append(last)
    return torch.stack(picks, dim=1).to(torch.int32)


def bytes_moved(picks, n: int) -> int:
    """Bytes the function must move for these (B, npoint) picks: each
    matrix row that a pick step reads (the distinct picks among the first
    npoint - 1 of a sample) once, the valid mask once, the picks once."""
    b, npoint = picks.shape
    rows = sum(int(p[: npoint - 1].unique().numel()) for p in picks)
    return rows * n * 4 + b * n + b * npoint * 4


def _check(dist_matrix, valid):
    b, n = valid.shape
    if dist_matrix.shape != (b, n, n):
        raise ValueError(f"matrix_fps: matrix {tuple(dist_matrix.shape)} vs "
                         f"valid {(b, n)}")


def _launch(dist_matrix, valid, npoint, cluster):
    """Launch ``csrc/matrix_fps.cu`` on CUDA tensors with ``cluster`` CTAs
    per sample (0: the dispatch rule)."""
    b, n = valid.shape
    if dist_matrix.device.type != "cuda" or valid.device != dist_matrix.device:
        raise ValueError(f"matrix_fps: unsupported devices "
                         f"{dist_matrix.device}, {valid.device}")
    if dist_matrix.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError("matrix_fps: needs an fp32 matrix and a bool mask")
    if not 1 <= n <= MAX_N or npoint < 1:
        raise ValueError(f"matrix_fps: N={n} (1..{MAX_N}), npoint={npoint}")
    if cluster and cluster not in CLUSTER_SIZES:
        raise ValueError(f"matrix_fps: cluster {cluster} (one of "
                         f"{CLUSTER_SIZES})")
    out = torch.empty((b, npoint), dtype=torch.int32,
                      device=dist_matrix.device)
    if b == 0:
        return out
    dist_matrix = dist_matrix.contiguous()
    valid = valid.contiguous()
    err = build.lib().de6d_matrix_fps(
        dist_matrix.data_ptr(), valid.data_ptr(), out.data_ptr(), b, n,
        int(npoint), int(cluster),
        torch.cuda.current_stream(dist_matrix.device).cuda_stream,
    )
    build.check(err, "matrix_fps")
    return out


def matrix_fps(dist_matrix, valid, npoint: int):
    """(B, N, N) fp32 distance matrix + (B, N) bool valid → (B, npoint)
    int32 picks, seeded at index 0: each pick is the first maximum of the
    running minimum of the picked rows, invalid points held at -1 (never
    picked while a valid one is left; picks repeat after that).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    with the cluster size of :func:`dispatch`.
    """
    _check(dist_matrix, valid)
    if dist_matrix.device.type == "cpu":
        return matrix_fps_plain(dist_matrix, valid, npoint)
    out = _launch(dist_matrix, valid, npoint, 0)
    matrix_fps.launches += 1
    return out


matrix_fps.launches = 0


def matrix_fps_cluster(dist_matrix, valid, npoint: int, *, cluster: int):
    """The kernel forced to ``cluster`` CTAs per sample (one of
    :data:`CLUSTER_SIZES`), for checking and timing every variant; CUDA
    tensors only, and not counted in ``matrix_fps.launches``."""
    _check(dist_matrix, valid)
    return _launch(dist_matrix, valid, npoint, cluster)


def dispatch(b: int, n: int) -> int:
    """The cluster size :func:`matrix_fps` launches for batch ``b`` of
    ``n`` points on the current card."""
    c = build.lib().de6d_matrix_fps_dispatch(int(b), int(n))
    if c < 1:
        raise ValueError(f"matrix_fps: no dispatch for B={b}, N={n}")
    return c


def threads(n: int, cluster: int) -> int:
    """Threads per CTA of the variant with ``cluster`` CTAs for N points
    (one of 256, 512, 1024: ``fps.cluster_rounds`` times its floor)."""
    t = build.lib().de6d_matrix_fps_threads(int(n), int(cluster))
    if t < 1:
        raise ValueError(f"matrix_fps: no variant for N={n}, cluster "
                         f"{cluster}")
    return t
