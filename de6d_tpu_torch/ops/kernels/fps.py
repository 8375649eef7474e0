"""Farthest-point sampling, d-fps and s-fps, whole pick loop in one launch.

Replaces the TPU kernel ``de6d_tpu/ops/pallas/fps.py:fps_pallas``. The
CUDA kernel is ``csrc/fps.cu``: a thread-block cluster of C CTAs per
sample, each CTA on a contiguous slice of the points, every thread's
points (x, y, z, running minimum, weight) in registers and the sample's
xyz in each CTA's shared memory. Per pick the warps' winners, ordered
64-bit (key, index) words, meet in shared memory, and each CTA's winner
goes to every CTA of the cluster as one 8-byte DSMEM message counted by
an mbarrier. The picks are a dependency chain, so the kernel is held by
latency, not by its :data:`FLOPS_PER_POINT` operations per point per
pick.

Dispatch (``csrc/fps.cu:choose_cluster``, read back by :func:`dispatch`):
one CTA per sample for N <= 2048; else C is the largest of 16, 8, 4, 2
that leaves each CTA at least 512 points, keeps
B·C within the SM count and lets all B clusters be resident at once;
otherwise the least C whose slices fit in registers (1 for N <= 8192,
else 2). Batch 8 × 16384 runs on 8 clusters of 8 CTAs on the H100 (the
192 KiB xyz copy leaves no room for 8 co-resident clusters of 16), batch
8 × 4096 on clusters of 8, and N <= 2048 or a batch that fills the card
(PointRCNN's 800 RoI point sets) on one CTA per sample.
"""

from __future__ import annotations

import torch

from . import build

INF = 1e10
MAX_N = 16384
MAX_POINTS_PER_CTA = 8192  # 1024 threads x 8 points in registers
CLUSTER_SIZES = (1, 2, 4, 8, 16)
# fp32 operations per point per pick in csrc/fps.cu, counted from its
# source: 3 differences, 3 squares, 2 adds, the running min, then the
# running argmax compare: 10 (d-fps); s-fps adds the key's sign test
# and product: 12.
FLOPS_PER_POINT = {False: 10, True: 12}


def fps_plain(xyz, valid, npoint: int, weights=None):
    """Plain PyTorch version (the per-pick loop of the JAX package's
    ``sampling._fps_loop``), batched: (B, N, 3) fp32 xyz, (B, N) bool
    valid, optional (B, N) fp32 weights (s-fps) → (B, npoint) int32."""
    b, n, _ = xyz.shape
    dev = xyz.device
    x, y, z = xyz.float().unbind(-1)
    md = torch.where(valid, INF, -1.0).to(torch.float32)
    rows = torch.arange(b, device=dev)
    if weights is None:
        last = torch.zeros(b, dtype=torch.long, device=dev)
    else:
        w = weights.float()
        w_eff = torch.clamp(w, min=1e-12)
        last = torch.where(valid, w, -INF).argmax(dim=1)
    picks = [last]
    for _ in range(1, npoint):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        d = (dx * dx + dy * dy) + dz * dz
        md = torch.where(valid, torch.minimum(md, d), -1.0)
        key = md if weights is None else torch.where(md >= 0, md * w_eff, md)
        last = key.argmax(dim=1)  # first maximum
        picks.append(last)
    return torch.stack(picks, dim=1).to(torch.int32)


def _check(xyz, valid, npoint, weights):
    b, n = valid.shape
    if xyz.shape != (b, n, 3):
        raise ValueError(f"fps: xyz {tuple(xyz.shape)} vs valid {(b, n)}")
    if weights is not None and weights.shape != (b, n):
        raise ValueError(f"fps: weights {tuple(weights.shape)} vs {(b, n)}")


def _launch(xyz, valid, npoint, weights, cluster):
    """Launch ``csrc/fps.cu`` on CUDA tensors with ``cluster`` CTAs per
    sample (0: the dispatch rule)."""
    b, n = valid.shape
    devs = {t.device for t in (xyz, valid, weights) if t is not None}
    if xyz.device.type != "cuda" or len(devs) != 1:
        raise ValueError(f"fps: unsupported devices {devs}")
    if xyz.dtype != torch.float32 or valid.dtype != torch.bool or (
            weights is not None and weights.dtype != torch.float32):
        raise TypeError("fps: needs fp32 xyz and weights and a bool mask")
    if not 1 <= n <= MAX_N or npoint < 1:
        raise ValueError(f"fps: N={n} (1..{MAX_N}), npoint={npoint}")
    if cluster and cluster not in cluster_sizes(n):
        raise ValueError(f"fps: cluster {cluster} for N={n} (one of "
                         f"{cluster_sizes(n)})")
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    if b == 0:
        return out
    xyz = xyz.contiguous()
    valid = valid.contiguous()
    w_ptr = None if weights is None else weights.contiguous()
    err = build.lib().de6d_fps(
        xyz.data_ptr(), valid.data_ptr(),
        None if w_ptr is None else w_ptr.data_ptr(), out.data_ptr(),
        b, n, int(npoint), int(cluster),
        torch.cuda.current_stream(xyz.device).cuda_stream,
    )
    build.check(err, "fps")
    return out


def fps(xyz, valid, npoint: int, weights=None):
    """(B, N, 3) fp32 xyz + (B, N) bool valid (+ (B, N) fp32 weights for
    s-fps) → (B, npoint) int32 picks, seeded at index 0 (d-fps) or at the
    first argmax of the valid weights (s-fps); invalid points are never
    picked while a valid one is left, and picks repeat after that.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    with the cluster size of :func:`dispatch`.
    """
    _check(xyz, valid, npoint, weights)
    if xyz.device.type == "cpu":
        return fps_plain(xyz, valid, npoint, weights)
    out = _launch(xyz, valid, npoint, weights, 0)
    fps.launches += 1
    return out


fps.launches = 0


def fps_cluster(xyz, valid, npoint: int, weights=None, *, cluster: int):
    """The kernel forced to ``cluster`` CTAs per sample (one of
    :func:`cluster_sizes`), for checking every dispatch variant; CUDA
    tensors only, and not counted in ``fps.launches``."""
    _check(xyz, valid, npoint, weights)
    return _launch(xyz, valid, npoint, weights, cluster)


def cluster_sizes(n: int):
    """The cluster sizes the kernel takes for N points."""
    return tuple(c for c in CLUSTER_SIZES
                 if -(-n // c) <= MAX_POINTS_PER_CTA)


def dispatch(b: int, n: int, weighted: bool) -> int:
    """The cluster size :func:`fps` launches for batch ``b`` of ``n``
    points on the current card."""
    c = build.lib().de6d_fps_dispatch(int(b), int(n), int(weighted))
    if c < 1:
        raise ValueError(f"fps: no dispatch for B={b}, N={n}")
    return c


def threads(n: int, cluster: int) -> int:
    """Threads per CTA of the variant with ``cluster`` CTAs for N points."""
    t = build.lib().de6d_fps_threads(int(n), int(cluster))
    if t < 1:
        raise ValueError(f"fps: no variant for N={n}, cluster {cluster}")
    return t


def cluster_rounds(rounds: int, clusters: int, cluster: int, n_threads: int,
                   device):
    """Launch ``clusters`` clusters of ``cluster`` CTAs of ``n_threads``
    threads running ``rounds`` empty pick rounds (warp reduce, the CTA's
    __syncthreads and, for a cluster, the DSMEM messages): the latency
    floor of that variant is npoint times the time of one round."""
    out = torch.empty(clusters * cluster, dtype=torch.int32, device=device)
    err = build.lib().de6d_fps_cluster_rounds(
        int(rounds), int(clusters), int(cluster), int(n_threads),
        out.data_ptr(), torch.cuda.current_stream(device).cuda_stream,
    )
    build.check(err, "fps_cluster_rounds")
    return out


def argmax_rounds(rounds: int, blocks: int, device):
    """Launch ``blocks`` blocks of ``rounds`` empty block-wide argmax
    rounds of ``csrc/block_argmax.cuh`` (the first, single-block kernel's
    pick loop without its distance work)."""
    out = torch.empty(blocks, dtype=torch.int32, device=device)
    err = build.lib().de6d_fps_argmax_rounds(
        int(rounds), int(blocks), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    build.check(err, "fps_argmax_rounds")
    return out
