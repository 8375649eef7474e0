"""Farthest-point sampling, d-fps and s-fps, whole pick loop in one launch.

Replaces the TPU kernel ``de6d_tpu/ops/pallas/fps.py:fps_pallas``. The
CUDA kernel is ``csrc/fps.cu``: one 1024-thread block per sample, xyz
in shared memory, each thread's running minima in registers, one
block-wide (key, index) argmax and one barrier per pick. The picks are a
dependency chain, so the kernel is held by latency, not by its
:data:`FLOPS_PER_POINT` operations per point per pick.
"""

from __future__ import annotations

import torch

from . import build

INF = 1e10
MAX_N = 16384  # xyz planes in shared memory: 12 B per point
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


def fps(xyz, valid, npoint: int, weights=None):
    """(B, N, 3) fp32 xyz + (B, N) bool valid (+ (B, N) fp32 weights for
    s-fps) → (B, npoint) int32 picks, seeded at index 0 (d-fps) or at the
    first argmax of the valid weights (s-fps); invalid points are never
    picked while a valid one is left, and picks repeat after that.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    b, n = valid.shape
    if xyz.shape != (b, n, 3):
        raise ValueError(f"fps: xyz {tuple(xyz.shape)} vs valid {(b, n)}")
    if weights is not None and weights.shape != (b, n):
        raise ValueError(f"fps: weights {tuple(weights.shape)} vs {(b, n)}")
    if xyz.device.type == "cpu":
        return fps_plain(xyz, valid, npoint, weights)
    devs = {t.device for t in (xyz, valid, weights) if t is not None}
    if xyz.device.type != "cuda" or len(devs) != 1:
        raise ValueError(f"fps: unsupported devices {devs}")
    if xyz.dtype != torch.float32 or valid.dtype != torch.bool or (
            weights is not None and weights.dtype != torch.float32):
        raise TypeError("fps: needs fp32 xyz and weights and a bool mask")
    if not 1 <= n <= MAX_N or npoint < 1:
        raise ValueError(f"fps: N={n} (1..{MAX_N}), npoint={npoint}")
    out = torch.empty((b, npoint), dtype=torch.int32, device=xyz.device)
    if b == 0:
        return out
    xyz = xyz.contiguous()
    valid = valid.contiguous()
    w_ptr = None if weights is None else weights.contiguous()
    err = build.lib().de6d_fps(
        xyz.data_ptr(), valid.data_ptr(),
        None if w_ptr is None else w_ptr.data_ptr(), out.data_ptr(),
        b, n, int(npoint), torch.cuda.current_stream(xyz.device).cuda_stream,
    )
    build.check(err, "fps")
    fps.launches += 1
    return out


fps.launches = 0


def argmax_rounds(rounds: int, blocks: int, device):
    """Launch ``blocks`` blocks of ``rounds`` empty block-wide argmax
    rounds (the pick loop without its distance work): the kernel's
    latency floor is npoint times the time of one round."""
    out = torch.empty(blocks, dtype=torch.int32, device=device)
    err = build.lib().de6d_fps_argmax_rounds(
        int(rounds), int(blocks), out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    build.check(err, "fps_argmax_rounds")
    return out
