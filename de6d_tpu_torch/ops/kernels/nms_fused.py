"""Batched fused greedy rotated-BEV NMS with early stop at ``post_k``.

Replaces the TPU kernel ``de6d_tpu/ops/pallas/nms_fused.py:
nms_keep_batched``. The CUDA kernel is ``csrc/nms_fused.cu``: one block
per sample walks its 128-column blocks in order, tests each column
against the compacted kept list in shared memory, resolves the diagonal
tile with a 128-bit suppressor mask per column, and stops doing IoU
work once ``post_k`` boxes are kept. It is bound by fp32 operations:
about :data:`FLOPS_PER_IOU` per IoU, for the IoUs this input needs.
"""

from __future__ import annotations

import torch

from .. import iou3d
from . import build

BLK = 128
# fp32 add/sub/mul/div/min/max of one IoU in csrc/nms_fused.cu, counted
# from its source (a division counts as one). Per green_pass: the 4 edge
# vectors of q, 8 ops, computed once (the unrolled loop hoists them);
# per edge of p, 4 clips x 10 (f0: 6, fd: 3, t_cross: 1) + 6 running
# min/max + dx, dy: 2 + clamps: 5 + clipped ends: 8 + shoelace: 4 = 65;
# 3 adds of the edge terms: 8 + 4 x 65 + 3 = 271. Per IoU: 2 passes +
# sum, area sum, union, clamp, quotient: 2 x 271 + 5 = 547.
FLOPS_PER_IOU = 547
_SMEM_LIMIT = 227 * 1024 - 16 * 1024  # dynamic room beside the static tiles


def _k_cap(post_k: int, p: int) -> int:
    """Kept-list capacity: post_k rounded up to a block, plus one spare
    block for the keeps of the block in which the post_k-th lands."""
    return min((post_k + BLK - 1) // BLK * BLK + BLK, p + BLK)


def nms_keep_batched_plain(boxes, valid_counts, thresh: float, post_k: int):
    """Plain PyTorch version, same arithmetic and the same truncation:
    column blocks in order; suppression from every kept earlier column,
    then the diagonal tile's recurrence column by column."""
    b, p = boxes.shape[0], boxes.shape[1]
    dev = boxes.device
    packed = iou3d.pack_bev(boxes[..., :7])  # (B, 9, P)
    counts = torch.clamp(valid_counts.to(dev).long(), max=p)
    keep = torch.zeros(b, p, dtype=torch.bool, device=dev)
    nk = torch.zeros(b, dtype=torch.long, device=dev)
    upper = torch.ones(BLK, BLK, dtype=torch.bool, device=dev).triu(1)
    for col0 in range(0, p, BLK):
        needed = (col0 < counts) & (nk < post_k)
        if not bool(needed.any()):
            break
        cols = packed[:, :, col0:col0 + BLK]
        col_ids = col0 + torch.arange(BLK, device=dev)
        live = (col_ids[None] < counts[:, None]) & needed[:, None]
        if col0 > 0:
            over = iou3d.pairwise_iou_packed(packed[:, :, :col0], cols) > thresh
            live &= ~(over & keep[:, :col0, None]).any(dim=1)
        sub = (iou3d.pairwise_iou_packed(cols, cols) > thresh) & upper
        kb = torch.zeros(b, BLK, dtype=torch.bool, device=dev)
        for c in range(BLK):
            hit = (sub[:, :, c] & kb).any(dim=1)
            kb[:, c] = live[:, c] & ~hit
        keep[:, col0:col0 + BLK] = kb
        nk += kb.sum(dim=1)
    return keep


def nms_keep_batched(boxes, valid_counts, thresh: float, post_k=None):
    """(B, P, 7+) score-descending candidates (invalid ones a suffix,
    P % 128 == 0) + (B,) int32 live counts → (B, P) bool keep flags,
    exact greedy NMS through the column block in which the ``post_k``-th
    keep lands and all False after it.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    b, p = boxes.shape[0], boxes.shape[1]
    if p % BLK:
        raise ValueError(f"nms_keep_batched: P={p} is not a multiple of {BLK}")
    post_k = p if post_k is None else min(int(post_k), p)
    if boxes.device.type == "cpu":
        return nms_keep_batched_plain(boxes, valid_counts, thresh, post_k)
    if boxes.device.type != "cuda" or valid_counts.device != boxes.device:
        raise ValueError(f"nms_keep_batched: unsupported devices "
                         f"{boxes.device}, {valid_counts.device}")
    if boxes.dtype != torch.float32:
        raise TypeError(f"nms_keep_batched: boxes dtype {boxes.dtype}")
    if valid_counts.shape != (b,):
        raise ValueError(f"nms_keep_batched: counts {tuple(valid_counts.shape)}")
    packed = iou3d.pack_bev(boxes[..., :7]).contiguous()
    return nms_keep_packed(packed, valid_counts, thresh, post_k)


def nms_keep_packed(packed, valid_counts, thresh: float, post_k: int):
    """The kernel launch of :func:`nms_keep_batched` on CUDA corners
    already packed by ``iou3d.pack_bev`` ((B, 9, P) fp32, contiguous)."""
    b, p = packed.shape[0], packed.shape[2]
    k_cap = _k_cap(post_k, p)
    if 9 * 4 * k_cap > _SMEM_LIMIT:
        raise ValueError(f"nms_keep_batched: post_k={post_k} needs more "
                         "shared memory than a block has")
    if (packed.device.type != "cuda" or packed.dtype != torch.float32
            or not packed.is_contiguous()):
        raise ValueError("nms_keep_packed: needs contiguous fp32 CUDA corners")
    counts = valid_counts.to(torch.int32).contiguous()
    keep = torch.empty((b, p), dtype=torch.bool, device=packed.device)
    if keep.numel() == 0:
        return keep
    err = build.lib().de6d_nms_keep_batched(
        packed.data_ptr(), counts.data_ptr(), keep.data_ptr(),
        b, p, float(thresh), post_k, k_cap,
        torch.cuda.current_stream(packed.device).cuda_stream,
    )
    build.check(err, "nms_keep_batched")
    nms_keep_batched.launches += 1
    return keep


nms_keep_batched.launches = 0
