"""Batched fused greedy rotated-BEV NMS with early stop at ``post_k``.

Replaces the TPU kernel ``de6d_tpu/ops/pallas/nms_fused.py:
nms_keep_batched``. The CUDA kernel is ``csrc/nms_fused.cu``: one block
of 512 threads per sample builds each 128-column block's corners from
the boxes, walks the column blocks in order, pre-tests each kept-vs-
column and diagonal pair on the boxes' BEV bounds (``nms_pretest``) and
spreads the IoUs of the surviving pairs over all its threads, resolves
the diagonal tile's recurrence on 128-bit suppressor masks, and stops
once ``post_k`` boxes are kept. It is bound by fp32 operations: about
:data:`FLOPS_PER_IOU` per IoU, for the IoUs this input needs.
"""

from __future__ import annotations

import torch

from .. import iou3d
from . import build
from .nms_pretest import MIN_THRESH, bounds, skippable_pairs

BLK = 128
# fp32 add/sub/mul/div/min/max of one IoU in csrc/nms_fused.cu, counted
# from its source (a division counts as one). Per green_pass: the 4 edge
# vectors of q, 8 ops, computed once (the unrolled loop hoists them);
# per edge of p, 4 clips x 10 (f0: 6, fd: 3, t_cross: 1) + 6 running
# min/max + dx, dy: 2 + clamps: 5 + clipped ends: 8 + shoelace: 4 = 65;
# 3 adds of the edge terms: 8 + 4 x 65 + 3 = 271. Per IoU: 2 passes +
# sum, area sum, union, clamp, quotient: 2 x 271 + 5 = 547.
FLOPS_PER_IOU = 547
# dynamic shared memory beside the kernel's static ~25 KB: per kept box
# its BEV bounds (5 floats) and its index
_SMEM_LIMIT = 227 * 1024 - 32 * 1024
KEPT_BYTES = 6 * 4


def _k_cap(post_k: int, p: int) -> int:
    """Kept-list capacity: post_k rounded up to a block, plus one spare
    block for the keeps of the block in which the post_k-th lands."""
    return min((post_k + BLK - 1) // BLK * BLK + BLK, p + BLK)


def nms_keep_batched_plain(boxes, valid_counts, thresh: float, post_k: int,
                           pretest: bool = False):
    """Plain PyTorch version, same arithmetic and the same truncation:
    column blocks in order; suppression from every kept earlier column,
    then the diagonal tile's recurrence column by column. With
    ``pretest`` the pairs that the kernel's BEV-bounds pre-test skips
    count as not overlapping, as they do in the kernel (their IoU is
    exactly 0, so the flags are the same)."""
    b, p = boxes.shape[0], boxes.shape[1]
    dev = boxes.device
    packed = iou3d.pack_bev(boxes[..., :7])  # (B, 9, P)
    counts = torch.clamp(valid_counts.to(dev).long(), max=p)
    keep = torch.zeros(b, p, dtype=torch.bool, device=dev)
    nk = torch.zeros(b, dtype=torch.long, device=dev)
    upper = torch.ones(BLK, BLK, dtype=torch.bool, device=dev).triu(1)
    box_b = bounds(packed) if pretest and thresh >= MIN_THRESH else None

    def over(r0, r1, c0, c1):
        out = iou3d.pairwise_iou_packed(packed[:, :, r0:r1],
                                        packed[:, :, c0:c1]) > thresh
        if box_b is not None:
            out &= ~skippable_pairs(tuple(v[:, r0:r1] for v in box_b),
                                    tuple(v[:, c0:c1] for v in box_b))
        return out

    for col0 in range(0, p, BLK):
        needed = (col0 < counts) & (nk < post_k)
        if not bool(needed.any()):
            break
        col_ids = col0 + torch.arange(BLK, device=dev)
        live = (col_ids[None] < counts[:, None]) & needed[:, None]
        if col0 > 0:
            live &= ~(over(0, col0, col0, col0 + BLK)
                      & keep[:, :col0, None]).any(dim=1)
        sub = over(col0, col0 + BLK, col0, col0 + BLK) & upper
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

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which builds the boxes' corners itself.
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
    if valid_counts.shape != (b,) or boxes.shape[2] < 7:
        raise ValueError(f"nms_keep_batched: boxes {tuple(boxes.shape)}, "
                         f"counts {tuple(valid_counts.shape)}")
    k_cap = _k_cap(post_k, p)
    if KEPT_BYTES * k_cap > _SMEM_LIMIT:
        raise ValueError(f"nms_keep_batched: post_k={post_k} needs more "
                         "shared memory than a block has")
    boxes = boxes.contiguous()
    counts = valid_counts.to(torch.int32).contiguous()
    keep = torch.empty((b, p), dtype=torch.bool, device=boxes.device)
    if keep.numel() == 0:
        return keep
    corners = torch.empty((b, iou3d.PACKED_ROWS, p), dtype=torch.float32,
                          device=boxes.device)
    build.check(build.lib().de6d_nms_keep_batched(
        boxes.data_ptr(), boxes.shape[2], corners.data_ptr(),
        counts.data_ptr(), keep.data_ptr(), b, p, float(thresh), post_k,
        k_cap, torch.cuda.current_stream(boxes.device).cuda_stream),
        "nms_keep_batched")
    nms_keep_batched.launches += 1
    return keep


nms_keep_batched.launches = 0


def pack_bev(boxes):
    """(B, P, 7+) fp32 CUDA boxes → (B, 9, P) corners and areas as the NMS
    kernel builds them (one launch of the same device function), for the
    check that they equal ``iou3d.pack_bev`` bit for bit."""
    b, p = boxes.shape[0], boxes.shape[1]
    if (boxes.device.type != "cuda" or boxes.dtype != torch.float32
            or boxes.shape[2] < 7):
        raise ValueError("nms_fused.pack_bev: needs (B, P, 7+) fp32 CUDA "
                         "boxes")
    boxes = boxes.contiguous()
    out = torch.empty((b, iou3d.PACKED_ROWS, p), dtype=torch.float32,
                      device=boxes.device)
    build.check(build.lib().de6d_nms_pack_bev(
        boxes.data_ptr(), boxes.shape[2], out.data_ptr(), b, p,
        torch.cuda.current_stream(boxes.device).cuda_stream),
        "nms_fused.pack_bev")
    return out
