"""Pairwise rotated-BEV-IoU suppression mask for greedy NMS, and the
greedy resolve that reads it.

Replaces the TPU kernel ``de6d_tpu/ops/pallas/nms_mask.py:
nms_suppression_mask``. The CUDA kernels are ``csrc/nms_mask.cu``. The
mask is a bit mask: ``(B, P, ceil(P / 64))`` int64 words, bit ``j % 64``
of word ``(i, j // 64)`` set where ``IoU_bev(i, j) > thresh`` for
``i < j < count[b]``, every other bit 0 (the TPU kernel writes an fp32
(P, P) array and leaves entries below the diagonal unspecified). It is
bound by fp32 operations: ``FLOPS_PER_IOU`` for each of the
``count * (count - 1) / 2`` pairs of a sample.

The resolve (``nms_resolve``) is plain XLA in the JAX package (fixpoint
sweeps); here it is the sequential greedy walk over the bit mask, which
gives the same selections: the first ``post`` kept candidates in score
order.
"""

from __future__ import annotations

import torch

from .. import iou3d
from . import build
from .nms_fused import FLOPS_PER_IOU  # noqa: F401  (same IoU, same count)

WORD = 64
# elements of one (B, rows, P) IoU tile of the plain version
PLAIN_TILE_ELEMS = 1 << 23
_MAX_GRID = 65535


def n_words(p: int) -> int:
    return (p + WORD - 1) // WORD


def _bit_weights(device):
    """int64 value of each bit of a word (bit 63 is the sign bit)."""
    return torch.tensor([1 << k for k in range(WORD - 1)] + [-(1 << 63)],
                        dtype=torch.int64, device=device)


def pack_bits(flags):
    """(..., P) bool → (..., ceil(P / 64)) int64 words, bit k of word w
    = flags[64 * w + k]."""
    p = flags.shape[-1]
    w = n_words(p)
    padded = torch.nn.functional.pad(flags, (0, w * WORD - p))
    bits = padded.reshape(*flags.shape[:-1], w, WORD).to(torch.int64)
    return (bits * _bit_weights(flags.device)).sum(dim=-1)


def unpack_bits(words, p: int):
    """Inverse of :func:`pack_bits`: (..., W) int64 → (..., p) bool."""
    shifts = torch.arange(WORD, device=words.device)
    bits = (words[..., None] >> shifts) & 1
    return bits.reshape(*words.shape[:-1], -1)[..., :p].bool()


def nms_suppression_mask_plain(packed, counts, thresh: float):
    """Plain PyTorch version: ``iou3d.pairwise_iou_packed`` in row chunks
    (row boxes first, as the kernel calls its IoU), restricted to
    ``i < j < count`` and packed into words."""
    b, _, p = packed.shape
    dev = packed.device
    counts = torch.clamp(counts.to(dev).long(), 0, p)
    idx = torch.arange(p, device=dev)
    chunk = max(1, min(p, PLAIN_TILE_ELEMS // max(1, b * p)))
    words = []
    for r0 in range(0, p, chunk):
        rows = packed[:, :, r0:r0 + chunk]
        # columns before r0 are below the diagonal for every row here
        over = iou3d.pairwise_iou_packed(rows, packed[:, :, r0:]) > thresh
        i = idx[r0:r0 + chunk, None]
        j = idx[None, r0:]
        region = (i < j)[None] & (j[None] < counts[:, None, None])
        flags = torch.nn.functional.pad(over & region, (r0, 0))
        words.append(pack_bits(flags))
    return torch.cat(words, dim=1)


def _check_inputs(what, packed, counts):
    if packed.device.type != "cuda" or counts.device != packed.device:
        raise ValueError(f"{what}: unsupported devices {packed.device}, "
                         f"{counts.device}")
    b = packed.shape[0]
    if counts.shape != (b,):
        raise ValueError(f"{what}: counts {tuple(counts.shape)} for batch {b}")
    if not 1 <= b <= _MAX_GRID:
        raise ValueError(f"{what}: batch {b}")


def nms_suppression_mask(packed, counts, thresh: float):
    """``iou3d.pack_bev`` corners (B, 9, P) fp32 of score-descending
    candidates + (B,) live counts → (B, P, ceil(P / 64)) int64 bit mask of
    the pairs ``i < j < count`` with ``IoU_bev(i, j) > thresh``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (one launch for the whole batch).
    """
    if packed.dim() != 3 or packed.shape[1] != iou3d.PACKED_ROWS:
        raise ValueError(f"nms_suppression_mask: packed {tuple(packed.shape)}")
    if packed.device.type == "cpu":
        return nms_suppression_mask_plain(packed, counts, thresh)
    _check_inputs("nms_suppression_mask", packed, counts)
    b, _, p = packed.shape
    if packed.dtype != torch.float32 or not packed.is_contiguous():
        raise ValueError("nms_suppression_mask: needs contiguous fp32 corners")
    if not 1 <= n_words(p) <= _MAX_GRID:
        raise ValueError(f"nms_suppression_mask: P={p}")
    counts = counts.to(torch.int32).contiguous()
    mask = torch.empty((b, p, n_words(p)), dtype=torch.int64,
                       device=packed.device)
    err = build.lib().de6d_nms_mask(
        packed.data_ptr(), counts.data_ptr(), mask.data_ptr(), b, p,
        float(thresh), torch.cuda.current_stream(packed.device).cuda_stream,
    )
    build.check(err, "nms_suppression_mask")
    nms_suppression_mask.launches += 1
    return mask


nms_suppression_mask.launches = 0


def nms_resolve_plain(mask, counts, post: int):
    """Plain PyTorch version of the greedy walk, batched: ``post`` steps,
    each taking every sample's first candidate that is live and not yet
    removed and ORing its mask row into the removed set."""
    b, p, _ = mask.shape
    dev = mask.device
    counts = torch.clamp(counts.to(dev).long(), 0, p)
    removed = torch.arange(p, device=dev)[None] >= counts[:, None]
    rows = torch.arange(b, device=dev)
    sel = torch.zeros(b, post, dtype=torch.int32, device=dev)
    nsel = torch.zeros(b, dtype=torch.int32, device=dev)
    for k in range(post):
        avail = ~removed
        has = avail.any(dim=1)
        if not bool(has.any()):
            break
        first = avail.to(torch.int32).argmax(dim=1)  # first available
        sel[:, k] = torch.where(has, first, 0).to(torch.int32)
        nsel += has.to(torch.int32)
        row = unpack_bits(mask[rows, first], p)
        removed |= row & has[:, None]
        removed[rows, first] = True
    return sel, nsel


def nms_resolve(mask, counts, post: int):
    """Bit mask of :func:`nms_suppression_mask` + (B,) live counts → the
    greedy NMS selections: ``sel`` (B, post) int32 candidate indices in
    score order (padded with 0) and ``nsel`` (B,) int32, exactly the
    first ``post`` keeps of ``keep[j] = j < count & not OR_{i<j} (keep[i]
    & mask[i, j])``.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if mask.dim() != 3 or mask.shape[2] != n_words(mask.shape[1]) \
            or mask.dtype != torch.int64:
        raise ValueError(f"nms_resolve: mask {tuple(mask.shape)} {mask.dtype}")
    if post < 1:
        raise ValueError(f"nms_resolve: post={post}")
    if mask.device.type == "cpu":
        return nms_resolve_plain(mask, counts, post)
    _check_inputs("nms_resolve", mask, counts)
    if not mask.is_contiguous():
        raise ValueError("nms_resolve: needs a contiguous mask")
    b, p, _ = mask.shape
    counts = counts.to(torch.int32).contiguous()
    sel = torch.empty((b, post), dtype=torch.int32, device=mask.device)
    nsel = torch.empty((b,), dtype=torch.int32, device=mask.device)
    err = build.lib().de6d_nms_resolve(
        mask.data_ptr(), counts.data_ptr(), sel.data_ptr(), nsel.data_ptr(),
        b, p, int(post), torch.cuda.current_stream(mask.device).cuda_stream,
    )
    build.check(err, "nms_resolve")
    nms_resolve.launches += 1
    return sel, nsel


nms_resolve.launches = 0
