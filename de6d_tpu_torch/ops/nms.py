"""Rotated NMS over fixed-size candidate buffers (counterpart of
``de6d_tpu/ops/nms.py``: ``top_k_two_stage``, ``nms``, ``nms_candidates``,
``nms_candidates_batched``, ``class_agnostic_nms``).

Greedy semantics: candidates are score-descending, invalid ones (score
``NEG_INF``) form a suffix, and

    keep[j] = valid[j] & not OR_{i<j} (keep[i] & (IoU_bev(i, j) > thresh))

Outputs are ``(B, post)`` candidate indices padded with 0 plus counts.
"""

from __future__ import annotations

import torch

from . import iou3d
from .kernels.nms_fused import BLK, nms_keep_batched
from .kernels.nms_mask import nms_resolve, nms_suppression_mask

NEG_INF = -1e9
CASCADE_K0 = 1024


def stable_top_k(scores, k: int):
    """Top-k along the last axis with ``lax.top_k``'s tie order (equal
    values: lower index first), which ``torch.topk`` does not promise."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def top_k_two_stage(scores, pre: int, group: int):
    """Exact top-``pre`` of (B, A) ``scores`` with A = ncells * ``group``
    and cell-major anchor index (idx = cell*group + slot), equal to
    ``lax.top_k`` including tie order: stage 1 keeps the ``pre`` cells
    with the largest per-cell max (ties: lower cell first), stage 2 sorts
    those cells' anchors by (-score, index)."""
    b, a = scores.shape
    ncells = a // group
    if ncells * group != a:
        raise ValueError(f"A={a} is not a multiple of group={group}")
    kc = min(pre, ncells)
    cell_view = scores.reshape(b, ncells, group)
    _, cells = stable_top_k(cell_view.amax(dim=-1), kc)  # (B, kc)
    # ascending cell order makes the flat ids ascending, so a stable
    # descending sort on score is the (-score, id) two-key sort
    cells, _ = torch.sort(cells, dim=-1)
    rows = torch.gather(
        cell_view, 1, cells[..., None].expand(-1, -1, group)
    ).reshape(b, kc * group)
    ids = (cells[..., None] * group
           + torch.arange(group, device=scores.device)).reshape(b, -1)
    vals, pos = stable_top_k(rows, pre)
    return vals, torch.gather(ids, 1, pos)


def _compact(keep, post: int):
    """First ``post`` kept candidate indices per row, in score order
    (padded with 0), and their count."""
    pre = keep.shape[-1]
    idx = torch.arange(pre, device=keep.device)
    keep_rank = torch.where(keep, idx, pre)
    sel = torch.sort(keep_rank, dim=-1, stable=True)[1][..., :post]
    sel_valid = torch.gather(keep, -1, sel)
    count = sel_valid.sum(-1, dtype=torch.int32)
    sel = torch.where(sel_valid, sel, 0)
    return sel.to(torch.int32), count


def nms_candidates(cand, top_scores, thresh: float, post_maxsize: int = 500,
                   iou_kind: str = "rotated"):
    """Greedy NMS over already selected, score-descending candidates whose
    invalid slots (score ``NEG_INF``) form a suffix: (B, P, 7+) boxes and
    (B, P) scores, the batch in one mask launch and one resolve launch
    (``kernels/nms_mask.py``; the JAX package maps its per-sample form
    over the batch). Returns (B, post) int32 indices into the candidate
    axis, padded with 0, and the (B,) counts."""
    if iou_kind != "rotated":
        raise NotImplementedError("only rotated (nms_gpu) NMS is ported")
    pre = cand.shape[1]
    counts = (top_scores > NEG_INF / 2).sum(-1, dtype=torch.int32)
    packed = iou3d.pack_bev(cand[..., :7]).contiguous()
    mask = nms_suppression_mask(packed, counts, thresh)
    return nms_resolve(mask, counts, min(post_maxsize, pre))


def nms(boxes, scores, thresh: float, pre_maxsize: int = 4096,
        post_maxsize: int = 500, valid_mask=None, iou_kind: str = "rotated"):
    """Greedy NMS over fixed-size buffers, (B, N, 7+) boxes and (B, N)
    scores (the JAX package vmaps its per-sample form). Invalid boxes are
    gated to ``NEG_INF``, the top ``pre_maxsize`` taken with
    ``lax.top_k``'s tie order, then :func:`nms_candidates`. Returns
    (B, post) int32 indices into the input, padded with the top
    candidate's index, and the (B,) counts."""
    pre = min(pre_maxsize, boxes.shape[1])
    if valid_mask is not None:
        scores = torch.where(valid_mask, scores, NEG_INF)
    top_scores, order = stable_top_k(scores, pre)
    cand = torch.gather(
        boxes, 1, order[..., None].expand(-1, -1, boxes.shape[-1]))
    sel, count = nms_candidates(cand, top_scores, thresh, post_maxsize,
                                iou_kind)
    return torch.gather(order, 1, sel.long()).to(torch.int32), count


def nms_candidates_batched(cand, top_scores, thresh: float,
                           post_maxsize: int = 500,
                           iou_kind: str = "rotated"):
    """Batched greedy NMS over (B, P, 7+) score-descending candidates.

    For rotated IoU and P % 128 == 0 the whole batch resolves in the
    fused NMS kernel (``kernels/nms_fused.py``; its plain version on a
    CPU tensor); any other P goes through the suppression mask and its
    resolve (:func:`nms_candidates`). With P > 1024 an exact prefix
    cascade runs first: keep decisions for the score-descending prefix
    [0, 1024) depend on that prefix only, so when every sample keeps
    ``post`` boxes there (or has at most 1024 live candidates) the
    full-width pass is skipped. The branch is decided on the host: one
    device sync per batch.
    """
    pre = cand.shape[1]
    post = min(post_maxsize, pre)
    counts_pre = (top_scores > NEG_INF / 2).sum(-1, dtype=torch.int32)

    if iou_kind == "rotated" and pre % BLK == 0:
        boxes = cand[..., :7].contiguous()
        k0 = CASCADE_K0
        keep = None
        if pre > k0:
            keep0 = nms_keep_batched(
                boxes[:, :k0].contiguous(), torch.clamp(counts_pre, max=k0),
                thresh, post_k=post,
            )
            c0 = keep0.to(torch.int32).sum(-1)
            done = bool(((c0 >= post) | (counts_pre <= k0)).all())
            if done:
                keep = torch.nn.functional.pad(keep0, (0, pre - k0))
        if keep is None:
            keep = nms_keep_batched(boxes, counts_pre, thresh, post_k=post)
        return _compact(keep, post)

    return nms_candidates(cand, top_scores, thresh, post_maxsize, iou_kind)


def class_agnostic_nms(box_scores, box_preds, nms_config, score_thresh=None,
                       valid_mask=None):
    """:func:`nms` over one sample's (N,) scores and (N, 7+) boxes, gated
    by ``score_thresh``, with ``nms_config``'s ``NMS_THRESH``,
    ``NMS_PRE_MAXSIZE``, ``NMS_POST_MAXSIZE`` and ``NMS_TYPE``
    (``nms_normal_gpu``, the aligned IoU, raises as :func:`nms` does):
    the JAX ``class_agnostic_nms``. Returns (selected indices (post,)
    int32, padded with the top candidate's; their count; their scores,
    ``NEG_INF`` past the count)."""
    if valid_mask is None:
        valid_mask = torch.ones_like(box_scores, dtype=torch.bool)
    if score_thresh is not None:
        valid_mask = valid_mask & (box_scores >= score_thresh)
    idx, count = nms(
        box_preds[None], box_scores[None],
        thresh=float(nms_config["NMS_THRESH"]),
        pre_maxsize=int(nms_config["NMS_PRE_MAXSIZE"]),
        post_maxsize=int(nms_config["NMS_POST_MAXSIZE"]),
        valid_mask=valid_mask[None],
        iou_kind=("aligned" if "normal" in str(nms_config["NMS_TYPE"])
                  else "rotated"))
    idx, count = idx[0], count[0]
    in_range = torch.arange(idx.shape[0], device=idx.device) < count
    return idx, count, torch.where(in_range, box_scores[idx.long()],
                                   NEG_INF)
