"""Rotated NMS over fixed-size candidate buffers (counterpart of
``de6d_tpu/ops/nms.py``: ``top_k_two_stage``, ``nms_candidates``,
``nms_candidates_batched``).

Greedy semantics: candidates are score-descending, invalid ones (score
``NEG_INF``) form a suffix, and

    keep[j] = valid[j] & not OR_{i<j} (keep[i] & (IoU_bev(i, j) > thresh))

Outputs are ``(B, post)`` candidate indices padded with 0 plus counts.
"""

from __future__ import annotations

import torch

from . import iou3d
from .kernels.nms_fused import BLK, nms_keep_batched

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


def _greedy_resolve(mask, valid):
    """Jacobi fixpoint sweeps of the greedy recurrence (exact)."""
    keep = valid
    for _ in range(mask.shape[0]):
        new_keep = valid & ~(mask & keep[:, None]).any(dim=0)
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def _greedy_resolve_blocked(mask, valid, count: int, block: int = 64):
    """Exact greedy resolve in one pass over column blocks: suppression
    from already-resolved earlier candidates, then the intra-block
    recurrence by fixpoint sweeps on the (block, block) tile. Blocks past
    the ``count`` valid candidates keep their (False) ``valid`` flags."""
    k = mask.shape[0]
    keep = valid.clone()
    idx = torch.arange(k, device=mask.device)
    n_blocks = min(-(-count // block), k // block)
    for b in range(n_blocks):
        col0 = b * block
        mask_cols = mask[:, col0:col0 + block]
        prev = keep & (idx < col0)
        ext = (mask_cols & prev[:, None]).any(dim=0)
        local_valid = valid[col0:col0 + block] & ~ext
        sub = mask_cols[col0:col0 + block]
        keep[col0:col0 + block] = _greedy_resolve(sub, local_valid)
    return keep


def _pairwise_iou_chunked(cand, row_chunk: int = 256):
    """(K, 7+) → (K, K) rotated BEV IoU in row chunks to bound scratch."""
    packed = iou3d.pack_bev(cand[:, :7])
    return torch.cat([
        iou3d.pairwise_iou_packed(packed[:, r:r + row_chunk], packed)
        for r in range(0, cand.shape[0], row_chunk)
    ], dim=0)


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
    """Greedy NMS over one sample's (P, 7+) score-descending candidates
    (mask + blocked resolve). Returns (post,) indices and the count."""
    if iou_kind != "rotated":
        raise NotImplementedError("only rotated (nms_gpu) NMS is ported")
    pre = cand.shape[0]
    cand_valid = top_scores > NEG_INF / 2
    count_pre = int(cand_valid.sum())
    upper = torch.ones(pre, pre, dtype=torch.bool,
                       device=cand.device).triu(1)
    mask = (_pairwise_iou_chunked(cand) > thresh) & upper
    if pre % 64 == 0:
        keep = _greedy_resolve_blocked(mask, cand_valid, count_pre)
    else:
        keep = _greedy_resolve(mask, cand_valid)
    return _compact(keep, min(post_maxsize, pre))


def nms_candidates_batched(cand, top_scores, thresh: float,
                           post_maxsize: int = 500,
                           iou_kind: str = "rotated"):
    """Batched greedy NMS over (B, P, 7+) score-descending candidates.

    For rotated IoU and P % 128 == 0 the whole batch resolves in the
    fused NMS kernel (``kernels/nms_fused.py``; its plain version on a
    CPU tensor). With P > 1024 an exact prefix cascade runs first: keep
    decisions for the score-descending prefix [0, 1024) depend on that
    prefix only, so when every sample keeps ``post`` boxes there (or has
    at most 1024 live candidates) the full-width pass is skipped. The
    branch is decided on the host: one device sync per batch.
    """
    b, pre = cand.shape[0], cand.shape[1]
    post = min(post_maxsize, pre)
    cand_valid = top_scores > NEG_INF / 2
    counts_pre = cand_valid.sum(-1, dtype=torch.int32)

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

    sels, counts = zip(*(
        nms_candidates(cand[i], top_scores[i], thresh, post_maxsize,
                       iou_kind)
        for i in range(b)
    ))
    return torch.stack(sels), torch.stack(counts)
