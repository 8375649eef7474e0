"""Plain twin of the BEV-bounds pre-test that both NMS kernels run before
the IoU (``csrc/nms_pretest.cuh``, which holds the argument): a pair is
skipped only where its IoU is provably not above ``thresh``, that is
where the kernel's own IoU arithmetic gives an overlap of exactly 0.

The rule: edges >= MIN_EDGE and area >= MIN_EDGE**2 on both boxes,
thresh >= MIN_THRESH, and BEV bounds separated by more than GAP_ABS +
GAP_REL * (largest |coordinate| of the two boxes).
"""

from __future__ import annotations

import torch

MIN_EDGE = 1e-2
MIN_THRESH = 1e-3
GAP_ABS = 1e-3
GAP_REL = 1e-4
# fp32 operations of the pre-test per pair, counted from its source: 4
# differences and 3 maxima for the gap, the larger S, a product and a sum
# for delta, the compare
PRETEST_FLOPS = 11


def bounds(packed):
    """(B, 9, P) packed corners → per box x0, x1, y0, y1, S (largest
    |coordinate|) and ``ok`` (edges and area not degenerate), each (B, P),
    in the kernel's fp32 operations."""
    x = packed[:, 0:4].float()
    y = packed[:, 4:8].float()
    ex = x.roll(-1, dims=1) - x
    ey = y.roll(-1, dims=1) - y
    lim = torch.tensor(MIN_EDGE, dtype=torch.float32) ** 2
    ok = (packed[:, 8] >= lim) & (ex * ex + ey * ey >= lim).all(dim=1)
    s = torch.maximum(x.abs().amax(dim=1), y.abs().amax(dim=1))
    return x.amin(dim=1), x.amax(dim=1), y.amin(dim=1), y.amax(dim=1), s, ok


def skippable_pairs(rows, cols):
    """Pair grid of :func:`bounds` tuples (rows on dim 1, columns on
    dim 2) → bool where the pre-test proves the bit 0."""
    rx0, rx1, ry0, ry1, rs, rok = (v[:, :, None] for v in rows)
    cx0, cx1, cy0, cy1, cs, cok = (v[:, None, :] for v in cols)
    gap = torch.maximum(torch.maximum(cx0 - rx1, rx0 - cx1),
                        torch.maximum(cy0 - ry1, ry0 - cy1))
    delta = GAP_ABS + GAP_REL * torch.maximum(rs, cs)
    return rok & cok & (gap > delta)


def skippable_plain(packed, thresh: float):
    """Plain twin of the kernels' pre-test: (B, 9, P) packed corners →
    (B, P, P) bool, True where the pair's IoU is provably not above
    ``thresh`` (so a kernel skips its IoU). All False when ``thresh <
    MIN_THRESH``."""
    b, _, p = packed.shape
    if not thresh >= MIN_THRESH:
        return torch.zeros(b, p, p, dtype=torch.bool, device=packed.device)
    box_b = bounds(packed)
    return skippable_pairs(box_b, box_b)
