"""Loss functions of the anchor and vote heads (counterpart of
``de6d_tpu/utils/loss_utils.py``: ``sigmoid_bce_with_logits``,
``sigmoid_focal_loss``, ``smooth_l1_loss``, ``softmax_cross_entropy``,
``weighted_binary_cross_entropy``, ``get_corner_loss_lidar``).

Every function returns per-element losses; the caller weights and sums
them, so the normalisation is the JAX package's.
"""

from __future__ import annotations

import math

import torch

from ..ops import geometry


def sigmoid_bce_with_logits(logits, targets):
    """Numerically stable sigmoid binary cross-entropy."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))


def sigmoid_focal_loss(logits, targets, weights=None, alpha=0.25, gamma=2.0):
    """Per-element focal loss; ``weights`` with one dimension fewer than
    the logits broadcast over the class axis."""
    p = torch.sigmoid(logits)
    alpha_w = targets * alpha + (1.0 - targets) * (1.0 - alpha)
    pt = targets * (1.0 - p) + (1.0 - targets) * p
    focal_w = alpha_w * torch.pow(pt, gamma)
    loss = focal_w * sigmoid_bce_with_logits(logits, targets)
    if weights is not None:
        if weights.ndim == loss.ndim - 1:
            weights = weights[..., None]
        loss = loss * weights
    return loss


def smooth_l1_loss(pred, target, weights=None, beta: float = 1.0 / 9.0,
                   code_weights=None):
    """Per-code smooth-L1; NaN targets are replaced by the predictions
    (zero loss)."""
    target = torch.where(torch.isnan(target), pred, target)
    diff = pred - target
    if code_weights is not None:
        diff = diff * torch.as_tensor(code_weights, dtype=diff.dtype,
                                      device=diff.device)
    n = torch.abs(diff)
    if beta < 1e-5:
        loss = n
    else:
        loss = torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
    if weights is not None:
        loss = loss * weights[..., None]
    return loss


def softmax_cross_entropy(logits, one_hot_targets, weights=None):
    """Cross-entropy over the last axis with per-anchor weights."""
    loss = -torch.sum(one_hot_targets * torch.log_softmax(logits, dim=-1),
                      dim=-1)
    if weights is not None:
        loss = loss * weights
    return loss


def weighted_binary_cross_entropy(logits, targets, weights=None):
    """Sigmoid BCE averaged over the class axis, times ``weights``."""
    loss = sigmoid_bce_with_logits(logits, targets).mean(dim=-1)
    if weights is not None:
        loss = loss * weights
    return loss


def _scaled_norm(v):
    """Euclidean norm over the last axis of ``v`` scaled by the power of two
    of its largest entry, so the squares cannot overflow: the same bits as
    ``torch.linalg.norm`` (and its gradient) wherever no square overflows,
    and the finite norm up to fp32's largest number where they do."""
    _, e = torch.frexp(v.detach().abs().amax(dim=-1, keepdim=True))
    # within +-100 the scale and its inverse are normal fp32 numbers
    scale = torch.ldexp(torch.ones_like(v[..., :1]), -e.clamp(-100, 100))
    return torch.linalg.norm(v * scale, dim=-1) / scale[..., 0]


def get_corner_loss_lidar(pred_boxes, gt_boxes):
    """(N, 7) × (N, 7) → (N,): Huber (delta 1) of each corner's distance
    to the gt box's or to the gt box turned by pi, whichever is nearer,
    averaged over the 8 corners.

    The JAX package's loss wherever its value is finite. Where its squared
    distances overflow (a box decoded from a size code above ~43, as an
    RoI head's codes reach in its first steps) it is inf and its gradient
    NaN; here the distance is the scaled norm's, and the quadratic branch
    sees 0 where it is not taken, so neither branch's gradient is 0 * inf."""
    pred = geometry.boxes_to_corners_3d(pred_boxes)
    gt = geometry.boxes_to_corners_3d(gt_boxes)
    flipped = torch.cat([gt_boxes[:, :6], gt_boxes[:, 6:7] + math.pi,
                         gt_boxes[:, 7:]], dim=-1)
    gt_flip = geometry.boxes_to_corners_3d(flipped)
    dist = torch.minimum(_scaled_norm(pred - gt), _scaled_norm(pred - gt_flip))
    near = dist < 1.0
    q = torch.where(near, dist, 0.0)
    return torch.where(near, 0.5 * q * q, dist - 0.5).mean(dim=1)
