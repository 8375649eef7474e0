"""Axis-aligned anchor ↔ gt target assignment (counterpart of
``de6d_tpu/models/dense_heads/axis_aligned_assigner.py:assign_targets``,
the dense path the TPU runs).

One masked (A, M) computation per sample, with no per-class loop: the
IoU between an anchor and a gt of another class (or a padded, all-zero
gt) is forced to -1, so each anchor only sees its own class's gts and
each gt's best-anchor search only ranges over its class's anchors.
Labels: the matched gt's class for foreground (IoU >= the matched
threshold, or the anchor is a gt's best match), 0 below the unmatched
threshold, -1 in between; all 0 in a sample without a valid gt.
``argmax`` takes the first maximum, as ``jnp.argmax`` does, on the CPU
and on the card alike.
"""

from __future__ import annotations

import torch

from ...ops import iou3d


@torch.no_grad()
def assign_targets(anchors, anchor_group, matched_thr, unmatched_thr,
                   gt_boxes, box_coder):
    """anchors (A, 7), anchor_group (A,) int (class group per anchor),
    matched_thr / unmatched_thr (A,), gt_boxes (B, M, 7+1) with the class
    id last, zero rows as padding → ``box_cls_labels`` (B, A) int32,
    ``box_reg_targets`` (B, A, code_size), ``reg_weights`` (B, A)."""
    labels, targets, weights = [], [], []
    ndim = gt_boxes.shape[-1] - 1
    # 9-DoF gts against 7-DoF anchors: zero pitch / roll on the anchors
    anchors_full = torch.nn.functional.pad(
        anchors, (0, max(ndim - anchors.shape[-1], 0)))
    for gt in gt_boxes.float():
        gt_box = gt[:, :ndim]
        gt_cls = gt[:, -1].to(torch.int32)
        gt_valid = torch.any(torch.abs(gt[:, :7]) > 0, dim=-1)

        iou = iou3d.boxes3d_nearest_bev_iou(anchors[:, :7], gt_box[:, :7])
        class_ok = ((gt_cls[None, :] == anchor_group[:, None] + 1)
                    & gt_valid[None, :])
        iou_eff = torch.where(class_ok, iou, -1.0)

        anchor_max, anchor_arg = torch.max(iou_eff, dim=1)
        gt_max = torch.max(iou_eff, dim=0).values  # (M,)
        gt_max_eff = torch.where(gt_max > 0, gt_max, -2.0)
        forced = torch.any((iou_eff == gt_max_eff[None, :]) & (iou_eff > 0),
                           dim=1)

        fg = (anchor_max >= matched_thr) | forced
        label = torch.where(
            fg, gt_cls[anchor_arg],
            torch.where(anchor_max < unmatched_thr, 0, -1).to(torch.int32))
        label = torch.where(gt_valid.any(), label, 0)

        matched_gt = gt_box[anchor_arg]  # (A, ndim)
        target = box_coder.encode(matched_gt, anchors_full)[
            ..., :box_coder.code_size]
        labels.append(label.to(torch.int32))
        targets.append(torch.where(fg[:, None], target, 0.0))
        weights.append(fg.float())
    return {
        "box_cls_labels": torch.stack(labels),
        "box_reg_targets": torch.stack(targets),
        "reg_weights": torch.stack(weights),
    }
