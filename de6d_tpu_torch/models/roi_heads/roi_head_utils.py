"""Shared RoI-stage functions (counterpart of
``de6d_tpu/models/roi_heads/roi_head_utils.py``: ``proposal_layer``,
``assign_roi_targets``, ``canonical_transform_targets``,
``rcnn_box_decode``, ``roi_head_loss``; ``sample_rois`` is the train
branch the RoI heads share).

Training samples ``ROI_PER_IMAGE`` of each sample's proposals as the JAX
package does: class-aware max-IoU matching to the gt boxes, then the
foreground (IoU at least ``REG_FG_THRESH``) ranked by IoU plus uniform
noise and the background by noise alone, each by a top-k that breaks
ties by the lower index (``lax.top_k``'s order). The noise is JAX's own
draws from ``PRNGKey(0)`` (``utils/jax_random.py``), the key the JAX
train step uses on every step, so both packages pick the same RoIs.
Buffers keep their fixed sizes; validity travels in masks.
"""

from __future__ import annotations

import torch

from ...ops import geometry, iou3d
from ...ops import nms as nms_ops
from ...utils import jax_random, loss_utils
from ...utils.box_coder_utils import ResidualCoder


@torch.no_grad()
def proposal_layer(batch_dict, nms_cfg, num_rois: int):
    """First-stage boxes → fixed (B, num_rois) proposals by rotated NMS
    over the top ``NMS_PRE_MAXSIZE`` scores of each sample (no score
    gate), the whole batch in one pass. Writes ``rois`` (B, R, 7+),
    ``roi_scores``, ``roi_labels`` (1-based, int32) and ``roi_valid``;
    slots past a sample's count are zero. ``roi_point_idx`` (the point
    each RoI came from; the JAX package keeps it internal) is written
    for the parity checks."""
    cls_preds = batch_dict["batch_cls_preds"]  # (B, N, ncls)
    boxes = batch_dict["batch_box_preds"]  # (B, N, 7+)
    if not batch_dict.get("cls_preds_normalized", False):
        cls_preds = torch.sigmoid(cls_preds)
    scores = cls_preds.amax(dim=-1)
    labels = cls_preds.argmax(dim=-1) + 1  # first max on ties
    idx, count = nms_ops.nms(
        boxes, scores,
        thresh=float(nms_cfg["NMS_THRESH"]),
        pre_maxsize=int(nms_cfg["NMS_PRE_MAXSIZE"]),
        post_maxsize=num_rois,
    )
    idx = idx.long()
    in_cnt = torch.arange(num_rois, device=idx.device)[None] < count[:, None]
    rois = torch.gather(boxes, 1,
                        idx[..., None].expand(-1, -1, boxes.shape[-1]))
    batch_dict["rois"] = torch.where(in_cnt[..., None], rois, 0.0)
    batch_dict["roi_scores"] = torch.where(
        in_cnt, torch.gather(scores, 1, idx), 0.0)
    batch_dict["roi_labels"] = torch.where(
        in_cnt, torch.gather(labels, 1, idx), 0).to(torch.int32)
    batch_dict["roi_valid"] = in_cnt
    batch_dict["roi_point_idx"] = idx
    return batch_dict


def rcnn_box_decode(rois, rcnn_reg, code_size: int = 7):
    """RoI-local residuals (B, R, code) → world boxes (B, R, 7): decode
    against a centered anchor of the RoI's size, rotate the center by the
    RoI's yaw, then add the RoI's center and yaw."""
    coder = ResidualCoder(code_size=code_size)
    b, r = rois.shape[:2]
    local_anchor = torch.zeros_like(rois[..., :7])
    local_anchor[..., 3:6] = rois[..., 3:6]
    boxes_local = coder.decode(rcnn_reg.reshape(b * r, -1),
                               local_anchor.reshape(b * r, 7))
    yaw = rois[..., 6].reshape(-1)
    xyz = geometry.rotate_points_along_z(
        boxes_local[:, None, 0:3], yaw)[:, 0] + rois[..., 0:3].reshape(-1, 3)
    boxes = torch.cat([xyz, boxes_local[:, 3:6],
                       (boxes_local[:, 6] + yaw)[:, None],
                       boxes_local[:, 7:]], dim=-1)
    return boxes.reshape(b, r, -1)


@torch.no_grad()
def assign_roi_targets(rois, roi_valid, roi_labels, gt_boxes, key=None,
                       roi_per_image: int = 128, fg_ratio: float = 0.5,
                       fg_thresh: float = 0.55):
    """Sample ``roi_per_image`` of the (B, R) proposals a sample: the
    first ``int(roi_per_image * fg_ratio)`` slots the foreground, the
    rest the background. ``gt_boxes`` (B, M, 7 + class); ``key`` the
    jax_random key (default ``PRNGKey(0)``), split into one key a sample
    and each of those into the foreground's and the background's draws.
    A slot without a RoI of its kind holds a low-index RoI, invalid
    (JAX's top-k over the -1e9 keys; it may repeat a RoI of the other
    kind). Returns (B, roi_per_image, ...) ``rois``, ``gt_of_rois`` (the
    matched gt box), ``rcnn_cls_labels`` (the IoU mapped linearly from
    [0.25, 0.75] to [0, 1]), ``reg_valid_mask`` (IoU above
    ``fg_thresh``), ``roi_labels``, ``roi_sample_valid`` and
    ``roi_sample_idx`` (the proposal each slot holds)."""
    b, r = rois.shape[:2]
    key = jax_random.prng_key(0, rois.device) if key is None else key
    boxes = gt_boxes[..., :-1]
    gt_cls = gt_boxes[..., -1].to(torch.int32)
    gt_valid = torch.any(boxes[..., :7].abs() > 0, dim=-1)
    iou = iou3d.boxes_iou3d(rois[..., :7], boxes[..., :7])  # (B, R, M)
    same_cls = roi_labels[..., None] == gt_cls[:, None, :]
    iou = torch.where(same_cls & gt_valid[:, None, :], iou, -1.0)
    max_iou = torch.where(roi_valid, iou.amax(dim=-1), -1.0)
    gt_arg = iou.argmax(dim=-1)  # the first of equal IoUs, as jnp.argmax

    fg = max_iou >= fg_thresh
    bg = (max_iou < fg_thresh) & roi_valid
    n_fg = int(roi_per_image * fg_ratio)
    draws = jax_random.split(jax_random.split(key, b), 2)  # (B, 2, 2)
    fg_key = torch.where(fg, max_iou + jax_random.uniform(draws[:, 0], r),
                         -1e9)
    bg_key = torch.where(bg, jax_random.uniform(draws[:, 1], r), -1e9)
    _, fg_idx = nms_ops.stable_top_k(fg_key, n_fg)
    _, bg_idx = nms_ops.stable_top_k(bg_key, roi_per_image - n_fg)
    sel = torch.cat([fg_idx, bg_idx], dim=-1)
    sel_valid = torch.cat([torch.gather(fg, 1, fg_idx),
                           torch.gather(bg, 1, bg_idx)], dim=-1)

    def take(x, idx):
        if x.dim() == idx.dim():
            return torch.gather(x, 1, idx)
        return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))

    s_iou = torch.where(sel_valid, take(max_iou, sel), 0.0)
    cls_t = torch.clamp((s_iou - 0.25) / (0.75 - 0.25), 0.0, 1.0)
    return {
        "rois": take(rois, sel),
        "gt_of_rois": take(boxes, take(gt_arg, sel)),
        "rcnn_cls_labels": cls_t,
        "reg_valid_mask": (s_iou > fg_thresh) & sel_valid,
        "roi_labels": take(roi_labels, sel),
        "roi_sample_valid": sel_valid,
        "roi_sample_idx": sel,
    }


def sample_rois(batch_dict, **sampler):
    """A train step's RoI sampling after the proposal layer:
    :func:`assign_roi_targets` (``sampler``: its keyword arguments) over
    the batch's proposals; the sampled RoIs, their labels and validity
    replace the proposals' in ``batch_dict``. Returns the targets, with
    ``gt_of_rois_local`` (:func:`canonical_transform_targets`)."""
    targets = assign_roi_targets(
        batch_dict["rois"], batch_dict["roi_valid"], batch_dict["roi_labels"],
        batch_dict["gt_boxes"], **sampler)
    batch_dict["rois"] = targets["rois"]
    batch_dict["roi_labels"] = targets["roi_labels"]
    batch_dict["roi_valid"] = targets["roi_sample_valid"]
    targets["gt_of_rois_local"] = canonical_transform_targets(
        targets["rois"][..., :7], targets["gt_of_rois"][..., :7])
    return targets


def canonical_transform_targets(rois, gt_of_rois):
    """(B, R, 7) gt boxes in each RoI's frame: centre moved to the RoI's
    and turned by minus its yaw, yaw less the RoI's."""
    b, r = rois.shape[:2]
    roi_ry = rois[..., 6]
    xyz = geometry.rotate_points_along_z(
        (gt_of_rois[..., 0:3] - rois[..., 0:3]).reshape(b * r, 1, 3),
        -roi_ry.reshape(-1)).reshape(b, r, 3)
    return torch.cat([xyz, gt_of_rois[..., 3:6],
                      (gt_of_rois[..., 6] - roi_ry)[..., None],
                      gt_of_rois[..., 7:]], dim=-1)


# the largest size code a regressed RoI is decoded with for the corner
# loss: a box exp(60) times its RoI's size has a finite corner loss and
# finite gradients (``tests/test_torch_roi_code_cap.py``)
CORNER_SIZE_CODE_CAP = 60.0


def roi_head_loss(ret_dict, loss_cfg):
    """The RoI head's loss from its ``roi_targets_dict``: sigmoid BCE on
    ``rcnn_cls`` against the IoU-interpolated labels over the valid
    samples, smooth-L1 on the ``ResidualCoder`` residuals of the
    RoI-local gt boxes over the regression samples, and with
    ``CORNER_LOSS_REGULARIZATION`` the corner loss of the decoded boxes
    (size codes capped at :data:`CORNER_SIZE_CODE_CAP`) against the world
    gt boxes. Returns (total, dict of scalar terms:
    ``rcnn_loss_cls``, ``rcnn_loss_reg``, ``rcnn_loss_corner``,
    ``rcnn_loss``)."""
    w = loss_cfg["LOSS_WEIGHTS"]
    rcnn_cls = ret_dict["rcnn_cls"].reshape(-1)
    cls_labels = ret_dict["rcnn_cls_labels"].reshape(-1)
    cls_valid = ret_dict["roi_sample_valid"].reshape(-1).float()
    bce = loss_utils.sigmoid_bce_with_logits(rcnn_cls, cls_labels)
    cls_loss = ((bce * cls_valid).sum() / torch.clamp(cls_valid.sum(),
                                                      min=1.0)
                * float(w["rcnn_cls_weight"]))

    reg_valid = ret_dict["reg_valid_mask"].reshape(-1).float()
    rois = ret_dict["rois"].reshape(-1, ret_dict["rois"].shape[-1])
    gt_local = ret_dict["gt_of_rois_local"].reshape(
        -1, ret_dict["gt_of_rois_local"].shape[-1])
    local_anchor = torch.cat([torch.zeros_like(rois[:, :3]), rois[:, 3:6],
                              torch.zeros_like(rois[:, 6:7])], dim=-1)
    reg_targets = ResidualCoder().encode(gt_local[:, :7], local_anchor)
    rcnn_reg = ret_dict["rcnn_reg"].reshape(-1, reg_targets.shape[-1])
    norm = torch.clamp(reg_valid.sum(), min=1.0)
    reg_loss = (loss_utils.smooth_l1_loss(
        rcnn_reg, reg_targets, weights=reg_valid,
        code_weights=w.get("code_weights")).sum() / norm
        * float(w["rcnn_reg_weight"]))
    total = cls_loss + reg_loss
    tb = {"rcnn_loss_cls": cls_loss, "rcnn_loss_reg": reg_loss}
    if loss_cfg.get("CORNER_LOSS_REGULARIZATION", False):
        # the RoIs that are not regressed decode zero codes and their
        # corner loss is selected away: the JAX loss multiplies it by 0,
        # which is 0 unless their own codes overflow the decode's exp
        # (0 * inf = NaN); the same loss and gradients wherever JAX's are
        # finite
        regressed = ret_dict["reg_valid_mask"][..., None]
        codes = torch.where(regressed, ret_dict["rcnn_reg"], 0.0)
        # a regressed RoI's size codes are capped for this term: past ~86
        # the decode's exp overflows (loss inf, gradients NaN), where
        # JAX's loss is already inf from ~43 (it squares the distances);
        # up to the cap, the same loss and gradients
        codes = torch.cat([codes[..., :3],
                           codes[..., 3:6].clamp(max=CORNER_SIZE_CODE_CAP),
                           codes[..., 6:]], dim=-1)
        decoded = rcnn_box_decode(ret_dict["rois"], codes).reshape(-1, 7)
        gt_world = ret_dict["gt_of_rois"].reshape(
            -1, ret_dict["gt_of_rois"].shape[-1])
        corner = loss_utils.get_corner_loss_lidar(decoded, gt_world[:, :7])
        corner_loss = (torch.where(reg_valid > 0, corner, 0.0).sum() / norm
                       * float(w["rcnn_corner_weight"]))
        total = total + corner_loss
        tb["rcnn_loss_corner"] = corner_loss
    tb["rcnn_loss"] = total
    return total, tb
