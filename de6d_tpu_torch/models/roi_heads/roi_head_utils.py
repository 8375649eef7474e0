"""Shared RoI-stage functions, inference only (counterpart of
``de6d_tpu/models/roi_heads/roi_head_utils.py``: ``proposal_layer``,
``rcnn_box_decode``). Target assignment and the losses come with the
training slice."""

from __future__ import annotations

import torch

from ...ops import geometry
from ...ops import nms as nms_ops
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
