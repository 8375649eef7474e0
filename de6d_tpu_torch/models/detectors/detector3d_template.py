"""Detector spine + shared post-processing (counterpart of
``de6d_tpu/models/detectors/detector3d_template.py``: ``DatasetSpec``,
the module slots, ``maybe_voxelize``, ``post_processing``).

The batch is a dict of fixed-shape tensors; validity is carried by
masks and counts. Models with a VFE voxelize on the device at the top
of the forward pass. ``post_processing`` returns fixed-size (B, post) buffers
plus counts.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ...ops import iou3d
from ...ops import nms as nms_ops
from ...ops import voxelize as voxelize_ops
from ...registry import (
    BACKBONES_2D, BACKBONES_3D, DENSE_HEADS, MAP_TO_BEV, PFE, POINT_HEADS,
    ROI_HEADS, VFE,
)
from ..dense_heads.anchor_head import decode_boxes_with_dir


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    """Static dataset facts the model needs (shapes, ranges)."""

    class_names: tuple
    point_feature_dim: int  # channels per point incl. xyz
    point_cloud_range: tuple  # (x0, y0, z0, x1, y1, z1)
    voxel_size: tuple = (0.16, 0.16, 4.0)
    max_voxels: int = 16000
    max_points_per_voxel: int = 32

    @property
    def grid_size(self):
        pc = self.point_cloud_range
        vs = self.voxel_size
        return (
            int(round((pc[3] - pc[0]) / vs[0])),
            int(round((pc[4] - pc[1]) / vs[1])),
            int(round((pc[5] - pc[2]) / vs[2])),
        )


class Detector3DTemplate(nn.Module):
    """VFE → BACKBONE_3D → MAP_TO_BEV → PFE → BACKBONE_2D → DENSE_HEAD →
    POINT_HEAD → ROI_HEAD, each present slot reading and writing the
    shared batch dict. With a ROI_HEAD the dense head decodes every
    anchor (``predict_boxes_when_training``, as the JAX template sets
    it); the point and RoI heads read the PFE's keypoint features where
    there is a PFE, else the 3D backbone's points."""

    TRAINABLE = False  # a detector whose training branch is ported

    def __init__(self, model_cfg, num_class, dataset):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.spec = dataset
        spec = dataset
        cfg = model_cfg
        self.module_names = []
        if "VFE" in cfg:
            self.vfe = VFE.get(cfg["VFE"]["NAME"])(
                model_cfg=cfg["VFE"],
                num_point_features=spec.point_feature_dim,
                voxel_size=spec.voxel_size,
                point_cloud_range=spec.point_cloud_range,
            )
            self.module_names.append("vfe")
        if "BACKBONE_3D" in cfg:
            # point backbones take the pc range for the fused SA path,
            # IA-SSD's the class count for its per-class confidences, the
            # voxel backbones the grid
            self.backbone_3d = BACKBONES_3D.get(cfg["BACKBONE_3D"]["NAME"])(
                model_cfg=cfg["BACKBONE_3D"],
                input_channels=(self.vfe.output_feature_dim if "VFE" in cfg
                                else spec.point_feature_dim),
                point_cloud_range=tuple(spec.point_cloud_range),
                num_class=num_class,
                grid_size=spec.grid_size,
            )
            self.module_names.append("backbone_3d")
        if "MAP_TO_BEV" in cfg:
            self.map_to_bev = MAP_TO_BEV.get(cfg["MAP_TO_BEV"]["NAME"])(
                model_cfg=cfg["MAP_TO_BEV"], grid_size=spec.grid_size
            )
            self.module_names.append("map_to_bev")
        if "PFE" in cfg:
            self.pfe = PFE.get(cfg["PFE"]["NAME"])(
                model_cfg=cfg["PFE"],
                voxel_size=spec.voxel_size,
                point_cloud_range=spec.point_cloud_range,
                num_bev_features=(self.map_to_bev.num_bev_features
                                  if "MAP_TO_BEV" in cfg else 0),
                num_rawpoint_features=spec.point_feature_dim - 3,
                multi_scale_channels=getattr(
                    self.backbone_3d, "multi_scale_channels", None),
            )
            self.module_names.append("pfe")
        if "BACKBONE_2D" in cfg:
            self.backbone_2d = BACKBONES_2D.get(cfg["BACKBONE_2D"]["NAME"])(
                model_cfg=cfg["BACKBONE_2D"],
                input_channels=(self.map_to_bev.num_bev_features
                                if "MAP_TO_BEV" in cfg else 0),
            )
            self.module_names.append("backbone_2d")
        if "DENSE_HEAD" in cfg:
            head_cfg = cfg["DENSE_HEAD"]
            self.dense_head = DENSE_HEADS.get(head_cfg["NAME"])(
                model_cfg=head_cfg,
                input_channels=self.backbone_2d.num_bev_features,
                num_class=1 if head_cfg.get("CLASS_AGNOSTIC", False)
                else num_class,
                class_names=tuple(spec.class_names),
                grid_size=spec.grid_size,
                point_cloud_range=tuple(spec.point_cloud_range),
                predict_boxes_when_training="ROI_HEAD" in cfg,
            )
            self.module_names.append("dense_head")
        if "PFE" in cfg:  # the keypoints' widths before and after fusion
            point_in = self.pfe.num_point_features_before_fusion
            point_out = self.pfe.num_point_features
        elif "POINT_HEAD" in cfg or "ROI_HEAD" in cfg:
            # a voxel backbone has no point features: its RoI head reads
            # the stages (multi_scale_channels)
            point_in = point_out = getattr(self.backbone_3d,
                                           "num_point_features", 0)
        if "POINT_HEAD" in cfg:
            head_cfg = cfg["POINT_HEAD"]
            self.point_head = POINT_HEADS.get(head_cfg["NAME"])(
                model_cfg=head_cfg,
                input_channels=point_in,
                num_class=1 if head_cfg.get("CLASS_AGNOSTIC", False)
                else num_class,
                predict_boxes_when_training="ROI_HEAD" in cfg,
            )
            self.module_names.append("point_head")
        if "ROI_HEAD" in cfg:
            head_cfg = cfg["ROI_HEAD"]
            self.roi_head = ROI_HEADS.get(head_cfg["NAME"])(
                model_cfg=head_cfg,
                input_channels=point_out,
                num_class=1 if head_cfg.get("CLASS_AGNOSTIC", False)
                else num_class,
                voxel_size=spec.voxel_size,
                point_cloud_range=spec.point_cloud_range,
                multi_scale_channels=getattr(
                    self.backbone_3d, "multi_scale_channels", None),
            )
            self.module_names.append("roi_head")

    def maybe_voxelize(self, batch_dict):
        """Device voxelization of padded (B, N, C) points, for models with
        a VFE."""
        if "VFE" not in self.model_cfg:
            return batch_dict
        spec = self.spec
        points = batch_dict["points"]
        mask = batch_dict.get("points_mask")
        if mask is None:
            mask = torch.any(points[..., :3] != 0, dim=-1)
        out = voxelize_ops.voxelize(
            points, mask, spec.point_cloud_range, spec.voxel_size,
            spec.max_voxels, spec.max_points_per_voxel,
        )
        batch_dict.update(out)
        batch_dict["_points_per_voxel_cap"] = spec.max_points_per_voxel
        return batch_dict

    def forward(self, batch_dict):
        """Eval mode: inference, without autograd. Train mode
        (``model.train()``): autograd on, ``gt_boxes`` (B, M, 8): 7-DoF
        box and class, or (B, M, 10): 9-DoF box and class, read by the head
        that writes its predictions and targets for
        :meth:`get_training_loss` (the detectors with ``TRAINABLE``:
        PointPillars, Det6D, 3DSSD, IA-SSD, PointRCNN, SECOND, PV-RCNN,
        Voxel-RCNN)."""
        if self.training and not self.TRAINABLE:
            raise NotImplementedError(
                f"{type(self).__name__}: training is not ported yet (the "
                "port trains IA-SSD, PointPillars, Det6D, 3DSSD, PointRCNN, "
                "SECOND, PV-RCNN and Voxel-RCNN)")
        with torch.set_grad_enabled(self.training):
            batch_dict = self.maybe_voxelize(dict(batch_dict))
            for name in self.module_names:
                batch_dict = getattr(self, name)(batch_dict)
        return batch_dict

    def get_training_loss(self, batch_dict):
        """(loss, dict of scalar terms) from a train-mode forward's output;
        ported for the detectors with ``TRAINABLE``."""
        raise NotImplementedError(
            f"{type(self).__name__}: training is not ported yet (the port "
            "trains IA-SSD, PointPillars, Det6D, 3DSSD, PointRCNN, SECOND, "
            "PV-RCNN and Voxel-RCNN)")


def rank_candidates(batch_dict, post_cfg):
    """Score gate + exact top-``NMS_PRE_MAXSIZE``: (masked (B, A) best
    class score, ``NEG_INF`` below ``SCORE_THRESH``; labels (B, A),
    1-based; top_scores (B, P); order (B, P), the candidates' rows)."""
    cls_preds = batch_dict["batch_cls_preds"]  # (B, A, nc)
    if not batch_dict.get("cls_preds_normalized", False):
        cls_preds = torch.sigmoid(cls_preds)
    nms_cfg = post_cfg["NMS_CONFIG"]
    score_thresh = float(post_cfg.get("SCORE_THRESH", 0.1))
    scores = cls_preds.amax(dim=-1)  # (B, A)
    labels = cls_preds.argmax(dim=-1) + 1  # first max on ties
    masked = torch.where(scores >= score_thresh, scores, nms_ops.NEG_INF)
    pre = min(int(nms_cfg["NMS_PRE_MAXSIZE"]), scores.shape[1])
    lazy = batch_dict.get("lazy_box_decode")
    a_loc = int(lazy["a_loc"]) if lazy is not None else 0
    if a_loc and masked.shape[1] >= 4 * pre * a_loc:
        top_scores, order = nms_ops.top_k_two_stage(masked, pre, a_loc)
    else:
        top_scores, order = nms_ops.stable_top_k(masked, pre)
    return masked, labels, top_scores, order


def select_candidates(batch_dict, post_cfg):
    """:func:`rank_candidates` + the candidates' boxes. Returns
    (cand_boxes (B, P, 7+), top_scores (B, P), cand_labels (B, P)); gated
    slots score ``NEG_INF``. Anchor heads decode only the gathered
    candidates (``lazy_box_decode``); point heads hand over decoded
    ``batch_box_preds`` (9 columns for Det6D)."""
    _, labels, top_scores, order = rank_candidates(batch_dict, post_cfg)
    lazy = batch_dict.get("lazy_box_decode")
    a_loc = int(lazy["a_loc"]) if lazy is not None else 0
    cand_labels = torch.gather(labels, 1, order)
    if lazy is None:
        box_preds = batch_dict["batch_box_preds"]  # (B, A, 7+)
        cand_boxes = torch.gather(
            box_preds, 1, order[..., None].expand(-1, -1, box_preds.shape[-1])
        )
        return cand_boxes, top_scores, cand_labels
    # decode only the gathered candidates: the cell row, then the
    # candidate's anchor slot within it
    cell = torch.div(order, a_loc, rounding_mode="floor")
    sub = order - cell * a_loc

    def cell_select(arr_cell, width):
        rows = torch.gather(
            arr_cell, 1, cell[..., None].expand(-1, -1, arr_cell.shape[-1])
        ).reshape(order.shape[0], order.shape[1], a_loc, width)
        return torch.gather(
            rows, 2, sub[..., None, None].expand(-1, -1, 1, width)
        )[:, :, 0]

    code = int(lazy["code_size"])
    raw_rows = cell_select(lazy["raw_cell"], code)
    dir_rows = None
    if lazy["dir_cell"] is not None:
        nb = lazy["dir_cell"].shape[-1] // a_loc
        dir_rows = cell_select(lazy["dir_cell"], nb)
    anchors_cell = lazy["anchors_cell"]
    anch_rows = cell_select(
        anchors_cell[None].expand(order.shape[0], -1, -1),
        anchors_cell.shape[-1] // a_loc,
    )
    cand_boxes = decode_boxes_with_dir(
        lazy["coder"], lazy["dir_cfg"], raw_rows, dir_rows, anch_rows
    )
    return cand_boxes, top_scores, cand_labels


def post_processing(batch_dict, post_cfg, num_class: int):
    """Class-agnostic rotated NMS per sample with fixed-size outputs:
    (B, post) ``pred_boxes`` (…, 7+), ``pred_scores``, ``pred_labels``
    (1-based) and ``pred_count`` (B,)."""
    nms_cfg = post_cfg["NMS_CONFIG"]
    iou_kind = (
        "aligned" if "normal" in str(nms_cfg.get("NMS_TYPE", "nms_gpu"))
        else "rotated"
    )
    cand_boxes, top_scores, cand_labels = select_candidates(
        batch_dict, post_cfg
    )
    sel, counts = nms_ops.nms_candidates_batched(
        cand_boxes, top_scores,
        thresh=float(nms_cfg["NMS_THRESH"]),
        post_maxsize=int(nms_cfg["NMS_POST_MAXSIZE"]),
        iou_kind=iou_kind,
    )
    sel = sel.long()
    post = sel.shape[1]
    in_count = torch.arange(post, device=sel.device)[None] < counts[:, None]
    sel_boxes = torch.gather(
        cand_boxes, 1, sel[..., None].expand(-1, -1, cand_boxes.shape[-1])
    )
    sel_scores = torch.gather(top_scores, 1, sel)
    sel_labels = torch.gather(cand_labels, 1, sel)
    return {
        "pred_boxes": torch.where(in_count[..., None], sel_boxes, 0.0),
        "pred_scores": torch.where(in_count, sel_scores, 0.0),
        "pred_labels": torch.where(in_count, sel_labels, 0).to(torch.int32),
        "pred_count": counts,
    }


def generate_recall_record(batch_dict, pred_boxes, pred_counts,
                           thresh_list=(0.3, 0.5, 0.7)):
    """Recall counters against ``batch_dict["gt_boxes"]`` (B, M, 7+1+): per
    IoU threshold t, the ground-truth boxes (any of the first 7 columns
    non-zero) whose best 3D IoU with the first ``pred_counts[b]`` boxes
    exceeds t. Returns ``{"gt": n, "recalled_<t>": n, ...}`` as 0-d int64
    tensors summed over the batch."""
    gt = batch_dict["gt_boxes"][..., :7].float()
    boxes = pred_boxes[..., :7].float()
    gt_valid = torch.any(torch.abs(gt) > 0, dim=-1)  # (B, M)
    box_valid = (torch.arange(boxes.shape[1], device=boxes.device)[None]
                 < pred_counts[:, None])  # (B, P)
    iou = iou3d.boxes_iou3d(gt, boxes)  # (B, M, P)
    iou = torch.where(gt_valid[..., None] & box_valid[:, None], iou, 0.0)
    best = iou.amax(dim=-1)
    out = {"gt": gt_valid.sum()}
    for t in thresh_list:
        out[f"recalled_{t}"] = ((best > t) & gt_valid).sum()
    return out
