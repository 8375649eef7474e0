"""Vote-based point heads (counterpart of
``de6d_tpu/models/dense_heads/point_head_vote.py``: the target
functions, ``_PointHeadVoteBase``, ``PointHeadBoxVote``,
``PointHeadBox6DVote`` and ``point_vote_head_loss``).

Candidates (``SAMPLE_RANGE`` of the backbone's points) → vote FC (fp32,
offsets clamped to ``MAX_TRANSLATION_RANGE``) → SA re-aggregation at the
vote centers over all backbone points (no pc_range, so never the folded
path) → shared FC → cls / reg → decode with the head's box coder.

In train mode the head also writes its targets (:meth:`build_targets`):
vote targets by containment in the enlarged gt boxes at the candidates,
box targets by containment plus a ball around the box centre at the
(detached) votes, or by the predicted boxes' IoU, and the SASA per-layer
labels. Containment is 9-DoF where the gt boxes have 9 columns.
``point_vote_head_loss`` sums the vote, classification (with
centerness), box (offsets, yaw bins, the ground-aware pitch of the 6-DoF
coder, IoU and corner regularisers) and SASA terms. The centerness
target is computed with the true yaw (column 6), as the JAX package
does, and it is not detached from the votes: the JAX loss
differentiates through it too.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import geometry, iou3d
from ...registry import POINT_HEADS
from ...utils import box_coder_utils, loss_utils
from ..backbones_3d.pointnet2_modules import PointnetSAModuleFSMSG
from ..model_utils.dtype_utils import compute_dtype
from ..model_utils.mlp import FCStack, SharedMLP


# ---------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------

def _gt_parts(gt_boxes):
    """(B, M, 7 | 9 + class) → (boxes, class ids (B, M) int64, valid (B, M),
    the boxes containment reads: 9 columns where there are 9, else 7)."""
    boxes = gt_boxes[..., :-1]
    cls_ids = gt_boxes[..., -1].long()
    valid = torch.any(boxes[..., :7].abs() > 0, dim=-1)
    use = boxes[..., :9] if boxes.shape[-1] >= 9 else boxes[..., :7]
    return boxes, cls_ids, valid, use


def _take(boxes, idx):
    """boxes (B, M, C) gathered at idx (B, N) (clamped at 0) → (B, N, C)."""
    idx = idx.clamp(min=0).long()
    return torch.gather(boxes, 1, idx[..., None].expand(-1, -1,
                                                        boxes.shape[-1]))


def assign_targets_simple(points, valid, gt_boxes, extra_width=None):
    """Vote targets: a candidate inside an (enlarged) gt box is fg, its
    label the box centre. Returns (cls (B, N) int32 {-1 invalid, 0, 1},
    reg (B, N, 3))."""
    boxes, _, gt_valid, use = _gt_parts(gt_boxes)
    if extra_width is not None:
        use = geometry.enlarge_box3d(use, extra_width)
    idx = geometry.points_in_boxes_index(points, use, gt_valid)
    fg = (idx >= 0) & valid
    cls = torch.where(valid, fg.to(torch.int32), -1)
    reg = torch.where(fg[..., None], _take(boxes, idx)[..., 0:3], 0.0)
    return cls, reg


def _box_targets(points, boxes, cls_ids, idx, fg, ignore, valid, box_coder,
                 num_class):
    cls_at = torch.gather(cls_ids, 1, idx.clamp(min=0).long())
    cls = torch.where(
        fg, cls_at if num_class > 1 else torch.ones_like(cls_at),
        torch.where(ignore | ~valid, -1, 0)).to(torch.int32)
    box_at = _take(boxes, idx)
    enc = box_coder.encode(box_at, points, cls_at)[..., :box_coder.code_size]
    return (cls, torch.where(fg[..., None], enc, 0.0),
            torch.where(fg[..., None], box_at, 0.0))


def assign_targets_mask(points, valid, gt_boxes, box_coder, num_class,
                        central_radius=2.0):
    """Box targets at the votes: inside a gt box and within
    ``central_radius`` of its centre is fg; inside but farther is
    ignored (-1). Returns (cls (B, N) int32, reg (B, N, code), box
    labels (B, N, 7 | 9))."""
    boxes, cls_ids, gt_valid, use = _gt_parts(gt_boxes)
    idx = geometry.points_in_boxes_index(points, use, gt_valid)
    box_fg = (idx >= 0) & valid
    centres = _take(boxes, idx)[..., 0:3]
    ball = torch.linalg.norm(centres - points, dim=-1) < central_radius
    return _box_targets(points, boxes, cls_ids, idx, box_fg & ball,
                        box_fg & ~ball, valid, box_coder, num_class)


def assign_targets_iou(points, valid, pred_boxes, gt_boxes, box_coder,
                       num_class, pos_iou_threshold=0.5,
                       neg_iou_threshold=0.35):
    """Box targets by the predicted boxes' best 3D IoU with a gt box:
    above ``pos_iou_threshold`` fg, above ``neg_iou_threshold`` ignored."""
    boxes, cls_ids, gt_valid, _ = _gt_parts(gt_boxes)
    iou = iou3d.boxes_iou3d(pred_boxes[..., :7], boxes[..., :7])
    iou = torch.where(gt_valid[:, None, :], iou, -1.0)
    best, arg = iou.max(dim=-1)
    fg = (best > pos_iou_threshold) & valid
    ignore = ((best > neg_iou_threshold) & ~fg & valid) | ~valid
    return _box_targets(points, boxes, cls_ids, arg, fg, ignore, valid,
                        box_coder, num_class)


def assign_sasa_labels(coords_list, valid_list, gt_boxes, extra_width=None,
                       set_ignore_flag=False):
    """Per-SA-layer labels from 7-DoF containment: 1 inside a
    (enlarged) gt box, else 0, -1 at invalid points; with
    ``set_ignore_flag``, fg is the plain box and the margin is -1."""
    boxes = gt_boxes[..., :7]
    gt_valid = torch.any(boxes.abs() > 0, dim=-1)
    big = (geometry.enlarge_box3d(boxes, extra_width)
           if extra_width is not None else boxes)
    out = []
    for pts, v in zip(coords_list, valid_list):
        inside_big = geometry.points_in_boxes_index(pts, big, gt_valid) >= 0
        if not set_ignore_flag:
            label = inside_big.to(torch.int32)
        else:
            fg = geometry.points_in_boxes_index(pts, boxes, gt_valid) >= 0
            label = torch.where(fg ^ inside_big, -1, fg.to(torch.int32))
        out.append(torch.where(v, label, -1))
    return out


def generate_centerness_label(points, box_labels, pos_mask, epsilon=1e-6):
    """FCOS-style centerness of points (N, 3) in their box's frame (true
    yaw, column 6); 0 off ``pos_mask``."""
    canonical = points - box_labels[..., 0:3]
    canonical = geometry.rotate_points_along_z(
        canonical[:, None, :], -box_labels[..., 6])[:, 0]
    half = box_labels[..., 3:6] / 2.0

    def ratio(a, b):
        return torch.minimum(a, b) / torch.clamp(torch.maximum(a, b),
                                                 min=epsilon)

    c = (ratio(half[..., 0] - canonical[..., 0],
               half[..., 0] + canonical[..., 0])
         * ratio(half[..., 1] - canonical[..., 1],
                 half[..., 1] + canonical[..., 1])
         * ratio(half[..., 2] - canonical[..., 2],
                 half[..., 2] + canonical[..., 2]))
    c = torch.clamp(c, min=epsilon) ** (1.0 / 3.0)
    return torch.where(pos_mask, c, 0.0)


def axis_aligned_iou_loss(pred_boxes, gt_boxes):
    """1 − axis-aligned 3D IoU of matched pairs."""
    return 1.0 - iou3d.boxes_aligned_iou3d(pred_boxes, gt_boxes)


# ---------------------------------------------------------------------
# head
# ---------------------------------------------------------------------

class _PointHeadVoteBase(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class,
                 predict_boxes_when_training=False, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.predict_boxes_when_training = predict_boxes_when_training
        target_cfg = model_cfg["TARGET_CONFIG"]
        self.box_coder = box_coder_utils.build_box_coder(
            target_cfg["BOX_CODER"],
            **dict(target_cfg.get("BOX_CODER_CONFIG", {})),
        )
        use_bn = model_cfg.get("USE_BN", True)
        dt = compute_dtype(model_cfg)
        vote_cfg = model_cfg["VOTE_CONFIG"]
        # votes are geometry: fp32 whatever the compute dtype
        self.vote_layers = FCStack(input_channels, vote_cfg["VOTE_FC"], 3,
                                   use_bn=use_bn)
        self.register_buffer(
            "max_translation",
            torch.tensor([float(v) for v in
                          vote_cfg["MAX_TRANSLATION_RANGE"]]),
            persistent=False,
        )
        sa_cfg = model_cfg["SA_CONFIG"]
        self.sa_module = PointnetSAModuleFSMSG(
            in_channels=input_channels, radii=sa_cfg["RADIUS"],
            nsamples=sa_cfg["NSAMPLE"], mlps=sa_cfg["MLPS"], use_xyz=True,
            use_bn=use_bn, dtype=dt,
        )
        self.shared_fc = SharedMLP(self.sa_module.out_channels,
                                   model_cfg["SHARED_FC"], use_bn=use_bn,
                                   dtype=dt)
        self.cls_layers = FCStack(self.shared_fc.out_channels,
                                  model_cfg["CLS_FC"], num_class,
                                  use_bn=use_bn, dtype=dt)
        self.reg_layers = FCStack(self.shared_fc.out_channels,
                                  model_cfg["REG_FC"],
                                  self.box_coder.code_size, use_bn=use_bn,
                                  dtype=dt)

    def forward(self, batch_dict):
        coords = batch_dict["point_coords"]  # (B, N, 3)
        features = batch_dict["point_features"]  # (B, N, C) fp32
        valid = batch_dict.get("point_valid")
        if valid is None:
            valid = torch.ones(coords.shape[:2], dtype=torch.bool,
                               device=coords.device)
        lo, hi = self.model_cfg["SAMPLE_RANGE"]
        hi = coords.shape[1] if hi == -1 else int(hi)
        cand_coords = coords[:, lo:hi]
        cand_valid = valid[:, lo:hi]

        offsets = self.vote_layers(features[:, lo:hi])  # (B, Nc, 3) fp32
        rng = self.max_translation.to(offsets.dtype)
        offsets = torch.clamp(offsets, -rng, rng)
        vote_coords = cand_coords + offsets
        batch_dict["point_candidate_coords"] = cand_coords
        batch_dict["point_vote_coords"] = vote_coords
        batch_dict["point_vote_valid"] = cand_valid

        _, vote_features, _, _, _ = self.sa_module(
            coords, features, valid, new_xyz=vote_coords,
            new_valid=cand_valid,
        )
        shared = self.shared_fc(vote_features)
        cls_preds = self.cls_layers(shared)  # (B, Nc, ncls) fp32
        reg_preds = self.reg_layers(shared)  # (B, Nc, code) fp32
        point_box_preds = self.box_coder.decode(
            reg_preds, vote_coords, torch.argmax(cls_preds, dim=-1) + 1
        )
        batch_dict["point_cls_preds"] = cls_preds
        batch_dict["point_reg_preds"] = reg_preds
        batch_dict["point_box_preds"] = point_box_preds
        batch_dict["point_cls_scores"] = torch.sigmoid(cls_preds)
        if self.training:
            batch_dict.update(self.build_targets(batch_dict))
        if not self.training or self.predict_boxes_when_training:
            batch_dict["batch_cls_preds"] = cls_preds
            batch_dict["batch_box_preds"] = point_box_preds
            batch_dict["cls_preds_normalized"] = False
        return batch_dict

    def build_targets(self, batch_dict):
        """The targets of a train-mode forward, from detached inputs."""
        target_cfg = self.model_cfg["TARGET_CONFIG"]
        gt_boxes = batch_dict["gt_boxes"].detach()
        votes = batch_dict["point_vote_coords"].detach()
        vvalid = batch_dict["point_vote_valid"]
        vote_cls, vote_reg = assign_targets_simple(
            batch_dict["point_candidate_coords"].detach(), vvalid, gt_boxes,
            extra_width=target_cfg.get("VOTE_EXTRA_WIDTH", None))
        method = target_cfg.get("ASSIGN_METHOD", "mask")
        if method == "mask":
            cls_l, reg_l, box_l = assign_targets_mask(
                votes, vvalid, gt_boxes, self.box_coder, self.num_class,
                central_radius=float(target_cfg.get("GT_CENTRAL_RADIUS",
                                                    2.0)))
        elif method == "iou":
            cls_l, reg_l, box_l = assign_targets_iou(
                votes, vvalid, batch_dict["point_box_preds"].detach(),
                gt_boxes, self.box_coder, self.num_class,
                pos_iou_threshold=float(target_cfg["POS_IOU_THRESHOLD"]),
                neg_iou_threshold=float(target_cfg["NEG_IOU_THRESHOLD"]))
        else:
            raise NotImplementedError(f"ASSIGN_METHOD {method!r}")
        ret = {"vote_cls_labels": vote_cls, "vote_reg_labels": vote_reg,
               "point_cls_labels": cls_l, "point_reg_labels": reg_l,
               "point_box_labels": box_l}
        sasa_cfg = self.model_cfg["LOSS_CONFIG"].get("LOSS_SASA_CONFIG")
        if sasa_cfg is not None:
            ret["point_sasa_labels"] = assign_sasa_labels(
                [c.detach() for c in batch_dict["point_coords_list"]],
                batch_dict["point_valid_list"], gt_boxes,
                extra_width=sasa_cfg.get("extra_width", None),
                set_ignore_flag=sasa_cfg.get("set_ignore_flag", False))
            ret["point_sasa_preds"] = batch_dict["point_scores_list"]
        return ret


@POINT_HEADS.register
class PointHeadBoxVote(_PointHeadVoteBase):
    """7-DoF vote head (3DSSD / SASA): the box layout comes from
    ``PointBinResidualCoder``."""


@POINT_HEADS.register
class PointHeadBox6DVote(_PointHeadVoteBase):
    """Full-pose Det6D head: the 6-DoF behaviour comes from
    ``PointBinResidual6DCoder``."""


# ---------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------

def point_vote_head_loss(batch_dict, model_cfg, num_class, box_coder):
    """(total loss, dict of its terms) of a train-mode forward."""
    loss_cfg = model_cfg["LOSS_CONFIG"]
    w = loss_cfg["LOSS_WEIGHTS"]
    tb = {}

    # vote regression
    vote_cls = batch_dict["vote_cls_labels"].reshape(-1)
    pos = (vote_cls > 0).float()
    vote_loss = loss_utils.smooth_l1_loss(
        batch_dict["point_vote_coords"].reshape(-1, 3),
        batch_dict["vote_reg_labels"].reshape(-1, 3),
        weights=pos / torch.clamp(pos.sum(), min=1.0),
    ).sum() * float(w["vote_reg_weight"])
    tb["vote_loss_reg"] = vote_loss

    # classification
    cls_labels = batch_dict["point_cls_labels"].reshape(-1)
    cls_preds = batch_dict["point_cls_preds"].reshape(-1, num_class)
    positives = cls_labels > 0
    cls_weights = (positives | (cls_labels == 0)).float()
    one_hot = torch.nn.functional.one_hot(
        cls_labels.clamp(min=0).long(), num_class + 1)[..., 1:].float()
    box_labels = batch_dict["point_box_labels"]
    box_labels = box_labels.reshape(-1, box_labels.shape[-1])
    if "WithCenterness" in str(loss_cfg["LOSS_CLS"]):
        centerness = generate_centerness_label(
            batch_dict["point_vote_coords"].reshape(-1, 3), box_labels,
            positives)
        cls_cfg = loss_cfg.get("LOSS_CLS_CONFIG", {}) or {}
        cmin = float(cls_cfg.get("centerness_min", 0.0))
        cmax = float(cls_cfg.get("centerness_max", 1.0))
        one_hot = one_hot * (cmin + (cmax - cmin) * centerness)[:, None]
    if str(loss_cfg["LOSS_CLS"]).startswith("WeightedBinaryCrossEntropy"):
        cls_vec = loss_utils.weighted_binary_cross_entropy(
            cls_preds, one_hot, weights=cls_weights)
    else:
        cls_vec = loss_utils.sigmoid_focal_loss(
            cls_preds, one_hot, weights=cls_weights).sum(-1)
    cls_loss = (cls_vec.sum() / torch.clamp(cls_weights.sum(), min=1.0)
                * float(w["point_cls_weight"]))
    tb["point_loss_cls"] = cls_loss
    tb["point_pos_num"] = positives.sum()

    # box regression
    code = box_coder.code_size
    reg_preds = batch_dict["point_reg_preds"].reshape(-1, code)
    reg_labels = batch_dict["point_reg_labels"].reshape(-1, code)
    reg_w = positives.float()
    box_norm = torch.clamp(reg_w.sum(), min=1.0)
    box_vec = loss_utils.smooth_l1_loss(
        reg_preds[:, :6], reg_labels[:, :6], weights=reg_w,
    ).sum(-1) * float(w["point_offset_reg_weight"])
    nb = getattr(box_coder, "angle_bin_num", 0)
    if nb:
        bins = slice(6, 6 + nb)
        res = slice(6 + nb, 6 + 2 * nb)
        bin_l = reg_labels[:, bins]
        angle_cls = loss_utils.softmax_cross_entropy(
            reg_preds[:, bins], bin_l) * reg_w * float(
                w["point_angle_cls_weight"])
        angle_reg = loss_utils.smooth_l1_loss(
            (reg_preds[:, res] * bin_l).sum(-1, keepdim=True),
            (reg_labels[:, res] * bin_l).sum(-1, keepdim=True),
            weights=reg_w,
        ).sum(-1) * float(w["point_angle_reg_weight"])
        box_vec = box_vec + angle_cls + angle_reg
        if isinstance(box_coder, box_coder_utils.PointBinResidual6DCoder):
            base = 6 + 2 * nb
            if box_coder.ground_aware:
                pitch_cls_l = reg_labels[:, base:base + 1]
                box_vec = box_vec + loss_utils.sigmoid_focal_loss(
                    reg_preds[:, base:base + 1], pitch_cls_l,
                    weights=reg_w,
                ).squeeze(-1) * float(w["point_pitch_cls_weight"])
                pitch_w = (pitch_cls_l[:, 0] > 0).float()
                pitch = slice(base + 1, base + 2)
            else:
                pitch_w = reg_w
                pitch = slice(base, base + 1)
            pitch_reg = loss_utils.smooth_l1_loss(
                reg_preds[:, pitch], reg_labels[:, pitch], weights=pitch_w,
            ).sum(-1)
            # normalised by the pitch-fg count, not the fg count
            box_vec = box_vec + pitch_reg * box_norm / torch.clamp(
                pitch_w.sum(), min=1.0) * float(w["point_pitch_reg_weight"])
    else:
        box_vec = box_vec + loss_utils.smooth_l1_loss(
            reg_preds[:, 6:], reg_labels[:, 6:], weights=reg_w,
        ).sum(-1) * float(w["point_angle_reg_weight"])

    # regularisers on the decoded boxes
    box_preds = batch_dict["point_box_preds"]
    box_preds = box_preds.reshape(-1, box_preds.shape[-1])
    if loss_cfg.get("AXIS_ALIGNED_IOU_LOSS_REGULARIZATION", False):
        iou_l = axis_aligned_iou_loss(box_preds[:, :7], box_labels[:, :7])
        box_vec = box_vec + torch.where(
            positives, iou_l * float(w["point_iou_weight"]), 0.0)
    if loss_cfg.get("CORNER_LOSS_REGULARIZATION", False):
        corner_l = loss_utils.get_corner_loss_lidar(box_preds[:, :7],
                                                    box_labels[:, :7])
        box_vec = box_vec + torch.where(
            positives, corner_l * float(w["point_corner_weight"]), 0.0)
    box_loss = box_vec.sum() / box_norm
    tb["point_loss_box"] = box_loss
    total = vote_loss + cls_loss + box_loss

    # SASA: per-layer segmentation of the backbone's sampled points
    sasa_cfg = loss_cfg.get("LOSS_SASA_CONFIG")
    if sasa_cfg is not None and "point_sasa_labels" in batch_dict:
        layer_weights = sasa_cfg.get("layer_weights")
        sasa_total = 0.0
        for i, (preds, labels) in enumerate(zip(
                batch_dict["point_sasa_preds"],
                batch_dict["point_sasa_labels"])):
            lw = float(layer_weights[i]) if layer_weights else 1.0
            if preds is None or lw <= 0:
                continue
            labels = labels.reshape(-1)
            weights = (labels >= 0).float()
            tgt = labels.clamp(0, 1).float()[:, None]
            p = preds.reshape(-1)[:, None]
            if str(sasa_cfg.get("func", "BCE")) == "Focal":
                lvec = loss_utils.sigmoid_focal_loss(p, tgt,
                                                     weights=weights).sum(-1)
            else:
                lvec = loss_utils.weighted_binary_cross_entropy(
                    p, tgt, weights=weights)
            layer = lw * lvec.sum() / torch.clamp(weights.sum(), min=1.0)
            sasa_total = sasa_total + layer
            tb[f"point_loss_sasa_layer_{i}"] = layer
        tb["point_loss_sasa"] = sasa_total
        total = total + sasa_total
    tb["point_loss"] = total
    return total, tb
