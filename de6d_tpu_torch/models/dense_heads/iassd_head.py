"""IA-SSD head (counterpart of
``de6d_tpu/models/dense_heads/iassd_head.py``: ``_centerness``,
``assign_iassd_targets``, ``IASSD_Head`` with ``assign_targets``,
``iassd_head_loss``).

FC stacks over the vote centres' features (fp32): class logits, the
bin-orientation box code and, with ``IOU_FC``, an IoU branch; boxes are
decoded at the centres with the head's box coder in both modes.

Train mode also writes the targets: the centres' labels inside the
tight 7-DoF gt boxes with the ``GT_EXTRA_WIDTH`` ring ignored and their
box codes; with ``ASSIGN_METHOD`` the vote origins' labels under the
extended assignment (a point inside its tight box keeps it, else the
enlarged box's owner); with ``INS_AWARE_ASSIGN`` each confidence layer's
instance labels (the first such layer tight with an ignore ring of 0.5
m, the deeper ones extended by 0.5 m).

The loss (:func:`iassd_head_loss`) keeps the JAX package's arithmetic,
its quirks included: the box loss reads the bin label and residual from
columns 6 and 7 of the encoded one-hot layout, and the residual term is
a mean over every centre times the positives' weight sum. The centres
carry the vote layer's gradient, and the JAX package lets it reach the
loss through every function of them: the decoded boxes, the centerness
scaling and the centres' box codes (the targets' labels and owners carry
none).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import geometry, iou3d
from ...registry import POINT_HEADS
from ...utils import box_coder_utils, loss_utils
from ..model_utils.mlp import FCStack


def _centerness(points, boxes, eps=1e-6):
    """(N, 3) points in their (N, 7+) owner boxes → (N,) centerness: the
    cube root of the product over the box axes of min / max of the
    distances to the two faces."""
    offset = points - boxes[:, 0:3]
    c, s = torch.cos(-boxes[:, 6]), torch.sin(-boxes[:, 6])
    x = offset[:, 0] * c - offset[:, 1] * s
    y = offset[:, 0] * s + offset[:, 1] * c
    local = torch.stack([x, y, offset[:, 2]], dim=-1)
    half = boxes[:, 3:6] / 2
    d_pos, d_neg = half - local, half + local
    ratio = (torch.minimum(d_pos, d_neg)
             / torch.clamp(torch.maximum(d_pos, d_neg), min=eps))
    cness = torch.clamp(ratio[:, 0] * ratio[:, 1] * ratio[:, 2], min=eps)
    return cness ** (1.0 / 3.0)


def assign_iassd_targets(points, valid, gt_boxes, box_coder=None,
                         extra_width=None, num_class=1,
                         use_ex_gt_assign=False, set_ignore_flag=True,
                         ret_box_labels=False):
    """(B, N, 3) points vs (B, M, 7 + class) gt boxes (7-DoF containment)
    → dict of ``cls_labels`` (B, N) int32, ``box_idx`` (B, N) (-1 off the
    foreground), ``gt_box_of_points`` (B, N, 8) (0 off the foreground)
    and, with ``ret_box_labels``, ``box_labels`` (B, N, code).

    ``use_ex_gt_assign``: a point inside its tight box keeps that box,
    else the enlarged box's owner, and nothing is ignored;
    ``set_ignore_flag``: the tight boxes' points are the foreground and
    the ring of the enlarged ones is -1; neither: the tight boxes' points,
    nothing ignored. Invalid points are background (0).

    The labels and owners carry no gradient; the box labels encode the
    owning box at the points, so where the points carry one (the vote
    centres) it flows into the codes, as jax.grad takes it through the
    JAX function."""
    with torch.no_grad():
        out, own, cls_at, fg = _assign_iassd(
            points.detach(), valid, gt_boxes.detach(), extra_width,
            num_class, use_ex_gt_assign, set_ignore_flag)
    if ret_box_labels and box_coder is not None:
        enc = box_coder.encode(own[..., :7], points, cls_at)
        out["box_labels"] = torch.where(fg[..., None], enc, 0.0)
    return out


def _assign_iassd(points, valid, gt_boxes, extra_width, num_class,
                  use_ex_gt_assign, set_ignore_flag):
    boxes = gt_boxes[..., :-1]
    cls_ids = gt_boxes[..., -1].long()
    gt_valid = torch.any(boxes[..., :7].abs() > 0, dim=-1)
    idx_t = geometry.points_in_boxes_index(points, boxes[..., :7], gt_valid)
    if extra_width is not None:
        big = geometry.enlarge_box3d(boxes[..., :7], extra_width)
        idx_e = geometry.points_in_boxes_index(points, big, gt_valid)
    else:
        idx_e = idx_t
    if use_ex_gt_assign:
        idx = torch.where(idx_t >= 0, idx_t, idx_e)
        fg = (idx >= 0) & valid
        ignore = torch.zeros_like(fg)
    else:
        idx = idx_t
        fg = (idx >= 0) & valid
        ignore = ((fg ^ ((idx_e >= 0) & valid)) & valid if set_ignore_flag
                  else torch.zeros_like(fg))
    safe = idx.clamp(min=0).long()
    cls_at = torch.gather(cls_ids, 1, safe)
    label = torch.where(fg, 1 if num_class == 1 else cls_at,
                        torch.where(ignore, -1, 0)).to(torch.int32)
    own = torch.gather(gt_boxes, 1, safe[..., None].expand(
        -1, -1, gt_boxes.shape[-1]))
    out = {"cls_labels": label, "box_idx": torch.where(fg, idx, -1),
           "gt_box_of_points": torch.where(fg[..., None], own, 0.0)}
    return out, own, cls_at, fg


@POINT_HEADS.register
class IASSD_Head(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class,
                 predict_boxes_when_training=False, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        self.predict_boxes_when_training = predict_boxes_when_training
        tcfg = model_cfg["TARGET_CONFIG"]
        self.box_coder = box_coder_utils.build_box_coder(
            tcfg["BOX_CODER"], **dict(tcfg.get("BOX_CODER_CONFIG", {})))
        use_bn = model_cfg.get("USE_BN", True)
        self.cls_center_layers = FCStack(input_channels, model_cfg["CLS_FC"],
                                         num_class, use_bn=use_bn)
        self.box_center_layers = FCStack(input_channels, model_cfg["REG_FC"],
                                         self.box_coder.code_size,
                                         use_bn=use_bn)
        self.box_iou3d_layers = None
        if model_cfg.get("IOU_FC") is not None:
            self.box_iou3d_layers = FCStack(input_channels,
                                            model_cfg["IOU_FC"], 1,
                                            use_bn=use_bn)

    def forward(self, batch_dict):
        feats = batch_dict["centers_features"]  # (B, Nc, C) fp32
        centers = batch_dict["centers"]  # (B, Nc, 3)
        cls_preds = self.cls_center_layers(feats)
        box_preds = self.box_center_layers(feats)
        batch_dict["center_cls_preds"] = cls_preds
        batch_dict["center_box_preds"] = box_preds
        batch_dict["box_iou3d_preds"] = (
            self.box_iou3d_layers(feats)
            if self.box_iou3d_layers is not None else None)
        batch_dict["point_cls_scores"] = torch.sigmoid(cls_preds).amax(dim=-1)
        if self.training:
            batch_dict.update(self.assign_targets(batch_dict))
        point_box_preds = self.box_coder.decode(
            box_preds, centers, torch.argmax(cls_preds, dim=-1) + 1)
        batch_dict["point_box_preds"] = point_box_preds
        if not self.training or self.predict_boxes_when_training:
            batch_dict["batch_cls_preds"] = cls_preds
            batch_dict["batch_box_preds"] = point_box_preds
            batch_dict["cls_preds_normalized"] = False
        return batch_dict

    def assign_targets(self, batch_dict):
        """The centres', the vote origins' and the confidence layers'
        targets (see the module's docstring); 9-DoF gt boxes give their
        7-DoF part and class. Only the centres' box codes carry a
        gradient (into the centres)."""
        tcfg = self.model_cfg["TARGET_CONFIG"]
        gt = batch_dict["gt_boxes"].detach()
        if gt.shape[-1] == 10:
            gt = torch.cat([gt[..., 0:7], gt[..., -1:]], dim=-1)
        centers = batch_dict["centers"]
        valid = batch_dict.get("centers_valid")
        if valid is None:
            valid = torch.ones(centers.shape[:2], dtype=torch.bool,
                               device=centers.device)
        ctr = assign_iassd_targets(
            centers, valid, gt, box_coder=self.box_coder,
            extra_width=tcfg.get("GT_EXTRA_WIDTH"), num_class=self.num_class,
            set_ignore_flag=True, ret_box_labels=True)
        ret = {"center_cls_labels": ctr["cls_labels"],
               "center_box_labels": ctr["box_labels"],
               "center_gt_box_of_points": ctr["gt_box_of_points"]}
        extra = tcfg.get("ASSIGN_METHOD", {})
        if extra:
            co = batch_dict["centers_origin"].detach()
            ex = assign_iassd_targets(
                co, torch.ones(co.shape[:2], dtype=torch.bool,
                               device=co.device), gt,
                extra_width=extra.get("EXTRA_WIDTH", [1.0, 1.0, 1.0]),
                num_class=self.num_class, use_ex_gt_assign=True)
            ret["center_origin_cls_labels"] = ex["cls_labels"]
            ret["center_origin_box_idxs_of_pts"] = ex["box_idx"]
            ret["gt_box_of_center_origin"] = ex["gt_box_of_points"]
        if tcfg.get("INS_AWARE_ASSIGN", False):
            labels, owners = [], []
            for coords, v, preds in zip(batch_dict["encoder_coords"],
                                        batch_dict["encoder_valid"],
                                        batch_dict["sa_ins_preds"]):
                if preds is None:
                    labels.append(None)
                    owners.append(None)
                    continue
                # the first confidence layer tight with an ignore ring,
                # the deeper ones extended
                deep = any(x is not None for x in labels)
                sa = assign_iassd_targets(
                    coords.detach(), v, gt, extra_width=[0.5, 0.5, 0.5],
                    num_class=self.num_class, use_ex_gt_assign=deep,
                    set_ignore_flag=not deep)
                labels.append(sa["cls_labels"])
                owners.append(sa["gt_box_of_points"])
            ret["sa_ins_labels"] = labels
            ret["sa_gt_box_of_points"] = owners
        return ret


def _class_targets(labels, num_class, cness=None):
    """One-hot class targets (labels 1-based, <= 0 none), scaled by the
    positives' centerness where given."""
    one_hot = torch.nn.functional.one_hot(
        labels.clamp(min=0).long(), num_class + 1)[..., 1:].float()
    if cness is not None:
        one_hot = one_hot * torch.where(labels > 0, cness, 0.0)[..., None]
    return one_hot


def _pos_neg_weights(labels):
    pos = labels > 0
    return (pos | (labels == 0)).float() / torch.clamp(pos.float().sum(),
                                                        min=1.0)


def iassd_head_loss(batch_dict, model_cfg, num_class):
    """The IA-SSD loss: vote, centre classification (centerness-scaled
    targets), the confidence layers' instance-aware terms, the
    bin-orientation box term, and the corner and IoU terms where the
    config turns them on. Returns (loss, terms)."""
    loss_cfg = model_cfg["LOSS_CONFIG"]
    w = loss_cfg["LOSS_WEIGHTS"]
    tb = {}
    centers = batch_dict["centers"]
    labels = batch_dict["center_cls_labels"]  # (B, Nc)
    pos = labels > 0
    own_gt = batch_dict["center_gt_box_of_points"]  # (B, Nc, 8)
    pred_ctr = batch_dict["centers_origin"] + batch_dict["ctr_offsets"]

    co_labels = batch_dict.get("center_origin_cls_labels")
    if co_labels is not None:
        # per class: the smooth-L1 (beta 1) mean over its vote origins'
        # entries; then the mean over the classes present
        diff = loss_utils.smooth_l1_loss(
            pred_ctr, batch_dict["gt_box_of_center_origin"][..., 0:3],
            beta=1.0)
        vals, present = [], []
        for c in range(1, num_class + 1):
            m = (co_labels == c).float()
            vals.append((diff * m[..., None]).sum()
                        / torch.clamp(m.sum() * 3, min=1.0))
            present.append(m.sum() > 0)
        vals, present = torch.stack(vals), torch.stack(present)
        vote_loss = (torch.where(present, vals, 0.0).sum()
                     / torch.clamp(present.sum(), min=1)) * float(
                         w.get("vote_weight", 1.0))
        tb["center_origin_loss_reg"] = vote_loss
    else:
        diff = loss_utils.smooth_l1_loss(pred_ctr, own_gt[..., 0:3],
                                         beta=1.0)
        vote_loss = ((diff * pos[..., None]).sum()
                     / torch.clamp(pos.float().sum() * 3, min=1.0))
        tb["vote_loss"] = vote_loss

    cness = None
    if loss_cfg.get("CENTERNESS_REGULARIZATION", False):
        cness = _centerness(centers.reshape(-1, 3), own_gt.reshape(
            -1, own_gt.shape[-1])).reshape(labels.shape)
    bce = loss_utils.sigmoid_bce_with_logits(
        batch_dict["center_cls_preds"], _class_targets(labels, num_class,
                                                       cness))
    cls_loss = (bce.mean(dim=-1) * _pos_neg_weights(labels)).sum() * float(
        w["point_cls_weight"])
    tb["center_loss_cls"] = cls_loss

    sa_loss = 0.0
    sa_labels = batch_dict.get("sa_ins_labels")
    if loss_cfg.get("LOSS_INS") is not None and sa_labels:
        preds_list = batch_dict["sa_ins_preds"]
        ins_w = w.get("ins_aware_weight", [1.0] * len(preds_list))
        methods = loss_cfg.get("SAMPLE_METHOD_LIST", [])
        total, j = 0.0, 0
        for i, preds in enumerate(preds_list):
            if preds is None or sa_labels[i] is None:
                continue
            lab = sa_labels[i]
            cn = None
            if j + 1 < len(methods) and "ctr" in str(methods[j + 1][0]):
                gts = batch_dict["sa_gt_box_of_points"][i]
                cn = _centerness(
                    batch_dict["encoder_coords"][i].reshape(-1, 3),
                    gts.reshape(-1, gts.shape[-1])).reshape(lab.shape)
            bce_i = loss_utils.sigmoid_bce_with_logits(
                preds, _class_targets(lab, num_class, cn))
            li = (bce_i.mean(dim=-1) * _pos_neg_weights(lab)).sum() * float(
                ins_w[j] if j < len(ins_w) else 1.0)
            tb[f"sa{j}_loss_ins"] = li
            total = total + li
            j += 1
        sa_loss = total / max(j, 1)
        tb["sa_loss_ins"] = sa_loss

    box_preds = batch_dict["center_box_preds"]
    box_labels = batch_dict["center_box_labels"]
    reg_w = pos.float() / torch.clamp(pos.float().sum(), min=1.0)
    tcfg = model_cfg["TARGET_CONFIG"]
    if str(tcfg["BOX_CODER"]) == "PointResidualCoder":
        box_loss = loss_utils.smooth_l1_loss(
            box_preds, box_labels, weights=reg_w,
            code_weights=w.get("code_weights")).sum() * float(
                w["point_box_weight"])
    else:
        nb = int(tcfg.get("BOX_CODER_CONFIG", {}).get("angle_bin_num", 12))
        loss_xyzwhl = loss_utils.smooth_l1_loss(
            box_preds[..., :6], box_labels[..., :6], weights=reg_w).sum()
        bin_label = box_labels[..., 6].to(torch.int32)
        oh_bin = torch.nn.functional.one_hot(
            bin_label.clamp(0, nb - 1).long(), nb).float()
        ce = loss_utils.softmax_cross_entropy(box_preds[..., 6:6 + nb],
                                              oh_bin)
        loss_bin = (ce * reg_w).sum() * float(w.get("dir_weight", 1.0))
        res_pred = (box_preds[..., 6 + nb:6 + 2 * nb] * oh_bin).sum(dim=-1)
        res_l = loss_utils.smooth_l1_loss(
            res_pred[..., None], box_labels[..., 7:8], beta=1.0)
        loss_res = res_l.mean() * reg_w.sum()
        box_loss = (loss_xyzwhl + loss_bin + loss_res) * float(
            w["point_box_weight"])
    tb["center_loss_box"] = box_loss

    pm = pos.reshape(-1)
    n_pos = torch.clamp(pm.float().sum(), min=1.0)
    gb = own_gt.reshape(-1, own_gt.shape[-1])[:, :7]
    corner_loss = 0.0
    if loss_cfg.get("CORNER_LOSS_REGULARIZATION", False):
        pb = batch_dict["point_box_preds"]
        cl = loss_utils.get_corner_loss_lidar(
            pb.reshape(-1, pb.shape[-1])[:, :7], gb)
        corner_loss = torch.where(pm, cl, 0.0).sum() / n_pos * float(
            w.get("corner_weight", 1.0))
        tb["corner_loss_reg"] = corner_loss

    iou_loss = 0.0
    if (loss_cfg.get("IOU3D_REGULARIZATION", False)
            and batch_dict.get("box_iou3d_preds") is not None):
        pb = batch_dict["point_box_preds"].detach()
        with torch.no_grad():
            ious = torch.diagonal(iou3d.boxes_iou3d(
                pb.reshape(-1, pb.shape[-1])[:, :7], gb))
        il = loss_utils.smooth_l1_loss(
            batch_dict["box_iou3d_preds"].reshape(-1)[..., None],
            ious[..., None], beta=1.0)[..., 0]
        iou_loss = torch.where(pm, il, 0.0).sum() / n_pos * float(
            w.get("iou3d_weight", 1.0))
        tb["iou3d_loss_reg"] = iou_loss

    total = vote_loss + cls_loss + box_loss + corner_loss + sa_loss + iou_loss
    tb["point_loss"] = total
    return total, tb
