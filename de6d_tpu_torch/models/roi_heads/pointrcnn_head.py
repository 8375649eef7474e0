"""PointRCNN's second-stage RoI head (counterpart of
``de6d_tpu/models/roi_heads/pointrcnn_head.py``: ``roipoint_pool3d`` and
``PointRCNNHead``, in eval and train).

Per RoI: pool the first ``NUM_SAMPLED_POINTS`` points inside the box (in
point order, padded with the first hit), move them into the RoI's frame,
merge the local xyz with the points' score, depth and backbone features,
run an SA encoder over each RoI's point set (d-fps picks, then one
global group at the origin), then class and box FCs. All of it is fp32,
whatever the model's compute dtype: the JAX head builds its MLPs without
a dtype. Empty RoIs carry zero features and ``rcnn_cls = -1e4``.

The proposal layer takes ``NMS_CONFIG.TEST`` in eval and
``NMS_CONFIG.TRAIN`` in train mode; in train mode ``TARGET_CONFIG`` then
samples ``ROI_PER_IMAGE`` of the proposals (``roi_head_utils.
assign_roi_targets`` on JAX's ``PRNGKey(0)`` draws), those are pooled,
and ``roi_targets_dict`` is written for ``roi_head_utils.roi_head_loss``.
As in the JAX head the RoIs and the gt boxes carry no gradient, but the
pooled point features and scores do: the RoI head's loss reaches the
backbone and the first stage's class layers through the gathers.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import ball_query as bq
from ...ops import geometry
from ...registry import ROI_HEADS
from ..backbones_3d.pointnet2_modules import PointnetSAModuleFSMSG
from ..model_utils.mlp import FCStack, SharedMLP
from . import roi_head_utils


def roipoint_pool3d(points, point_feats, valid, rois, num_sampled: int,
                    extra_width=(0.0, 0.0, 0.0)):
    """points (B, N, 3), point_feats (B, N, C), valid (B, N), rois
    (B, R, 7+) → pooled xyz (B, R, S, 3) in each RoI's frame, pooled
    feats (B, R, S, C), empty (B, R) bool."""
    boxes = rois[..., :7]
    inside = geometry.points_in_boxes_mask(
        points, geometry.enlarge_box3d(boxes, extra_width))  # (B, R, N)
    inside &= valid[:, None, :]
    idx, cnt = bq._first_hits(inside, num_sampled)  # (B, R, S), (B, R)
    b, r, s = idx.shape
    pooled_xyz = bq.group_points(points, idx)
    pooled_feat = bq.group_points(point_feats, idx)
    local = pooled_xyz - boxes[:, :, None, 0:3]
    local = geometry.rotate_points_along_z(
        local.reshape(b * r, s, 3), -boxes[..., 6].reshape(-1)
    ).reshape(b, r, s, 3)
    empty = cnt == 0
    gone = empty[..., None, None]
    return (torch.where(gone, 0.0, local),
            torch.where(gone, 0.0, pooled_feat), empty)


@ROI_HEADS.register
class PointRCNNHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class=1, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
        use_bn = model_cfg.get("USE_BN", True)
        pool_cfg = model_cfg["ROI_POINT_POOL"]
        self.num_sampled = int(pool_cfg.get("NUM_SAMPLED_POINTS", 512))
        self.depth_norm = float(pool_cfg.get("DEPTH_NORMALIZER", 70.0))
        up = [int(c) for c in model_cfg.get("XYZ_UP_LAYER", [64, 64])]
        self.xyz_up = SharedMLP(3, up, use_bn=use_bn)
        # pooled features: the point's score, its depth, its features
        self.merge_down = SharedMLP(up[-1] + 2 + input_channels, (up[-1],),
                                    use_bn=use_bn)
        sa_cfg = model_cfg["SA_CONFIG"]
        sa, cin = [], up[-1]
        for k, npoint in enumerate(sa_cfg["NPOINTS"]):
            sa.append(PointnetSAModuleFSMSG(
                in_channels=cin,
                npoint_list=(int(npoint),) if int(npoint) > 0 else (),
                sample_range_list=((0, -1),),
                sample_method_list=("d-fps",),
                radii=(float(sa_cfg["RADIUS"][k]),),
                nsamples=(int(sa_cfg["NSAMPLE"][k]),),
                mlps=(tuple(sa_cfg["MLPS"][k]),),
                use_bn=use_bn,
            ))
            cin = sa[-1].out_channels
        self.sa_modules = nn.ModuleList(sa)
        self.cls_layers = FCStack(cin, model_cfg["CLS_FC"], num_class,
                                  use_bn=use_bn)
        self.reg_layers = FCStack(cin, model_cfg["REG_FC"], 7, use_bn=use_bn)

    def forward(self, batch_dict):
        train = self.training
        nms_cfg = self.model_cfg["NMS_CONFIG"]["TRAIN" if train else "TEST"]
        num_rois = int(nms_cfg.get("NMS_POST_MAXSIZE", 512))
        batch_dict = roi_head_utils.proposal_layer(batch_dict, nms_cfg,
                                                   num_rois)
        if train:
            tcfg = self.model_cfg["TARGET_CONFIG"]
            targets = roi_head_utils.sample_rois(
                batch_dict, roi_per_image=int(tcfg.get("ROI_PER_IMAGE", 128)),
                fg_ratio=float(tcfg.get("FG_RATIO", 0.5)),
                fg_thresh=float(tcfg.get("REG_FG_THRESH", 0.55)))
        rois = batch_dict["rois"]
        coords = batch_dict["point_coords"]  # (B, N, 3)
        feats = batch_dict["point_features"]  # (B, N, C) fp32
        valid = batch_dict.get("point_valid")
        if valid is None:
            valid = torch.ones(coords.shape[:2], dtype=torch.bool,
                               device=coords.device)
        x, y, z = coords.unbind(-1)
        depth = torch.sqrt(x * x + y * y + z * z) / self.depth_norm - 0.5
        extra = [depth[..., None]]
        scores = batch_dict.get("point_cls_scores")
        if scores is not None:
            extra.insert(0, scores if scores.dim() == 3 else scores[..., None])
        feats_aug = torch.cat(extra + [feats], dim=-1)

        pooled_xyz, pooled_feat, empty = roipoint_pool3d(
            coords, feats_aug, valid, rois, self.num_sampled)
        b, r, s, _ = pooled_xyz.shape
        merged = self.merge_down(
            torch.cat([self.xyz_up(pooled_xyz), pooled_feat], dim=-1))
        x_xyz = pooled_xyz.reshape(b * r, s, 3)
        x_feat = merged.reshape(b * r, s, -1)
        x_valid = (~empty).reshape(b * r, 1).expand(b * r, s)
        for sa in self.sa_modules:
            if sa.npoint_list:
                x_xyz, x_feat, _, x_valid, _ = sa(x_xyz, x_feat, x_valid)
            else:  # global stage: one group at the origin
                center = torch.zeros(b * r, 1, 3, dtype=x_xyz.dtype,
                                     device=x_xyz.device)
                _, x_feat, _, _, _ = sa(x_xyz, x_feat, x_valid,
                                        new_xyz=center)
                x_xyz = center
                x_valid = torch.ones(b * r, 1, dtype=torch.bool,
                                     device=x_xyz.device)
        head_feat = x_feat.mean(dim=1).reshape(b, r, -1)

        rcnn_cls = self.cls_layers(head_feat).squeeze(-1)  # (B, R)
        rcnn_reg = self.reg_layers(head_feat)  # (B, R, 7)
        rcnn_cls = torch.where(empty, -1e4, rcnn_cls)
        batch_dict["rcnn_cls"] = rcnn_cls
        batch_dict["rcnn_reg"] = rcnn_reg
        batch_dict["roi_empty"] = empty
        if train:
            targets["rcnn_cls"] = rcnn_cls
            targets["rcnn_reg"] = rcnn_reg
            batch_dict["roi_targets_dict"] = targets
            return batch_dict
        batch_dict["batch_box_preds"] = roi_head_utils.rcnn_box_decode(
            rois[..., :7], rcnn_reg)
        batch_dict["batch_cls_preds"] = rcnn_cls[..., None]
        batch_dict["cls_preds_normalized"] = False
        return batch_dict
