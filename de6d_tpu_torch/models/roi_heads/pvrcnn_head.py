"""PV-RCNN's RoI head with RoI-grid pooling (counterpart of
``de6d_tpu/models/roi_heads/pvrcnn_head.py``: ``roi_grid_points`` and
``PVRCNNHead``, in eval and train).

The proposal layer (``roi_head_utils.proposal_layer``: rotated NMS over
the anchor head's decoded boxes, on the suppression-mask kernel) gives
``NMS_POST_MAXSIZE`` RoIs a sample, with ``NMS_CONFIG.TEST`` in eval and
``NMS_CONFIG.TRAIN`` in train mode. In train mode ``TARGET_CONFIG``
then samples ``ROI_PER_IMAGE`` of them (``roi_head_utils.
assign_roi_targets``, JAX's draws), and those are pooled. Each RoI
carries a G x G x G grid of points; an SA layer groups the keypoints,
their features weighted by the keypoint scores (with the scores'
gradient in train mode), around every grid point; the pooled grid, grid
index outermost, goes through the shared FCs to the class and box FCs.
Eval decodes the boxes; train writes ``roi_targets_dict`` (the sampled
targets, ``gt_of_rois_local`` and the predictions) for
``roi_head_utils.roi_head_loss``. As in the JAX head, slots past a
sample's RoI count (or invalid samples) are boxes that are pooled and
scored too, and everything is fp32.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import geometry
from ...registry import ROI_HEADS
from ..backbones_3d.pointnet2_modules import PointnetSAModuleFSMSG
from ..model_utils.mlp import FCStack, SharedMLP
from . import roi_head_utils


def roi_grid_points(rois, grid_size: int):
    """(B, R, 7+) RoIs → (B, R, G³, 3) world-frame grid points: cell
    centres of the RoI's box, z outermost and x innermost."""
    g = grid_size
    lin = (torch.arange(g, dtype=torch.float32, device=rois.device)
           + 0.5) / g - 0.5
    gz, gy, gx = torch.meshgrid(lin, lin, lin, indexing="ij")
    offsets = torch.stack([gx.reshape(-1), gy.reshape(-1), gz.reshape(-1)],
                          dim=-1)  # (G³, 3)
    local = offsets[None, None] * rois[..., None, 3:6]
    b, r, g3, _ = local.shape
    world = geometry.rotate_points_along_z(
        local.reshape(b * r, g3, 3), rois[..., 6].reshape(-1)
    ).reshape(b, r, g3, 3)
    return world + rois[..., None, 0:3]


@ROI_HEADS.register
class PVRCNNHead(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class=1, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg
        use_bn = model_cfg.get("USE_BN", True)
        pool_cfg = model_cfg["ROI_GRID_POOL"]
        self.grid_size = int(pool_cfg["GRID_SIZE"])
        self.pool_sa = PointnetSAModuleFSMSG(
            in_channels=input_channels,
            radii=tuple(float(r) for r in pool_cfg["POOL_RADIUS"]),
            nsamples=tuple(int(s) for s in pool_cfg["NSAMPLE"]),
            mlps=tuple(tuple(m) for m in pool_cfg["MLPS"]),
            use_xyz=True, use_bn=use_bn,
        )
        self.shared_fc = SharedMLP(
            self.grid_size ** 3 * self.pool_sa.out_channels,
            model_cfg["SHARED_FC"], use_bn=use_bn)
        cin = self.shared_fc.out_channels
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
        b, r = rois.shape[:2]
        grid = roi_grid_points(rois[..., :7], self.grid_size)
        g3 = grid.shape[2]
        kp = batch_dict["point_coords"]  # (B, K, 3)
        kp_feats = batch_dict["point_features"]
        kp_valid = batch_dict["point_valid"]
        scores = batch_dict.get("point_cls_scores")  # (B, K)
        if scores is not None:  # keypoint features weighted by foreground
            kp_feats = kp_feats * scores[..., None]
        _, pooled, _, _, _ = self.pool_sa(
            kp, kp_feats, kp_valid, new_xyz=grid.reshape(b, r * g3, 3),
            new_valid=torch.ones(b, r * g3, dtype=torch.bool,
                                 device=kp.device))
        pooled = pooled.reshape(b, r, g3 * pooled.shape[-1])
        shared = self.shared_fc(pooled)
        rcnn_cls = self.cls_layers(shared).squeeze(-1)  # (B, R)
        rcnn_reg = self.reg_layers(shared)  # (B, R, 7)
        batch_dict["rcnn_cls"] = rcnn_cls
        batch_dict["rcnn_reg"] = rcnn_reg
        if train:
            targets["rcnn_cls"] = rcnn_cls
            targets["rcnn_reg"] = rcnn_reg
            batch_dict["roi_targets_dict"] = targets
            return batch_dict
        # the anchor head's outputs, which the RoI stage's replace, stay
        # readable for the parity checks
        batch_dict["rpn_cls_preds"] = batch_dict["batch_cls_preds"]
        batch_dict["rpn_box_preds"] = batch_dict["batch_box_preds"]
        batch_dict["batch_box_preds"] = roi_head_utils.rcnn_box_decode(
            rois[..., :7], rcnn_reg)
        batch_dict["batch_cls_preds"] = rcnn_cls[..., None]
        batch_dict["cls_preds_normalized"] = False
        return batch_dict
