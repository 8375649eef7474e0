"""Vote-based point heads, inference only (counterpart of
``de6d_tpu/models/dense_heads/point_head_vote.py``:
``_PointHeadVoteBase.__call__`` in eval, ``PointHeadBoxVote`` and
``PointHeadBox6DVote``).

Candidates (``SAMPLE_RANGE`` of the backbone's points) → vote FC (fp32,
offsets clamped to ``MAX_TRANSLATION_RANGE``) → SA re-aggregation at the
vote centers over all backbone points (no pc_range, so never the folded
path) → shared FC → cls / reg → decode with the head's box coder. The
targets and losses come with the training slice.
"""

from __future__ import annotations

import torch
from torch import nn

from ...registry import POINT_HEADS
from ...utils import box_coder_utils
from ..backbones_3d.pointnet2_modules import PointnetSAModuleFSMSG
from ..model_utils.dtype_utils import compute_dtype
from ..model_utils.mlp import FCStack, SharedMLP


class _PointHeadVoteBase(nn.Module):
    def __init__(self, model_cfg, input_channels, num_class, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg
        self.num_class = num_class
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
        batch_dict["batch_cls_preds"] = cls_preds
        batch_dict["batch_box_preds"] = point_box_preds
        batch_dict["cls_preds_normalized"] = False
        return batch_dict


@POINT_HEADS.register
class PointHeadBoxVote(_PointHeadVoteBase):
    """7-DoF vote head (3DSSD / SASA): the box layout comes from
    ``PointBinResidualCoder``."""


@POINT_HEADS.register
class PointHeadBox6DVote(_PointHeadVoteBase):
    """Full-pose Det6D head: the 6-DoF behaviour comes from
    ``PointBinResidual6DCoder``."""
