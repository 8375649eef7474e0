"""The RoI head's corner loss with a regressed RoI's size codes past the
decode's overflow: ``roi_head_utils.roi_head_loss`` caps them at
``CORNER_SIZE_CODE_CAP`` for that term. Without the cap, size codes of
~90 give an inf loss and NaN gradients (the decode's exp overflows fp32),
which is how PV-RCNN's epoch from the fresh init on ``data/kitti`` can
end on the card (its RoI head's codes run away at the one-cycle's peak
learning rate). JAX's loss is inf there too, from a code of ~43."""

import copy

import numpy as np
import pytest
import torch

from de6d_tpu_torch.models.roi_heads import roi_head_utils
from test_torch_voxelrcnn_train import head_train_run, train_head_case


def regressed_codes_run(value):
    """The Voxel-RCNN head's train step with the size codes of every RoI it
    regresses set to ``value``: (loss terms, the gradients down to the
    stage features)."""
    r = head_train_run()
    bd, cfg = train_head_case()
    mask = r["keep"]["reg_valid_mask"]
    assert mask.any()
    tmod = copy.deepcopy(r["tmod"])
    add = torch.zeros(2, 16, 7)
    add[..., 3:6] = value
    regressed = torch.from_numpy(mask)[..., None]
    tmod.FCStack_1.register_forward_hook(
        lambda mod, args, out: torch.where(regressed, out * 0 + add, out))
    tbd = dict(bd)
    feats = {k: (f.clone().requires_grad_(True), kk, g)
             for k, (f, kk, g) in bd["multi_scale_3d_features"].items()}
    tbd["multi_scale_3d_features"] = feats
    out = tmod(tbd)
    loss, tb = roi_head_utils.roi_head_loss(out["roi_targets_dict"],
                                            cfg["LOSS_CONFIG"])
    loss.backward()
    grads = [f.grad for f, _, _ in feats.values()] + [
        p.grad for p in tmod.parameters() if p.grad is not None]
    return {k: float(v.detach()) for k, v in tb.items()}, grads


@pytest.mark.parametrize("value", [90.0, 200.0])
def test_corner_loss_of_size_codes_past_the_decode_overflow_is_finite(
        value):
    """Size codes of 90 and 200: the loss and every gradient finite, the
    corner term that of codes at the cap (60), bit for bit."""
    terms, grads = regressed_codes_run(value)
    capped, _ = regressed_codes_run(roi_head_utils.CORNER_SIZE_CODE_CAP)
    assert all(np.isfinite(v) for v in terms.values())
    assert terms["rcnn_loss_corner"] == capped["rcnn_loss_corner"] > 1e24
    for g in grads:
        assert torch.isfinite(g).all()
