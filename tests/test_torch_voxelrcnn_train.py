"""Voxel-RCNN training: the PyTorch port against the JAX package on the
CPU.

The RoI head's train branch (the proposals, the RoIs JAX's draws sample,
their targets, the pooled predictions) against the jitted JAX head; the
RoI loss's gradients through the voxel-query gather into the
``x_conv2`` / ``x_conv3`` / ``x_conv4`` features against ``jax.grad``;
the corner loss on this head's outputs where an unregressed RoI's codes
overflow, and where a regressed RoI's sizes square past fp32 (JAX's loss
is inf there, the port's finite); whole train steps of a tiny Voxel-RCNN and 3 Adam steps;
``tools/train.py`` and ``tools/test.py`` on a tiny
``voxel_rcnn_car.yaml``.

Tolerances, each with its reason:
- keys, draws, sampled RoIs, labels and masks are exact;
- the head's outputs and gradients: 1e-5 of the largest |entry| (sums in
  another order); the class targets within
  ``test_torch_pvrcnn_train.CLS_TARGET_TOL`` (JAX's fp32 IoU round-off);
- the tiny train step: :data:`TINY_TOL`, twice :data:`TINY_F64`, how far
  an fp32 step lies from the float64 step of the same decisions
  (:func:`test_tiny_step_float64_bounds` measures both packages' fp32
  steps against it).

The full-width reference for the card (:func:`write_fixture`) is held on
the CPU in the slow tier.
"""

import copy
import functools
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.config import Config as JaxConfig
from de6d_tpu.models import build_network as jax_build
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.models.roi_heads import roi_head_utils as jax_roi_utils
from de6d_tpu.models.roi_heads import voxelrcnn_head as jax_vrcnn
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.detectors.detector3d_template import DatasetSpec
from de6d_tpu_torch.models.roi_heads import roi_head_utils, voxelrcnn_head
from test_torch_pvrcnn_train import (
    CLS_TARGET_TOL, TARGET_KEYS, Recorded, assert_targets_equal, f64_model,
    f64_run, jax_max_iou, port_gradients, record_jax_proposals, row_index,
    tiny_gt,
)
from test_torch_second import TINY_SPEC, scene
from test_torch_voxelrcnn import (
    head_inputs, jax_head_apply, tiny_voxelrcnn_cfg,
)
from torch_fixtures import flatten_variables, perturb, unflatten

ROOT = Path(__file__).resolve().parents[1]
VOXELRCNN_CFG = ROOT / "configs/kitti_models/voxel_rcnn_car.yaml"
KITTI = ROOT / "data/kitti"
FIXTURE = ROOT / "de6d_tpu_torch/testdata/voxelrcnn_train_jax_ref.npz"
FIXTURE_BATCH = 2  # the JAX fp32 step at the config's 4 needs > 8 GiB
T = torch.from_numpy
OP_TOL = 1e-5
LOSS_CFG = {"CORNER_LOSS_REGULARIZATION": True,
            "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                             "rcnn_corner_weight": 1.0,
                             "code_weights": [1.0] * 7}}


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and ops on
    tensors above PyTorch's grain otherwise wait on OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# the head's train branch and its gradients into the stages
# ---------------------------------------------------------------------

def train_head_case(seed=3):
    """``test_torch_voxelrcnn.head_inputs`` with a train config (TRAIN
    NMS 128 -> 32 at 0.8, 16 RoIs a sample) and gt boxes: jittered copies
    of four of each sample's boxes (sample 1's last slot empty)."""
    bd, cfg = head_inputs(seed)
    cfg["NMS_CONFIG"]["TRAIN"] = {"NMS_THRESH": 0.8, "NMS_PRE_MAXSIZE": 128,
                                  "NMS_POST_MAXSIZE": 32}
    cfg["TARGET_CONFIG"] = {"ROI_PER_IMAGE": 16, "FG_RATIO": 0.5,
                            "REG_FG_THRESH": 0.55}
    cfg["LOSS_CONFIG"] = LOSS_CFG
    rng = np.random.RandomState(seed)
    boxes = bd["batch_box_preds"].numpy()
    order = np.argsort(-bd["batch_cls_preds"].numpy()[..., 0], axis=1)
    gt = np.zeros((2, 5, 8), np.float32)
    for i in range(2):
        for j in range(4):
            gt[i, j, :7] = boxes[i, order[i, 3 * j]]
            gt[i, j, :3] += rng.uniform(-0.1, 0.1, 3).astype(np.float32)
            gt[i, j, 7] = 1
    gt[1, 3] = 0.0
    bd["gt_boxes"] = T(gt)
    return bd, cfg


@functools.lru_cache(maxsize=None)
def head_train_run():
    """The JAX head's train branch and ``roi_head_loss``, jitted, with
    the gradients of the loss in the stage features and the head's
    parameters; the port's head on the same inputs and weights."""
    bd, cfg = train_head_case()
    jmod = jax_vrcnn.VoxelRCNNHead(model_cfg=cfg, num_class=1)
    arrays, jbd = jax_head_apply(jmod, bd)
    arrays["gt"] = bd["gt_boxes"].numpy()

    def full(a):
        d = jbd(a)
        d["gt_boxes"] = a["gt"]
        return d

    flat = perturb(flatten_variables(jax.jit(
        lambda r, a: jmod.init(r, full(a), train=True))(
            jax.random.PRNGKey(0), arrays)), 9)

    def loss_fn(params, feats, a):
        a = dict(a, ms={k: (f, a["ms"][k][1]) for k, f in feats.items()})
        out = jmod.apply({"params": params}, full(a), train=True)
        loss, tb = jax_roi_utils.roi_head_loss(out["roi_targets_dict"],
                                               cfg["LOSS_CONFIG"])
        keep = {k: out["roi_targets_dict"][k] for k in
                TARGET_KEYS + ("gt_of_rois_local", "rcnn_cls", "rcnn_reg")}
        keep["proposals"] = out.get("rois")
        return loss, (tb, keep)

    (loss, (tb, keep)), (gp, ga) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(
        unflatten(flat)["params"],
        {k: f for k, (f, _) in arrays["ms"].items()}, arrays)
    tmod = voxelrcnn_head.VoxelRCNNHead(
        cfg, 0, 1, voxel_size=(0.05, 0.05, 0.1),
        point_cloud_range=(0.0, -40.0, -3.0, 70.4, 40.0, 1.0),
        multi_scale_channels={"x_conv2": 6, "x_conv3": 8, "x_conv4": 8})
    weights.load_into(tmod, flat).train()
    tbd = dict(bd)
    tbd["multi_scale_3d_features"] = {
        k: (f.clone().requires_grad_(True), kk, g)
        for k, (f, kk, g) in bd["multi_scale_3d_features"].items()}
    with Recorded() as rec:
        got = tmod(tbd)
    tloss, ttb = roi_head_utils.roi_head_loss(got["roi_targets_dict"],
                                              cfg["LOSS_CONFIG"])
    tloss.backward()
    return {"flat": flat, "tmod": tmod, "tbd": tbd, "got": got, "rec": rec,
            "loss": (float(loss), float(tloss.detach())), "tb": (tb, ttb),
            "keep": {k: np.asarray(v) for k, v in keep.items()},
            "jgrads": (gp, ga), "bd": bd}


def test_train_branch_samples_jax_rois():
    """The RoIs JAX's draws sample from the TRAIN proposals, their labels,
    masks and class targets; the pooled predictions within 1e-5."""
    r = head_train_run()
    ref, rec = r["keep"], r["rec"]
    targets = {k: v.detach().numpy() for k, v in rec.targets[0].items()}
    assert 0 < ref["reg_valid_mask"].sum() < ref["roi_sample_valid"].sum()
    rois = rec.proposals[0]["rois"].numpy()
    best = np.take_along_axis(
        jax_max_iou(rois, rec.proposals[0]["roi_labels"].numpy(),
                    r["bd"]["gt_boxes"].numpy()),
        targets["roi_sample_idx"], axis=1)
    assert_targets_equal(targets, ref,
                         np.where(ref["roi_sample_valid"], best, 0.0),
                         cls_tol=CLS_TARGET_TOL)
    td = r["got"]["roi_targets_dict"]
    np.testing.assert_allclose(
        td["gt_of_rois_local"].numpy()[ref["reg_valid_mask"]],
        ref["gt_of_rois_local"][ref["reg_valid_mask"]], rtol=1e-6,
        atol=1e-6)
    for k in ("rcnn_cls", "rcnn_reg"):
        want = ref[k]
        np.testing.assert_allclose(td[k].detach().numpy(), want, rtol=0,
                                   atol=OP_TOL * np.abs(want).max(),
                                   err_msg=k)
    assert tuple(r["got"]["rois"].shape) == (2, 16, 7)


def test_loss_and_gradients_into_the_stage_features():
    """The loss terms within 1e-6 relative; the gradients in each pooled
    stage's features (through the gather's scatter-add: zero on sites no
    grid point reaches) and in the head's parameters within 1e-5 of the
    largest."""
    r = head_train_run()
    jtb, ttb = r["tb"]
    assert set(jtb) == set(ttb)
    for k in jtb:
        np.testing.assert_allclose(float(ttb[k].detach()), float(jtb[k]),
                                   rtol=1e-6, err_msg=k)
    gp, ga = r["jgrads"]
    for name, (f, _, _) in r["tbd"]["multi_scale_3d_features"].items():
        want = np.asarray(ga[name])
        assert np.abs(want).max() > 0 and (want == 0).any()
        np.testing.assert_allclose(f.grad.numpy(), want, rtol=0,
                                   atol=OP_TOL * np.abs(want).max(),
                                   err_msg=name)
        assert ((f.grad.numpy() == 0) == (want == 0)).all(), name
    want = weights.flax_params_to_torch(
        {k: np.asarray(v) for k, v in
         flatten_variables({"params": gp}).items()}, r["tmod"])
    for name, p in r["tmod"].named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=OP_TOL * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)


def test_corner_loss_survives_overflowing_codes_of_this_head():
    """The head's box codes of every RoI it does not regress pushed to
    200 in the sizes (exp overflows fp32): the loss and every gradient,
    down to the stage features, stay finite and equal those of the same
    step with those codes at zero, which no term reads."""
    r = head_train_run()
    bd, cfg = train_head_case()
    mask = r["keep"]["reg_valid_mask"]
    results = []
    for value in (200.0, 0.0):
        tmod = copy.deepcopy(r["tmod"])
        add = torch.zeros(2, 16, 7)
        add[..., 3:6] = value
        keep = torch.from_numpy(~mask)[..., None]

        def hook(mod, args, out, keep=keep, add=add):
            return torch.where(keep, out * 0 + add, out)

        tmod.FCStack_1.register_forward_hook(hook)
        tbd = dict(bd)
        feats = {k: (f.clone().requires_grad_(True), kk, g)
                 for k, (f, kk, g) in bd["multi_scale_3d_features"].items()}
        tbd["multi_scale_3d_features"] = feats
        out = tmod(tbd)
        loss, _ = roi_head_utils.roi_head_loss(out["roi_targets_dict"],
                                               cfg["LOSS_CONFIG"])
        loss.backward()
        grads = [f.grad for f, _, _ in feats.values()] + [
            p.grad for p in tmod.parameters()]
        results.append((float(loss.detach()), grads))
    (big, gb), (zero, gz) = results
    assert np.isfinite(big) and big == zero
    for a, b in zip(gb, gz):
        assert torch.isfinite(a).all()
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def unscaled_corner_loss(pred_boxes, gt_boxes):
    """The corner loss as the JAX package writes it: the unscaled norm and
    a Huber whose quadratic branch sees every distance."""
    from de6d_tpu_torch.ops import geometry
    corners = geometry.boxes_to_corners_3d
    flipped = gt_boxes.clone()
    flipped[:, 6] += np.pi
    pred = corners(pred_boxes)
    dist = torch.minimum(
        torch.linalg.norm(pred - corners(gt_boxes), dim=-1),
        torch.linalg.norm(pred - corners(flipped), dim=-1))
    return torch.where(dist < 1.0, 0.5 * dist * dist, dist - 0.5).mean(1)


def corner_case(n=2000, seed=5):
    """gt boxes over a KITTI scene's range and predictions off them by
    1 mm to 30 m, every seventh equal to its gt box."""
    rng = np.random.default_rng(seed)
    gt = np.c_[rng.uniform(-50, 50, (n, 3)), rng.uniform(0.3, 8, (n, 3)),
               rng.uniform(-4, 4, n)].astype(np.float32)
    step = rng.choice([1e-3, 0.1, 0.5, 3.0, 30.0], (n, 1))
    pred = (gt + rng.normal(0, 1, (n, 7)) * step).astype(np.float32)
    pred[::7] = gt[::7]
    return pred, gt


def test_corner_loss_equals_the_unscaled_one_bit_for_bit():
    """Below the overflow the scaled norm and the guarded Huber give the
    unscaled loss's bits and gradient bits (the scale is a power of two),
    and JAX's loss within the tolerance of
    ``test_torch_det6d_train.test_bce_and_corner_loss_equal_jax``."""
    from de6d_tpu.utils import loss_utils as jax_losses
    from de6d_tpu_torch.utils import loss_utils
    pred, gt = corner_case()
    got, want = (T(pred).requires_grad_(True) for _ in range(2))
    loss = loss_utils.get_corner_loss_lidar(got, T(gt))
    ref = unscaled_corner_loss(want, T(gt))
    torch.testing.assert_close(loss, ref, rtol=0, atol=0)
    loss.sum().backward()
    ref.sum().backward()
    torch.testing.assert_close(got.grad, want.grad, rtol=0, atol=0)
    np.testing.assert_allclose(
        loss.detach().numpy(),
        np.asarray(jax.jit(jax_losses.get_corner_loss_lidar)(pred, gt)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("code", [50.0, 65.0, 80.0])
def test_corner_loss_past_the_squares_overflow_is_finite(code):
    """Sizes decoded from a size code of 50, 65 or 80 (``exp(code)`` times
    the gt size): the squared distances overflow fp32, JAX's loss is inf
    and the unscaled gradient NaN; the port's loss is the float64 loss of
    the same fp32 boxes to 1e-6 and its gradient finite."""
    from de6d_tpu.utils import loss_utils as jax_losses
    from de6d_tpu_torch.utils import loss_utils
    pred, gt = corner_case(64)
    pred[:, 3:6] = gt[:, 3:6] * np.exp(np.float32(code))
    assert np.isfinite(pred).all()
    assert np.isinf(np.asarray(
        jax.jit(jax_losses.get_corner_loss_lidar)(pred, gt))).all()
    unscaled = T(pred).requires_grad_(True)
    unscaled_corner_loss(unscaled, T(gt)).sum().backward()
    assert torch.isnan(unscaled.grad).any()
    got = T(pred).requires_grad_(True)
    loss = loss_utils.get_corner_loss_lidar(got, T(gt))
    want = unscaled_corner_loss(T(pred).double(), T(gt).double())
    torch.testing.assert_close(loss.double(), want, rtol=1e-6, atol=0)
    loss.sum().backward()
    assert torch.isfinite(got.grad).all()


def test_corner_loss_of_a_regressed_roi_past_the_overflow_is_finite():
    """The head's size codes of every RoI it regresses pushed to 60 (the
    RoI head's codes reach ~40 in PV-RCNN's first steps on an H100): the
    loss and every gradient, down to the stage features, stay finite, and
    the loss is at least the corner loss of one such box."""
    r = head_train_run()
    bd, cfg = train_head_case()
    mask = r["keep"]["reg_valid_mask"]
    assert mask.any()
    tmod = copy.deepcopy(r["tmod"])
    add = torch.zeros(2, 16, 7)
    add[..., 3:6] = 60.0
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
    assert (np.isfinite(float(loss.detach()))
            and float(tb["rcnn_loss_corner"].detach()) > 1e24)
    for g in [f.grad for f, _, _ in feats.values()] + [
            p.grad for p in tmod.parameters()]:
        assert torch.isfinite(g).all()


# ---------------------------------------------------------------------
# a whole train step of the tiny Voxel-RCNN
# ---------------------------------------------------------------------

TINY_SEED = 6  # test_torch_voxelrcnn's
# How far an fp32 evaluation of the tiny step lies from the float64 step
# of the same decisions (the port's, every layer in float64, the
# proposals and the sampled RoIs of the fp32 step), the larger of the JAX
# package's and the port's, rounded up to about twice it
# (:func:`test_tiny_step_float64_bounds` measures and asserts them, as
# ``test_torch_pvrcnn_train.TINY_F64``; on the CPU: gradients JAX
# 3.80e-5, port 7.23e-6; loss terms JAX 2.97e-5; gradient norm 4.88e-7;
# statistics 1.21e-7; boxes 1.98e-5; losses 3.93e-7; parameters JAX
# 3.57e-5, port 1.35e-5; the class targets 0 in both, bounded by JAX's IoU
# round-off, ``CLS_TARGET_TOL``): gradients relative to each leaf's
# largest |entry|, loss terms and the gradient norm relative, BatchNorm
# statistics absolute, the sampled RoIs' boxes relative above 1 m, their
# class targets absolute, the losses of the 3 Adam steps relative and the
# parameters after them relative to each leaf's largest |entry|.
TINY_F64 = {"grad": 8e-5, "loss": 6e-5, "grad_norm": 1e-6, "stats": 3e-7,
            "boxes": 4e-5, "cls_targets": CLS_TARGET_TOL, "losses": 1e-6,
            "params": 8e-5}
# Both fp32 evaluations lie within TINY_F64 of the float64 one, so within
# twice that of each other.
TINY_TOL = {k: 2 * v for k, v in TINY_F64.items()}


def tiny_train_cfg():
    """``test_torch_voxelrcnn.tiny_voxelrcnn_cfg`` with its train settings:
    the TRAIN NMS (128 -> 32, 0.8), 16 RoIs a sample, the corner loss."""
    cfg = tiny_voxelrcnn_cfg()
    roi = cfg["ROI_HEAD"]
    roi["NMS_CONFIG"]["TRAIN"] = {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.8,
                                  "NMS_PRE_MAXSIZE": 128,
                                  "NMS_POST_MAXSIZE": 32}
    roi["TARGET_CONFIG"] = {"ROI_PER_IMAGE": 16, "FG_RATIO": 0.5,
                            "REG_FG_THRESH": 0.55}
    roi["LOSS_CONFIG"] = copy.deepcopy(LOSS_CFG)
    return cfg


def tiny_models():
    """(JAX model with the dense assigner, port model on the CPU with the
    seeded weights, the flat weights)."""
    cfg = tiny_train_cfg()
    jcfg = copy.deepcopy(cfg)
    jcfg["DENSE_HEAD"]["TARGET_ASSIGNER_CONFIG"]["WINDOWED_ASSIGN"] = False
    jmodel = jax_build(JaxConfig(jcfg), num_class=1,
                       dataset=JaxSpec(**TINY_SPEC))
    tmodel = build_network(Config(copy.deepcopy(cfg)), 1,
                           DatasetSpec(**TINY_SPEC), device="cpu")
    flat = weights.seeded_flax(tmodel, TINY_SEED)
    weights.load_into(tmodel, flat)
    return jmodel, tmodel, flat


def jax_step(jmodel, variables, batch, opt_cfg, steps):
    """The JAX package's fp32 train steps, each the body of its
    ``make_train_step`` (loss and gradients of one jitted program, then
    the optimizer's update): the first step's loss terms, gradients and
    new BatchNorm statistics; every step's loss, anchor labels, stage
    keys, proposals and the RoI stage's targets (``keeps``); the
    parameters after ``steps`` steps."""
    from flax.traverse_util import flatten_dict
    from optax import apply_updates, global_norm

    from de6d_tpu.ops import sparse as jsp
    from de6d_tpu.train.optimization import build_optimizer_and_schedule

    roi_cfg = jmodel.model_cfg["ROI_HEAD"]["NMS_CONFIG"]["TRAIN"]
    pre = int(roi_cfg["NMS_PRE_MAXSIZE"])

    def loss_fn(p, stats, b):
        with record_jax_proposals() as props:
            out, mutated = jmodel.apply({"params": p, "batch_stats": stats},
                                        dict(b), train=True,
                                        mutable=["batch_stats"])
        loss, tb = jmodel.get_training_loss(out)
        t = out["roi_targets_dict"]
        keep = {k: t[k] for k in TARGET_KEYS + ("gt_of_rois_local",)}
        keep["box_cls_labels"] = out["box_cls_labels"]
        # the proposal layer's candidates: the best anchors by score (a
        # window past NMS_PRE_MAXSIZE, for near-ties), their decoded boxes
        scores = jnp.max(jax.nn.sigmoid(props["cls"]), axis=-1)
        window = min(scores.shape[1], pre + 1024)
        keep["prop_scores"], keep["prop_order"] = jax.lax.top_k(scores,
                                                                window)
        keep["prop_boxes"] = jnp.take_along_axis(
            props["boxes"], keep["prop_order"][:, :pre, None], axis=1)
        keep["proposals"] = props["rois"]
        keep["proposal_valid"] = props["roi_valid"]
        keep["proposal_labels"] = props["roi_labels"]
        ms = out["multi_scale_3d_features"]
        keys = [ms[f"x_conv{i}"][1] for i in range(1, 5)]
        cap = keys[3].shape[1]
        keys.append(jax.vmap(lambda k: jsp.downsample_coords(
            k, ms["x_conv4"][2], (2, 1, 1), (0, 0, 0), cap, (3, 1, 1))[0])(
            keys[3]))
        for i, k in enumerate(keys):
            keep[f"keys_{i + 1}"] = k
        return loss, (tb, mutated["batch_stats"], keep)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params, stats = variables["params"], variables["batch_stats"]
    optimizer, _ = build_optimizer_and_schedule(opt_cfg, params,
                                                steps_per_epoch=1)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    @jax.jit
    def update(g, opt_state, p):
        updates, opt_state = optimizer.update(g, opt_state, p)
        return apply_updates(p, updates), opt_state

    opt_state = optimizer.init(params)
    losses, keeps = [], []
    for i in range(steps):
        (loss, (tb, new_stats, keep)), grads = grad_fn(params, stats, jb)
        if i == 0:
            first = (tb, new_stats, grads)
        params, opt_state = update(grads, opt_state, params)
        stats = new_stats
        losses.append(float(loss))
        keeps.append({k: np.asarray(v) for k, v in keep.items()})
    tb, new_stats, grads = first

    def flat(tree, prefix):
        return {"/".join((prefix,) + k): np.asarray(v, np.float32)
                for k, v in flatten_dict(tree).items()}

    return {"metrics": {k: float(v) for k, v in tb.items()}
            | {"grad_norm": float(global_norm(grads))},
            "losses": losses, "grads": flat(grads, "params"),
            "batch_stats": flat(new_stats, "batch_stats"),
            "params_after": flat(params, "params"),
            "keep": keeps[0], "keeps": keeps}


def opt_cfg():
    from de6d_tpu_torch.config import cfg_from_yaml_file

    opt = dict(cfg_from_yaml_file(VOXELRCNN_CFG).OPTIMIZATION)
    opt["NUM_EPOCHS"] = 20
    return opt


@pytest.fixture(scope="module")
def tiny_train():
    """The JAX package's and the port's step on the tiny scene from the
    same seeded weights, then 3 ``adam_onecycle`` steps; and the port's
    float64 step of the port's fp32 decisions."""
    import test_torch_pointpillar_train as ppt

    jmodel, tmodel, flat = tiny_models()
    pts, mask = scene(0)
    batch = {"points": pts, "points_mask": mask,
             "gt_boxes": tiny_gt(tmodel, pts, mask)}
    cfg = opt_cfg()
    ref = jax_step(jmodel, unflatten(flat), batch, cfg, 3)
    m64 = f64_model(tmodel)
    out, g32, m32, _ = port_gradients(copy.deepcopy(tmodel), batch)
    with Recorded() as rec:
        got = ppt.port_train_run(tmodel, flat, batch, cfg, steps=3)
    f64 = f64_run(m64, batch, cfg, 3, rec)
    return {"ref": ref, "got": got, "out": out, "rec": rec, "g32": g32,
            "m32": m32, "f64": f64, "tmodel": tmodel, "flat": flat,
            "batch": batch}


def test_tiny_step_keys_labels_and_targets(tiny_train):
    """Stage keys and the anchors' labels exact, the proposals' count and
    the sampled RoIs' labels and masks exact; the RoIs' boxes and class
    targets within :data:`TINY_TOL`; the matched gt boxes where a RoI
    overlaps one."""
    ref, out, rec = tiny_train["ref"]["keep"], tiny_train["out"], \
        tiny_train["rec"]
    ms = out["multi_scale_3d_features"]
    for i in range(1, 5):
        np.testing.assert_array_equal(ms[f"x_conv{i}"][1].numpy(),
                                      ref[f"keys_{i}"])
    np.testing.assert_array_equal(out["box_cls_labels"].numpy(),
                                  ref["box_cls_labels"])
    np.testing.assert_array_equal(
        rec.proposals[0]["roi_valid"].numpy(), ref["proposal_valid"])
    targets = {k: v.detach().numpy() for k, v in rec.targets[0].items()}
    assert 0 < ref["reg_valid_mask"].sum() < ref["roi_sample_valid"].sum()
    best = jax_max_iou(ref["rois"], ref["roi_labels"],
                       tiny_train["batch"]["gt_boxes"])
    assert_targets_equal(targets, ref,
                         np.where(ref["roi_sample_valid"], best, 0.0),
                         box_tol=TINY_TOL["boxes"],
                         cls_tol=TINY_TOL["cls_targets"])


def test_tiny_step_losses_and_grad_norm(tiny_train):
    ref, got = tiny_train["ref"]["metrics"], tiny_train["got"]["metrics"]
    assert set(got) == set(ref) == {
        "loss", "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss",
        "rcnn_loss_cls", "rcnn_loss_reg", "rcnn_loss_corner", "rcnn_loss",
        "grad_norm"}
    for k in ref:
        tol = TINY_TOL["grad_norm" if k == "grad_norm" else "loss"]
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, err_msg=k)


def test_tiny_step_gradients(tiny_train):
    """Every parameter's gradient within :data:`TINY_TOL` of its leaf's
    largest |entry|: the 12 sparse-conv kernels (the RoI head's cotangents
    enter x_conv2, x_conv3 and x_conv4 through the gather, the BEV
    through the anchor head), the pool MLPs and the FCs among them."""
    want = weights.flax_params_to_torch(tiny_train["ref"]["grads"],
                                        tiny_train["tmodel"])
    got = tiny_train["got"]["grads"]
    assert set(want) == set(got)
    for name, g in want.items():
        w = g.numpy()
        err = float(np.abs(got[name].numpy() - w).max())
        assert err <= TINY_TOL["grad"] * max(np.abs(w).max(), 1e-12), name
    prefixes = {n.split(".")[0] for n in want}
    assert prefixes == {"backbone_3d", "backbone_2d", "dense_head",
                        "roi_head"}
    for i in range(3):
        assert np.abs(want[f"roi_head.SharedMLP_{i}.Dense_0.weight"]
                      .numpy()).max() > 0


def test_tiny_step_batch_stats(tiny_train):
    want = weights.flax_to_torch(
        {**tiny_train["flat"], **tiny_train["ref"]["batch_stats"]},
        tiny_train["tmodel"])
    got = tiny_train["got"]["buffers"]
    assert sum("backbone_3d" in n for n in got) >= 20
    for name, b in got.items():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=0,
                                   atol=TINY_TOL["stats"], err_msg=name)


def test_tiny_step_losses_and_params_along_the_steps(tiny_train):
    """The losses of 3 Adam steps, and the parameters after them within
    :data:`TINY_TOL` of each leaf's largest |entry|."""
    np.testing.assert_allclose(tiny_train["got"]["losses"],
                               tiny_train["ref"]["losses"],
                               rtol=TINY_TOL["losses"])
    want = weights.flax_params_to_torch(tiny_train["ref"]["params_after"],
                                        tiny_train["tmodel"])
    got = tiny_train["got"]["params_after"]
    for name, w in want.items():
        w = w.numpy()
        err = float(np.abs(got[name].detach().numpy() - w).max())
        assert err <= TINY_TOL["params"] * np.abs(w).max(), (name, err)


def test_tiny_step_float64_bounds(tiny_train, capsys):
    """Where :data:`TINY_F64` comes from: the port's fp32 run and the JAX
    package's against the port's float64 run of the same decisions; both
    within it. Prints the distances."""
    from chip_smoke import f64_distances
    from de6d_tpu_torch.ops import iou3d

    r, f64 = tiny_train, tiny_train["f64"]
    jax_g = {n: t.numpy().reshape(-1).astype(np.float64)
             for n, t in weights.flax_params_to_torch(
                 r["ref"]["grads"], r["tmodel"]).items()}
    jax_m = {k: v for k, v in r["ref"]["metrics"].items()
             if k != "grad_norm"}
    port = f64_distances(r["g32"], r["m32"], f64["grads"], f64["metrics"])
    jaxd = f64_distances(jax_g, jax_m, f64["grads"], f64["metrics"])
    want = weights.flax_to_torch({**r["flat"], **r["ref"]["batch_stats"]},
                                 r["tmodel"])
    port["stats"] = max(float(np.abs(b.numpy() - f64["stats"][n]).max())
                        for n, b in r["got"]["buffers"].items())
    jaxd["stats"] = max(float(np.abs(want[n].numpy() - f64["stats"][n])
                              .max()) for n in f64["stats"])
    prop, tgt = r["rec"].proposals[0], r["rec"].targets[0]
    anchor = torch.gather(prop["roi_point_idx"], 1, tgt["roi_sample_idx"])
    boxes64 = torch.gather(f64["box_preds"], 1, anchor[..., None].expand(
        -1, -1, 7))
    boxes64 = torch.where(tgt["roi_sample_valid"][..., None], boxes64, 0.0)
    gt64 = T(r["batch"]["gt_boxes"]).double()
    iou64 = iou3d.boxes_iou3d(boxes64, gt64[..., :7]).amax(-1)
    cls64 = torch.clamp((iou64 - 0.25) / 0.5, 0.0, 1.0).numpy()
    valid = tgt["roi_sample_valid"].numpy()
    for d, boxes, cls in ((port, tgt["rois"], tgt["rcnn_cls_labels"]),
                          (jaxd, r["ref"]["keep"]["rois"],
                           r["ref"]["keep"]["rcnn_cls_labels"])):
        b = np.asarray(boxes, np.float64)[valid]
        w = boxes64.numpy()[valid]
        d["boxes"] = float((np.abs(b - w) / np.maximum(1.0, np.abs(w)))
                           .max())
        d["cls_targets"] = float(np.abs(np.asarray(cls)[valid]
                                        - cls64[valid]).max())
    jax_p = weights.flax_params_to_torch(r["ref"]["params_after"],
                                         r["tmodel"])
    for d, run, params in ((port, r["got"], r["got"]["params_after"]),
                           (jaxd, r["ref"], jax_p)):
        d["losses"] = float(np.max(np.abs(np.asarray(run["losses"])
                                          / f64["losses"] - 1)))
        d["params"] = max(
            float(np.abs(params[n].detach().numpy() - w).max()
                  / np.abs(w).max()) for n, w in f64["params"].items())
    with capsys.disabled():
        print(f"\ntiny Voxel-RCNN step vs float64: port fp32 {port}; JAX "
              f"fp32 {jaxd}")
    for k, bound in TINY_F64.items():
        assert port[k] <= bound and jaxd[k] <= bound, (k, port, jaxd)


# ---------------------------------------------------------------------
# the CLIs on a cut of data/kitti
# ---------------------------------------------------------------------

def tiny_voxel_rcnn_yaml(path):
    """``voxel_rcnn_car.yaml`` with its data config as shipped and small
    widths (sparse filters [8, 8, 16, 16, 16], BEV [32, 64], 4000 voxels,
    pool MLPs of 8, a 3 x 3 x 3 RoI grid, 16 RoIs of 64 proposals),
    written to ``path``."""
    import yaml

    from test_torch_second_train import _cfgs

    _, tcfg = _cfgs(VOXELRCNN_CFG)

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x

    cfg = {k: plain(tcfg[k]) for k in ("CLASS_NAMES", "DATA_CONFIG", "MODEL",
                                       "OPTIMIZATION")}
    for proc in cfg["DATA_CONFIG"]["DATA_PROCESSOR"]:
        if proc["NAME"] == "transform_points_to_voxels":
            proc["MAX_NUMBER_OF_VOXELS"] = {"train": 4000, "test": 4000}
    m = cfg["MODEL"]
    m["BACKBONE_3D"].update(NUM_FILTERS=[8, 8, 16, 16, 16], OUT_CHANNELS=16)
    m["MAP_TO_BEV"]["NUM_BEV_FEATURES"] = 32
    m["BACKBONE_2D"].update(LAYER_NUMS=[1, 1], NUM_FILTERS=[32, 64],
                            NUM_UPSAMPLE_FILTERS=[32, 32])
    roi = m["ROI_HEAD"]
    roi.update(SHARED_FC=[32], CLS_FC=[16], REG_FC=[16])
    roi["ROI_GRID_POOL"].update(GRID_SIZE=3, POOL_MLPS={
        "x_conv2": [8], "x_conv3": [8], "x_conv4": [8]})
    roi["NMS_CONFIG"]["TRAIN"].update(NMS_PRE_MAXSIZE=512,
                                      NMS_POST_MAXSIZE=64)
    roi["NMS_CONFIG"]["TEST"].update(NMS_PRE_MAXSIZE=256,
                                     NMS_POST_MAXSIZE=32)
    roi["TARGET_CONFIG"]["ROI_PER_IMAGE"] = 16
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def trained_cli(tmp_path_factory):
    from de6d_tpu_torch.tools import train
    from torch_fixtures import kitti_subtree

    tree = kitti_subtree(tmp_path_factory.mktemp("kitti"), 4, 2).resolve()
    work = tmp_path_factory.mktemp("work")
    cfg = tiny_voxel_rcnn_yaml(
        work / "configs/kitti_models/voxel_rcnn_tiny.yaml")
    args = ["--cfg_file", str(cfg), "--device", "cpu", "--workers", "1",
            "--batch_size", "2"]
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(tree)]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        run, ret = train.main(args + ["--epochs", "1", "--fix_random_seed",
                                      "--extra_tag", "a"] + data)
    finally:
        os.chdir(cwd)
    return work, args, data, run, ret


def test_train_cli_trains_voxel_rcnn(trained_cli):
    """One epoch of the tiny Voxel-RCNN through ``tools/train.py``: 2
    steps of batch 2, every loss term finite, a checkpoint, the
    post-training KITTI eval over the RoI head's detections (Car only, the
    config's class filter)."""
    work, _, _, run, ret = trained_cli
    out = work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG / "a"
    assert type(run.model).__name__ == "VoxelRCNN"
    assert list(run.cfg.CLASS_NAMES) == ["Car"]
    assert (out / "ckpt/checkpoint_epoch_1").is_file()
    assert (out / "eval/eval_with_train/result.pkl").is_file()
    assert run.state.step == 2 and len(run.step_log) == 2
    assert np.isfinite([float(x[2]) for x in run.step_log]).all()
    assert ret["recall_counts"]["gt"] > 0
    assert "Car_3d/moderate_R40" in ret


def test_test_cli_evaluates_the_voxel_rcnn_checkpoint(trained_cli):
    """``tools/test.py --ckpt`` restores the trained weights and the
    running statistics and counts the recall the train run counted."""
    from de6d_tpu_torch.tools import test

    work, args, data, run, ret = trained_cli
    ckpt = (work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG
            / "a/ckpt/checkpoint_epoch_1")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        got = test.main(args + ["--ckpt", str(ckpt), "--extra_tag", "a",
                                "--allow-zero-recall"] + data)
    finally:
        os.chdir(cwd)
    assert got["recall_counts"] == ret["recall_counts"]


# ---------------------------------------------------------------------
# the full-width reference for the card (which has no JAX)
# ---------------------------------------------------------------------

def jax_kitti_batch():
    """The JAX loader's first batch of :data:`FIXTURE_BATCH` on
    ``data/kitti``'s train split (``voxel_rcnn_car.yaml``'s
    ``DATA_CONFIG``, one worker, seed 0)."""
    from de6d_tpu.datasets import build_dataloader as jax_build_loader
    from test_torch_second_train import _cfgs

    jcfg, _ = _cfgs(VOXELRCNN_CFG)
    _, loader = jax_build_loader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES,
                                 FIXTURE_BATCH, root_path=str(KITTI),
                                 training=True, seed=0, workers=1)
    loader.set_epoch(0)
    raw = next(iter(loader))
    return {k: np.asarray(raw[k]) for k in ("points", "points_mask",
                                             "gt_boxes")}


def fixture_content():
    """The JAX package's fp32 train step from the weights of
    ``chip_smoke.pvrcnn_train_model`` with ``voxel_rcnn_car.yaml`` and
    ``chip_smoke.VOXELRCNN_TRAIN_SEED`` (flax's initialisers drawn from a
    numpy seed; dense assigner) on :func:`jax_kitti_batch`: stage keys,
    anchor labels, the proposal layer's candidates (a window of the best
    anchors, their boxes) and RoIs, the sampled RoIs (and which proposal
    each is) with their targets, loss terms, gradient norm, gradients,
    statistics, the losses of 3 Adam steps, each later step's proposals
    and sampled RoIs (``step2/``, ``step3/``) and the parameters after
    them, per parameter in the port's layout."""
    import test_torch_pointpillar_train as ppt
    from chip_smoke import VOXELRCNN_TRAIN_SEED, pvrcnn_opt_cfg
    from chip_smoke import pvrcnn_train_model

    batch = jax_kitti_batch()
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        jmodel, tmodel = ppt.build_pair_train(str(VOXELRCNN_CFG))
        flat = weights.torch_to_flax(pvrcnn_train_model(
            "cpu", VOXELRCNN_CFG, VOXELRCNN_TRAIN_SEED)[0])
    finally:
        os.chdir(cwd)
    ref = jax_step(jmodel, unflatten(flat), batch,
                   pvrcnn_opt_cfg(VOXELRCNN_CFG), 3)
    keep = ref["keep"]
    out = dict(batch)
    for i in range(1, 6):
        out[f"keys_{i}"] = keep[f"keys_{i}"].astype(np.int32)
    labels = keep["box_cls_labels"].reshape(-1)
    nz = np.flatnonzero(labels)
    out["labels_idx"] = nz.astype(np.int64)
    out["labels_val"] = labels[nz].astype(np.int32)
    out["prop_order"] = keep["prop_order"].astype(np.int32)
    out["prop_scores"] = keep["prop_scores"]
    out["prop_boxes"] = keep["prop_boxes"]
    for i, kp in enumerate(ref["keeps"]):
        pre = "" if i == 0 else f"step{i + 1}/"
        out[pre + "proposals"] = kp["proposals"]
        out[pre + "proposal_valid"] = kp["proposal_valid"]
        out[pre + "proposal_labels"] = kp["proposal_labels"].astype(np.int32)
        rows = row_index(kp["proposals"], kp["prop_boxes"])
        out[pre + "proposal_idx"] = np.where(
            kp["proposal_valid"], np.take_along_axis(
                kp["prop_order"].astype(np.int32), rows, axis=1), 0)
        out[pre + "roi_sample_idx"] = row_index(kp["rois"], kp["proposals"])
        for k in TARGET_KEYS + ("gt_of_rois_local",):
            out[f"{pre}target/{k}"] = kp[k]
    for k, val in ref["metrics"].items():
        out[f"metric/{k}"] = np.float32(val)
    out["losses"] = np.asarray(ref["losses"], np.float32)
    ppt.store_leaves(out, "grad", weights.flax_params_to_torch(ref["grads"],
                                                               tmodel))
    stats = weights.flax_to_torch({**flat, **ref["batch_stats"]}, tmodel)
    for name, t in stats.items():
        if "running" in name:
            out[f"stats/{name}"] = t.numpy()
    ppt.store_leaves(out, "params3", weights.flax_params_to_torch(
        ref["params_after"], tmodel))
    return out


def write_fixture():
    """Rewrite ``testdata/voxelrcnn_train_jax_ref.npz`` with ``python -c
    "import sys; sys.path.insert(0, 'tests'); import jax;
    jax.config.update('jax_platforms', 'cpu'); import
    test_torch_voxelrcnn_train as t; t.write_fixture()"``."""
    np.savez_compressed(FIXTURE, **fixture_content())


def test_fixture_holds_what_the_card_reads():
    """The card's parity phase (``chip_smoke.check_pvrcnn_train_parity``
    with ``chip_smoke.VOXELRCNN_TRAIN``) reads these keys; the batch is
    the JAX loader's first of :data:`FIXTURE_BATCH`."""
    b = FIXTURE_BATCH
    with np.load(FIXTURE) as ref:
        files = set(ref.files)
        assert ref["points"].shape == (b, 16384, 4)
        assert ref["proposals"].shape == (b, 512, 7)
        assert ref["target/rois"].shape == (b, 128, 7)
        assert ref["roi_sample_idx"].shape == (b, 128)
        assert ref["losses"].shape == (3,)
        assert ref["labels_idx"].size > 0
        assert ref["target/reg_valid_mask"].sum() > 0
        assert ref["step3/target/roi_sample_valid"].sum() > 0
    assert {"points_mask", "gt_boxes", "keys_5", "prop_order",
            "prop_scores", "proposal_idx", "proposal_labels",
            "metric/loss", "metric/rcnn_loss_corner",
            "metric/grad_norm"} <= files
    assert not any(f.startswith(("keypoint", "point_cls")) for f in files)
    assert sum(f.startswith("stats/") for f in files) > 40
    assert FIXTURE.stat().st_size < 3 * 2 ** 20


@pytest.mark.parametrize("fault", ["none", "sample", "cls_target",
                                   "label"])
def test_sampling_check_refuses_faults(fault):
    """``chip_smoke.check_pvrcnn_sampling`` passes the fixture's sampled
    RoIs against themselves and refuses another sampled RoI, a moved
    class target and a changed label."""
    from chip_smoke import VOXELRCNN_TRAIN, check_pvrcnn_sampling

    ref = dict(np.load(FIXTURE))
    targets = {k: T(ref[f"target/{k}"].copy()) for k in
               TARGET_KEYS + ("gt_of_rois_local",)}
    targets["roi_sample_idx"] = T(ref["roi_sample_idx"].copy())
    valid = np.flatnonzero(ref["target/roi_sample_valid"][0])
    if fault == "sample":
        targets["roi_sample_idx"][0, valid[0]] += 1
    elif fault == "cls_target":
        targets["rcnn_cls_labels"][0, valid[-1]] += 0.01
    elif fault == "label":
        targets["roi_labels"][0, valid[0]] += 1
    if fault == "none":
        check_pvrcnn_sampling("t", targets, ref, VOXELRCNN_TRAIN.tol)
        return
    with pytest.raises(RuntimeError):
        check_pvrcnn_sampling("t", targets, ref, VOXELRCNN_TRAIN.tol)


@pytest.mark.slow
def test_fixture_equals_fresh_jax_run():
    ref = fixture_content()
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in stored.files:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_train_step_matches_fixture_on_cpu(capsys):
    """The card's parity phase (``chip_smoke.check_pvrcnn_train_parity``
    with ``chip_smoke.VOXELRCNN_TRAIN``) here on the CPU, with the float64
    step of the same decisions behind ``chip_smoke.VOXELRCNN_TRAIN_F64``:
    the port's fp32 step and the fixture's JAX step both within it.
    Prints the distances."""
    from chip_smoke import (
        VOXELRCNN_TRAIN, check_pvrcnn_train_parity, measure_pvrcnn_train_f64,
    )

    f64 = measure_pvrcnn_train_f64("cpu", spec=VOXELRCNN_TRAIN)
    with capsys.disabled():
        print(f"\nVoxel-RCNN full-width step vs float64: {f64}")
    for side in ("port", "jax"):
        for k, v in f64[side].items():
            assert v <= VOXELRCNN_TRAIN.f64[k], (side, k, v)
    report = check_pvrcnn_train_parity("cpu", measure_f64=False,
                                       spec=VOXELRCNN_TRAIN)
    with capsys.disabled():
        print(f"proposals {report['proposals']}; sampling "
              f"{report['sampling']}")
    assert report["positives"] > 0
