"""PointPillars training: the PyTorch port against the JAX package on the
CPU, module by module (nearest-BEV IoU, box encode, the dense assigner
against JAX's dense and windowed ones, direction targets, losses, the
anchor-head loss, BatchNorm in train mode) and one whole train step
(``make_train_step``) from the same weights and batch.

Tolerances, each with its reason:
- labels, direction bins and the IoU are exact: the port rounds as
  jitted XLA does (its reciprocal products and FMAs);
- box encode and the losses: 1e-6 relative (log / exp / sigmoid of the
  two libraries differ by an ulp);
- the train step, fp32: the convolutions and reductions sum in another
  order, so the loss terms and the gradient norm agree to 1e-4
  relative, every gradient to 1e-4 of the largest entry of its leaf,
  the BatchNorm statistics to 1e-5, the losses of 3 steps to 1e-4 and
  the parameters after them to 1e-5 of the leaf's largest entry (but
  for at most 0.5 % of a leaf, see the test).

The full-width fixture (``write_fixture``) is compared on the CPU in the
slow tier and on the card by ``chip_smoke.check_train_parity``, whose
tolerances (``chip_smoke.TRAIN_TOL``) allow for the JAX reference's own
fp32 error at that size.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.models.dense_heads import anchor_head as jax_head
from de6d_tpu.models.dense_heads.anchor_generator import (
    generate_anchors as jax_generate_anchors,
)
from de6d_tpu.models.dense_heads.axis_aligned_assigner import (
    assign_targets as jax_assign, assign_targets_windowed, choose_window_cells,
)
from de6d_tpu.ops import iou3d as jax_iou3d
from de6d_tpu.utils import box_coder_utils as jax_coders
from de6d_tpu.utils import loss_utils as jax_losses
from de6d_tpu_torch import weights
from de6d_tpu_torch.models.dense_heads import anchor_head
from de6d_tpu_torch.models.dense_heads.axis_aligned_assigner import (
    assign_targets,
)
from de6d_tpu_torch.models.model_utils.layers import BatchNorm
from de6d_tpu_torch.ops import iou3d
from de6d_tpu_torch.utils import box_coder_utils, loss_utils
from torch_fixtures import build_pair, flatten_variables, perturb

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / "configs/kitti_models/pointpillar_tiny.yaml")
FULL = str(ROOT / "configs/kitti_models/pointpillar.yaml")
FIXTURE = ROOT / "de6d_tpu_torch/testdata/pointpillar_train_jax_ref.npz"

PC_RANGE = [0.0, -19.84, -3.0, 34.56, 19.84, 1.0]
GRID = (216, 248, 1)  # stride 2 -> 108 x 124 cells, 6 anchors a cell
SIZES = {1: (3.9, 1.6, 1.56), 2: (0.8, 0.6, 1.73), 3: (1.76, 0.6, 1.73)}


def _anchor_cfg():
    from de6d_tpu_torch.config import cfg_from_yaml_file

    return cfg_from_yaml_file(FULL).MODEL["DENSE_HEAD"][
        "ANCHOR_GENERATOR_CONFIG"]


def _scene(rng, m, n_valid):
    """(m, 8) gts of the three classes, sizes around their anchors', zero
    rows after the first n_valid."""
    gt = np.zeros((m, 8), np.float32)
    for i in range(n_valid):
        c = rng.randint(1, 4)
        gt[i, 0] = rng.uniform(PC_RANGE[0] + 1, PC_RANGE[3] - 1)
        gt[i, 1] = rng.uniform(PC_RANGE[1] + 1, PC_RANGE[4] - 1)
        gt[i, 2] = rng.uniform(-1.5, 0.0)
        gt[i, 3:6] = np.array(SIZES[c]) * rng.uniform(0.8, 1.3, 3)
        gt[i, 6] = rng.uniform(-np.pi, np.pi)
        gt[i, 7] = c
    return gt


def _adversarial():
    """Identical gts (a tie between gts), two classes in one cell, the
    grid's corners, a centre outside the range, yaws at +-pi/4 and at
    multiples of pi/2 (the nearest-BEV swap's edges)."""
    rows = [
        (10.0, 5.0, -0.8, 3.9, 1.6, 1.56, 0.3, 1),
        (10.0, 5.0, -0.8, 3.9, 1.6, 1.56, 0.3, 1),
        (20.0, -10.0, -0.8, 3.9, 1.6, 1.56, -1.2, 1),
        (20.0, -10.0, -0.6, 0.8, 0.6, 1.73, 0.0, 2),
        (0.4, -19.5, -0.8, 3.9, 1.6, 1.56, 1.0, 1),
        (34.2, 19.5, -0.8, 1.76, 0.6, 1.73, -2.0, 3),
        (-1.5, 0.0, -0.8, 3.9, 1.6, 1.56, 0.0, 1),
        (10.1, 5.1, -0.8, 3.8, 1.55, 1.5, 0.3, 1),
        (15.0, 0.0, -0.8, 3.9, 1.6, 1.56, np.float32(np.pi / 4), 1),
        (25.0, 8.0, -0.8, 3.9, 1.6, 1.56, -np.float32(np.pi / 4), 1),
        (5.0, 12.0, -0.8, 3.9, 1.6, 1.56, np.float32(np.pi / 2), 1),
        (28.0, -4.0, -0.6, 1.76, 0.6, 1.73, np.float32(np.pi), 3),
    ]
    gt = np.zeros((1, 14, 8), np.float32)
    gt[0, :len(rows)] = np.asarray(rows, np.float32)
    return gt


def _boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, :2] = rng.uniform(-10, 10, (n, 2))
    b[:, 2] = rng.uniform(-2, 0, n)
    b[:, 3] = rng.uniform(0.5, 5, n)
    b[:, 4] = rng.uniform(0.4, 2, n)
    b[:, 5] = 1.5
    b[:, 6] = rng.uniform(-7, 7, n)
    return b


def _edge_yaws():
    """float32 yaws at and a few ulps around +-pi/4, +-pi/2, multiples of
    pi: where the snap swaps dx and dy or its multiple of pi changes."""
    out = []
    for base in (np.pi / 4, -np.pi / 4, 3 * np.pi / 4, np.pi / 2, -np.pi / 2,
                 3 * np.pi / 2, 0.0, np.pi, -np.pi, 2 * np.pi):
        v = np.float32(base)
        for _ in range(4):
            v = np.nextafter(v, np.float32(-np.inf))
        for _ in range(9):
            out.append(v)
            v = np.nextafter(v, np.float32(np.inf))
    return np.asarray(out, np.float32)


def test_nearest_bev_iou_equals_jitted_jax():
    rng = np.random.RandomState(0)
    a = _boxes(rng, 1500)
    g = _boxes(rng, 120)
    yaws = _edge_yaws()
    g[:len(yaws), 6] = yaws
    a[:len(yaws), 6] = yaws[::-1]
    g[len(yaws):len(yaws) + 8, :2] = a[:8, :2]  # centres shared
    ref = np.asarray(jax.jit(jax_iou3d.boxes3d_nearest_bev_iou)(a, g))
    got = iou3d.boxes3d_nearest_bev_iou(torch.from_numpy(a),
                                        torch.from_numpy(g)).numpy()
    assert (ref > 0).sum() > 1000
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))


def test_encode_equals_jax():
    rng = np.random.RandomState(1)
    boxes = _boxes(rng, 3000)
    anchors = _boxes(rng, 3000)
    ref = np.asarray(jax.jit(jax_coders.ResidualCoder().encode)(boxes,
                                                                 anchors))
    got = box_coder_utils.ResidualCoder().encode(
        torch.from_numpy(boxes), torch.from_numpy(anchors)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.fixture(scope="module")
def anchor_setup():
    anchors, groups, matched, unmatched, _ = jax_generate_anchors(
        _anchor_cfg(), GRID, PC_RANGE)
    ny, nx = anchors.shape[:2]
    tiled = [np.tile(x, ny * nx) for x in (groups, matched, unmatched)]
    return anchors, (groups, matched, unmatched), tiled


@pytest.mark.parametrize("jax_path", ["dense", "windowed_loop",
                                      "windowed_scatter"])
@pytest.mark.parametrize("scenes", ["random", "adversarial"])
def test_assign_targets_equals_jax(anchor_setup, jax_path, scenes):
    """The port's dense assigner against JAX's dense one (the TPU path)
    and its windowed one (bit-equal to the dense): labels and weights
    exact, regression targets within 1e-6. Padded gts and a sample
    without a valid gt (all labels 0) are in the random scenes."""
    anchors, per_loc, tiled = anchor_setup
    flat = anchors.reshape(-1, 7)
    rng = np.random.RandomState(2)
    gt = (np.stack([_scene(rng, 12, 9), _scene(rng, 12, 1),
                    _scene(rng, 12, 0)]) if scenes == "random"
          else _adversarial())
    coder = jax_coders.ResidualCoder()
    if jax_path == "dense":
        ref = jax_assign(*(jnp.asarray(x) for x in (flat, *tiled, gt)),
                         box_coder=coder)
    else:
        ref = assign_targets_windowed(
            *(jnp.asarray(x) for x in (anchors, *per_loc, gt)),
            box_coder=coder, window=choose_window_cells(anchors),
            method=jax_path.split("_")[1])
    got = assign_targets(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in (flat, *tiled, gt)),
        box_coder_utils.ResidualCoder())
    labels = np.asarray(ref["box_cls_labels"])
    assert (labels > 0).sum() > 0
    if scenes == "random":
        assert not labels[2].any()
    np.testing.assert_array_equal(got["box_cls_labels"].numpy(), labels)
    np.testing.assert_array_equal(got["reg_weights"].numpy(),
                                  np.asarray(ref["reg_weights"]))
    np.testing.assert_allclose(got["box_reg_targets"].numpy(),
                               np.asarray(ref["box_reg_targets"]),
                               rtol=1e-6, atol=1e-6)


def test_direction_target_at_bin_edges():
    """Bins of yaws planted at the bin edges (dir_offset + k * pi, a few
    ulps either side) and random ones, against jitted JAX: exact."""
    rng = np.random.RandomState(3)
    offset = 0.78539
    edges = []
    for k in range(-3, 4):
        v = np.float32(offset + k * np.pi)
        for _ in range(3):
            v = np.nextafter(v, np.float32(-np.inf))
        for _ in range(7):
            edges.append(v)
            v = np.nextafter(v, np.float32(np.inf))
    rot = np.concatenate([np.asarray(edges, np.float32),
                          rng.uniform(-9, 9, 2000).astype(np.float32)])
    a = np.zeros((1, rot.size, 7), np.float32)
    a[..., 6] = rng.choice([0.0, 1.57], rot.size)
    reg = np.zeros((2, rot.size, 7), np.float32)
    reg[0, :, 6] = rot - a[0, :, 6]
    reg[1, :, 6] = rot
    for bins in (2, 3):
        ref = np.asarray(jax.jit(
            lambda x, y: jax_head.get_direction_target(x, y, offset, bins)
        )(a, reg))
        got = anchor_head.get_direction_target(
            torch.from_numpy(a), torch.from_numpy(reg), offset, bins)
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("loss", ["bce", "focal", "smooth_l1", "softmax_ce"])
def test_losses_equal_jax(loss):
    rng = np.random.RandomState(4)
    logits = (rng.randn(3, 500, 4) * 3).astype(np.float32)
    targets = (rng.rand(3, 500, 4) < 0.3).astype(np.float32)
    w = rng.rand(3, 500).astype(np.float32)
    pred = rng.randn(3, 500, 7).astype(np.float32)
    tgt = rng.randn(3, 500, 7).astype(np.float32)
    tgt[0, :5, 2] = np.nan
    cw = [1.0, 1.0, 2.0, 1.0, 1.0, 0.5, 1.0]
    t = torch.from_numpy
    if loss == "bce":
        ref = jax_losses.sigmoid_bce_with_logits(logits, targets)
        got = loss_utils.sigmoid_bce_with_logits(t(logits), t(targets))
    elif loss == "focal":
        ref = jax_losses.sigmoid_focal_loss(logits, targets, weights=w)
        got = loss_utils.sigmoid_focal_loss(t(logits), t(targets),
                                            weights=t(w))
    elif loss == "smooth_l1":
        ref = jax_losses.smooth_l1_loss(pred, tgt, weights=w,
                                        code_weights=cw)
        got = loss_utils.smooth_l1_loss(t(pred), t(tgt), weights=t(w),
                                        code_weights=cw)
    else:
        onehot = np.eye(4, dtype=np.float32)[rng.randint(0, 4, (3, 500))]
        ref = jax_losses.softmax_cross_entropy(logits, onehot, weights=w)
        got = loss_utils.softmax_cross_entropy(t(logits), t(onehot),
                                               weights=t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_anchor_head_loss_equals_jax(anchor_setup):
    """The whole head loss on the assigner's targets of random scenes
    (three classes, direction bins): each term within 1e-6 relative."""
    anchors, _, tiled = anchor_setup
    flat = anchors.reshape(-1, 7)
    rng = np.random.RandomState(5)
    gt = np.stack([_scene(rng, 12, 9), _scene(rng, 12, 3),
                   _scene(rng, 12, 0)])
    targets = assign_targets(
        *(torch.from_numpy(np.ascontiguousarray(x))
          for x in (flat, *tiled, gt)), box_coder_utils.ResidualCoder())
    a = flat.shape[0]
    batch = {
        "cls_preds": (rng.randn(3, a, 3) * 2).astype(np.float32),
        "box_preds": (rng.randn(3, a, 7) * 0.3).astype(np.float32),
        "dir_cls_preds": rng.randn(3, a, 2).astype(np.float32),
        "anchors": flat,
        **{k: v.numpy() for k, v in targets.items()},
    }
    cfg = _full_head_cfg()
    ref_total, ref_tb = jax.jit(lambda b: jax_head.anchor_head_loss(
        b, cfg["LOSS_CONFIG"], num_class=3, dir_cfg=cfg))(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got_total, got_tb = anchor_head.anchor_head_loss(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        cfg["LOSS_CONFIG"], num_class=3, dir_cfg=cfg)
    for k in ref_tb:
        np.testing.assert_allclose(float(got_tb[k]), float(ref_tb[k]),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(ref_total), rtol=1e-6)


def _full_head_cfg():
    from de6d_tpu_torch.config import cfg_from_yaml_file

    return cfg_from_yaml_file(FULL).MODEL["DENSE_HEAD"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["nhwc", "vector"])
def test_batchnorm_train_equals_flax(dtype, layout):
    """flax ``BatchNorm(use_running_average=False, momentum=0.99,
    epsilon=1e-3)``: the output (fp32 within 1e-5; bf16 within one bf16
    ulp, 2^-7 relative) and the updated running statistics (1e-5), with
    zero rows (padding) inside the statistics."""
    import flax.linen as fnn

    rng = np.random.RandomState(6)
    shape = (2, 6, 5, 16) if layout == "nhwc" else (3, 90, 16)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    x.reshape(-1, 16)[::7] = 0.0
    jdt = jnp.dtype(dtype)
    mod = fnn.BatchNorm(use_running_average=False, momentum=0.99,
                        epsilon=1e-3, dtype=jdt)
    variables = {
        "params": {"scale": rng.uniform(0.8, 1.2, 16).astype(np.float32),
                   "bias": rng.normal(0, 0.1, 16).astype(np.float32)},
        "batch_stats": {"mean": rng.normal(0, 0.1, 16).astype(np.float32),
                        "var": rng.uniform(0.5, 1.5, 16).astype(np.float32)},
    }
    xin = jnp.asarray(x, jdt)
    ref, mutated = jax.jit(lambda v, a: mod.apply(
        v, a, mutable=["batch_stats"]))(variables, xin)
    bn = BatchNorm(16, dtype=getattr(torch, dtype))
    weights.load_into(bn, flatten_variables(variables))
    bn.train()
    xt = torch.from_numpy(np.asarray(xin.astype(jnp.float32))).to(
        getattr(torch, dtype))
    if layout == "nhwc":  # the 2D backbone's channels-last NCHW view
        got = bn(xt.permute(0, 3, 1, 2), channel_dim=1).permute(0, 2, 3, 1)
    else:
        got = bn(xt)
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mutated["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mutated["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------
# one whole train step, tiny config
# --------------------------------------------------------------------

def tiny_batch(spec, seed=7):
    """3 samples of 2048 points (100 padding rows each): 5 gts with the
    last a zero row, the first three Cars (the tiny config's one class,
    so there are positives), the third sample without any gt."""
    from model_fixtures import random_batch

    batch = random_batch(np.random.RandomState(seed), spec, batch_size=3)
    batch["gt_boxes"][:, :3, -1] = 1
    batch["gt_boxes"][2] = 0
    return batch


def jax_train_reference(jmodel, variables, batch, opt_cfg, steps=3):
    """The JAX package's loss, gradients, targets and new BatchNorm
    statistics of one step, and its state after ``steps`` steps of
    ``make_train_step``, all as numpy."""
    from flax.traverse_util import flatten_dict
    from optax import global_norm as optax_global_norm

    from de6d_tpu.train.optimization import build_optimizer_and_schedule
    from de6d_tpu.train.train_state import TrainState, make_train_step

    params, stats = variables["params"], variables["batch_stats"]

    def loss_fn(p, b):
        out, mutated = jmodel.apply({"params": p, "batch_stats": stats},
                                    dict(b), train=True,
                                    mutable=["batch_stats"])
        loss, tb = jmodel.get_training_loss(out)
        keep = {k: out[k] for k in ("box_cls_labels", "box_reg_targets")}
        return loss, (tb, mutated["batch_stats"], keep)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, (tb, new_stats, keep)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params, jb)
    optimizer, _ = build_optimizer_and_schedule(opt_cfg, params,
                                                steps_per_epoch=1)
    step = make_train_step(jmodel, optimizer)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree_util.tree_map(jnp.array, params),
                       batch_stats=jax.tree_util.tree_map(jnp.array, stats),
                       opt_state=optimizer.init(params))
    losses = []
    for _ in range(steps):
        state, m = step(state, dict(jb))
        losses.append(float(m["loss"]))

    def flat(tree, prefix):
        return {"/".join((prefix,) + k): np.asarray(v, np.float32)
                for k, v in flatten_dict(tree).items()}

    return {
        "metrics": {k: float(v) for k, v in tb.items()} | {
            "grad_norm": float(optax_global_norm(grads))},
        "losses": losses,
        "grads": flat(grads, "params"),
        "batch_stats": flat(new_stats, "batch_stats"),
        "params_after": flat(state.params, "params"),
        "labels": np.asarray(keep["box_cls_labels"]),
        "reg_targets": np.asarray(keep["box_reg_targets"]),
        "state": state,
    }


def port_train_run(tmodel, flat, batch, opt_cfg, steps=3):
    """The port's step from the same variables: metrics, gradients and
    BatchNorm statistics after the first step, parameters after
    ``steps``."""
    from de6d_tpu_torch.train import (
        build_optimizer_and_schedule, create_train_state, make_train_step,
    )

    weights.load_into(tmodel, flat)
    opt, _ = build_optimizer_and_schedule(opt_cfg, tmodel, 1)
    state = create_train_state(tmodel, opt)
    step = make_train_step(tmodel, opt)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {"losses": []}
    for i in range(steps):
        state, m = step(state, tb)
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["metrics"] = {k: float(v) for k, v in m.items()}
            out["grads"] = {n: p.grad.clone()
                            for n, p in tmodel.named_parameters()}
            out["buffers"] = {n: b.clone() for n, b in tmodel.named_buffers()
                              if "running" in n}
    out["params_after"] = {n: p.detach().clone()
                           for n, p in tmodel.named_parameters()}
    out["state"] = state
    return out


@pytest.fixture(scope="module")
def tiny_train():
    jmodel, tmodel, mc, nc, spec = build_pair(TINY)
    batch = tiny_batch(spec)
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    flat = perturb(flatten_variables(init), seed=11)
    # training starts from the head's prior (flax's bias_init of conv_cls),
    # not from the inference tests' zero bias
    flat["params/dense_head/conv_cls/bias"][:] = -np.log((1 - 0.01) / 0.01)
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg

    opt_cfg = dict(jax_cfg(TINY).OPTIMIZATION)
    opt_cfg["NUM_EPOCHS"] = 20
    from torch_fixtures import unflatten

    ref = jax_train_reference(jmodel, unflatten(flat), batch, opt_cfg)
    got = port_train_run(tmodel, flat, batch, opt_cfg)
    return {"ref": ref, "got": got, "tmodel": tmodel, "flat": flat,
            "batch": batch, "opt_cfg": opt_cfg, "jmodel": jmodel}


def test_train_step_targets(tiny_train):
    """The head's labels (exact) and regression targets (1e-6) inside the
    train-mode forward, against the JAX step's."""
    ref = tiny_train["ref"]
    tmodel = tiny_train["tmodel"]
    head = tmodel.dense_head
    got = assign_targets(head.anchors, head.anchor_group, head.matched_thr,
                         head.unmatched_thr,
                         torch.from_numpy(tiny_train["batch"]["gt_boxes"]),
                         head.box_coder)
    assert (ref["labels"] > 0).sum() > 0
    np.testing.assert_array_equal(got["box_cls_labels"].numpy(),
                                  ref["labels"])
    np.testing.assert_allclose(got["box_reg_targets"].numpy(),
                               ref["reg_targets"], rtol=1e-6, atol=1e-6)


def test_train_step_losses_and_grad_norm(tiny_train):
    ref, got = tiny_train["ref"]["metrics"], tiny_train["got"]["metrics"]
    assert set(got) == set(ref) == {"loss", "rpn_loss_cls", "rpn_loss_loc",
                                    "rpn_loss_dir", "rpn_loss", "grad_norm"}
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


def leaf_close(got, ref, rel, what):
    """Every entry within ``rel`` of the leaf's largest |entry|."""
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max |d| {err} > {rel} * {scale}"


def test_train_step_gradients(tiny_train):
    """Every parameter's gradient, carried into the port's layout by
    ``weights.flax_params_to_torch``."""
    want = weights.flax_params_to_torch(tiny_train["ref"]["grads"],
                                        tiny_train["tmodel"])
    got = tiny_train["got"]["grads"]
    assert set(want) == set(got)
    for name, g in want.items():
        leaf_close(got[name].numpy(), g.numpy(), 1e-4, name)


def test_train_step_batch_stats(tiny_train):
    want = weights.flax_to_torch(
        {**tiny_train["flat"], **tiny_train["ref"]["batch_stats"]},
        tiny_train["tmodel"])
    got = tiny_train["got"]["buffers"]
    assert got
    for name, b in got.items():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_train_step_losses_along_three_steps(tiny_train):
    """The loss of each of the 3 steps (each at the parameters the
    previous ones left), within 1e-4 relative."""
    np.testing.assert_allclose(tiny_train["got"]["losses"],
                               tiny_train["ref"]["losses"], rtol=1e-4)


def test_train_step_params_after_three_steps(tiny_train):
    """Parameters after 3 steps. Adam divides each entry's moment by its
    root-mean-square gradient, so an entry whose gradient sits at the
    level of the two libraries' summation-order noise moves by up to its
    learning rate either way, whatever the noise's size: such entries may
    part (at most 0.5 % of a leaf), by no more than
    the learning rates summed over the steps. Every other entry agrees
    within 1e-5 of the leaf's largest |entry|."""
    from de6d_tpu_torch.train.optimization import build_optimizer_and_schedule

    _, sched = build_optimizer_and_schedule(tiny_train["opt_cfg"],
                                            tiny_train["tmodel"], 1)
    lr_sum = sum(sched(k) for k in range(3))
    want = weights.flax_params_to_torch(tiny_train["ref"]["params_after"],
                                        tiny_train["tmodel"])
    got = tiny_train["got"]["params_after"]
    for name, p in want.items():
        ref = p.numpy()
        err = np.abs(got[name].numpy() - ref)
        parted = err > 1e-5 * np.abs(ref).max()
        assert parted.mean() <= 0.005, (name, parted.mean())
        assert err.max() <= lr_sum, (name, err.max(), lr_sum)


def test_jax_train_state_resumes_in_the_port(tiny_train):
    """``weights.flax_train_state_to_torch`` carries the JAX state after 3
    steps (params, batch_stats, Adam's mu / nu and count) into a fresh
    port model and optimizer; one more step on both agrees (parameters
    within 1e-5 of each leaf's largest entry)."""
    from flax.traverse_util import flatten_dict

    from de6d_tpu.train.optimization import build_optimizer_and_schedule
    from de6d_tpu.train.train_state import make_train_step as jax_make_step
    from de6d_tpu_torch.train import (
        build_optimizer_and_schedule as port_opt, create_train_state,
        make_train_step,
    )

    jstate = tiny_train["ref"]["state"]
    adam = jstate.opt_state[1].inner_state[0]  # clip, then the chain

    def flat(tree, prefix):
        return {"/".join((prefix,) + k): np.asarray(v, np.float32)
                for k, v in flatten_dict(tree).items()}

    tmodel = copy.deepcopy(tiny_train["tmodel"])
    sd, named = weights.flax_train_state_to_torch(
        tmodel, flat(jstate.params, "params"),
        flat(jstate.batch_stats, "batch_stats"), flat(adam.mu, "params"),
        flat(adam.nu, "params"), int(adam.count))
    tmodel.load_state_dict(sd)
    opt, _ = port_opt(tiny_train["opt_cfg"], tmodel, 1)
    opt.load_named_state(named)
    assert opt.count == 3
    state = create_train_state(tmodel, opt, step=3)
    batch = {k: torch.from_numpy(v) for k, v in tiny_train["batch"].items()}
    make_train_step(tmodel, opt)(state, batch)

    optimizer, _ = build_optimizer_and_schedule(
        tiny_train["opt_cfg"], jstate.params, steps_per_epoch=1)
    jb = {k: jnp.asarray(v) for k, v in tiny_train["batch"].items()}
    jstate, _ = jax_make_step(tiny_train["jmodel"], optimizer)(jstate, jb)
    want = weights.flax_params_to_torch(flat(jstate.params, "params"), tmodel)
    for name, p in tmodel.named_parameters():
        leaf_close(p.detach().numpy(), want[name].numpy(), 1e-5, name)


def test_other_detectors_refuse_training():
    """A detector whose loss is not ported (the bare template: every
    registered detector trains) raises in train mode, naming the ones
    that train, and the head raises on an assigner it does not port."""
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        Detector3DTemplate,
    )

    model = Detector3DTemplate.__new__(Detector3DTemplate)
    torch.nn.Module.__init__(model)
    model.train()
    with pytest.raises(NotImplementedError,
                       match="Detector3DTemplate.*PointPillars, Det6D, "
                             "3DSSD, PointRCNN, SECOND, PV-RCNN and "
                             "Voxel-RCNN"):
        model({"points": torch.zeros(1, 4, 4)})
    with pytest.raises(NotImplementedError, match="Detector3DTemplate"):
        model.get_training_loss({})

    head = anchor_head.AnchorHeadSingle(
        copy.deepcopy(_full_head_cfg()), 8, 3, ("Car", "Ped", "Cyc"),
        (32, 32, 1), PC_RANGE)
    head.model_cfg["TARGET_ASSIGNER_CONFIG"]["WINDOWED_ASSIGN"] = True
    head.train()
    x = torch.zeros(1, 16, 16, 8)
    with pytest.raises(NotImplementedError, match="WINDOWED_ASSIGN"):
        head({"spatial_features_2d": x, "gt_boxes": torch.zeros(1, 2, 8)})


# --------------------------------------------------------------------
# full-width reference for the card (which has no JAX)
# --------------------------------------------------------------------

FULL_LEAF = 16384  # leaves with fewer entries are stored whole
SAMPLES = 4096  # entries stored of each larger leaf, evenly spaced


def synthetic_batch(root, frames=4):
    """One training batch of ``frames`` synthetic KITTI frames (cars,
    pedestrians, cyclists, ~16k points each) through the JAX dataloader
    with ``pointpillar.yaml``'s data config, augmentations off."""
    import shutil

    from de6d_tpu.config import Config, cfg_from_list
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
    from de6d_tpu.datasets import build_dataloader
    from de6d_tpu.datasets.kitti.kitti_dataset import KittiDataset
    from de6d_tpu.tools.create_kitti_infos import create_infos
    from de6d_tpu.tools.make_synth_kitti import build_tree

    build_tree(root, frames=frames, train_frac=1.0, seed=0, n_points=16384,
               cars_per_frame=3, peds_per_frame=2, cyclists_per_frame=2)
    (root / "ImageSets" / "val.txt").write_text(
        (root / "ImageSets" / "train.txt").read_text())
    dataset_cfg = jax_cfg_from_yaml(
        str(ROOT / "configs/dataset_configs/kitti_dataset.yaml"))
    dataset_cfg["DATA_PATH"] = str(root)
    dataset_cfg.pop("DATA_AUGMENTOR", None)
    create_infos(KittiDataset, Config(dataset_cfg),
                 ["Car", "Pedestrian", "Cyclist"], str(root), workers=1)
    shutil.copy(root / "kitti_infos_train.pkl", root / "kitti_infos_val.pkl")
    cfg = Config()
    jax_cfg_from_yaml(FULL, cfg)
    cfg_from_list(["DATA_CONFIG.DATA_PATH", str(root)], cfg)
    cfg.DATA_CONFIG.DATA_AUGMENTOR["DISABLE_AUG_LIST"] = [
        "random_world_flip", "random_world_rotation",
        "random_world_scaling", "gt_sampling"]
    _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                 batch_size=frames, training=True, workers=0,
                                 seed=0)
    batch = next(iter(loader))
    return {k: np.asarray(batch[k]) for k in ("points", "points_mask",
                                              "gt_boxes")}


def sample_index(n):
    return np.linspace(0, n - 1, SAMPLES).astype(np.int64)


def store_leaves(out, prefix, named):
    """Torch-layout tensors → whole (small leaves) or ``SAMPLES`` evenly
    spaced entries plus the largest |entry| and the norm (large leaves)."""
    for name, t in named.items():
        a = np.asarray(t, np.float32).reshape(-1)
        if a.size < FULL_LEAF:
            out[f"{prefix}/{name}"] = a
        else:
            out[f"{prefix}_sample/{name}"] = a[sample_index(a.size)]
            out[f"{prefix}_max/{name}"] = np.float32(np.abs(a).max())
            out[f"{prefix}_norm/{name}"] = np.float64(
                np.linalg.norm(a.astype(np.float64)))


def jax_reference(tmp_root):
    """The fixture's content: the batch, and the JAX step in fp32 from the
    trained weights with the dense assigner (``WINDOWED_ASSIGN: False``,
    the TPU path). Everything per parameter is in the port's layout,
    keyed by its parameter and buffer names."""
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
    from torch_fixtures import unflatten

    batch = synthetic_batch(tmp_root)
    jmodel, tmodel = build_pair_train(FULL)
    flat = weights.load_flax_npz(ROOT / "bench_assets/pointpillar_params.npz")
    opt_cfg = dict(jax_cfg_from_yaml(FULL).OPTIMIZATION)
    ref = jax_train_reference(jmodel, unflatten(flat), batch, opt_cfg)
    out = {k: v for k, v in batch.items()}
    labels = ref["labels"].reshape(-1)
    nz = np.flatnonzero(labels)
    out["labels_idx"] = nz.astype(np.int64)
    out["labels_val"] = labels[nz].astype(np.int32)
    fg = np.flatnonzero(labels > 0)
    out["fg_idx"] = fg.astype(np.int64)
    out["reg_targets_fg"] = ref["reg_targets"].reshape(-1, 7)[fg]
    for k, v in ref["metrics"].items():
        out[f"metric/{k}"] = np.float32(v)
    out["losses"] = np.asarray(ref["losses"], np.float32)
    store_leaves(out, "grad", weights.flax_params_to_torch(ref["grads"],
                                                           tmodel))
    stats = weights.flax_to_torch({**flat, **ref["batch_stats"]}, tmodel)
    for name, t in stats.items():
        if "running" in name:
            out[f"stats/{name}"] = t.numpy()
    store_leaves(out, "params3", weights.flax_params_to_torch(
        ref["params_after"], tmodel))
    return out


def build_pair_train(cfg_path):
    """(JAX model, port model) of ``build_pair`` in fp32, with the dense
    assigner in the JAX model."""
    import copy as _copy

    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
    from de6d_tpu.models import build_network as jax_build
    from de6d_tpu.models.detectors.detector3d_template import (
        DatasetSpec as JaxSpec,
    )
    from torch_fixtures import spec_kwargs

    jcfg = jax_cfg_from_yaml(cfg_path)
    jmc = _copy.deepcopy(dict(jcfg.MODEL))
    jmc["COMPUTE_DTYPE"] = "float32"
    jmc["DENSE_HEAD"]["TARGET_ASSIGNER_CONFIG"]["WINDOWED_ASSIGN"] = False
    _, tmodel, _, nc, _ = build_pair(cfg_path)
    jmodel = jax_build(jmc, num_class=nc, dataset=JaxSpec(**spec_kwargs(jcfg)))
    return jmodel, tmodel


def write_fixture():
    """Rewrite ``testdata/pointpillar_train_jax_ref.npz`` with
    ``python -c "import sys; sys.path.insert(0, 'tests');
    import test_torch_pointpillar_train as t; t.write_fixture()"``."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        out = jax_reference(Path(tmp) / "synthkitti")
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **out)


@pytest.mark.slow
def test_fixture_equals_fresh_jax_run(tmp_path):
    ref = jax_reference(tmp_path / "synthkitti")
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in stored.files:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_train_step_matches_fixture_on_cpu():
    """The train parity phase of chip_smoke.py (``check_train_parity``,
    its tolerances in ``chip_smoke.TRAIN_TOL``), here on the CPU."""
    from chip_smoke import check_train_parity

    report = check_train_parity("cpu")
    assert report["positives"] > 0


def _gradients(model, batch):
    model.train()
    model.zero_grad(set_to_none=True)
    loss, _ = model.get_training_loss(model(dict(batch)))
    loss.backward()
    return {n: p.grad.detach().double().numpy().reshape(-1)
            for n, p in model.named_parameters()}


@pytest.mark.slow
def test_full_width_gradients_against_float64(capsys):
    """Why ``chip_smoke.TRAIN_TOL`` holds full-width gradients at 2.5e-2:
    the step's gradients evaluated by the port in float64 (every layer's
    compute dtype float64; the anchors, targets and the loss stay fp32)
    against the fixture's JAX fp32 gradients and the port's fp32 ones, as
    the largest distance over the stored entries of each leaf relative to
    its largest |entry|. Prints both; the port's fp32 must be the closer
    one by far, and JAX's within the tolerance."""
    from chip_smoke import TRAIN_TOL, build_model, load_train_batch

    ref = dict(np.load(FIXTURE))
    batch = load_train_batch("cpu")
    g32 = _gradients(build_model("float32", "cpu")[0], batch)
    m64 = build_model("float32", "cpu")[0].double()
    for mod in m64.modules():
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = torch.float64
    head = m64.dense_head
    for name in ("anchors", "matched_thr", "unmatched_thr"):
        setattr(head, name, getattr(head, name).float())
    g64 = _gradients(m64, batch)
    jax_err = port_err = 0.0
    for name, t in g64.items():
        if f"grad/{name}" in ref:
            idx = np.arange(t.size)
            jax_g = ref[f"grad/{name}"]
        else:
            jax_g = ref[f"grad_sample/{name}"]
            idx = np.linspace(0, t.size - 1, jax_g.size).astype(np.int64)
        scale = np.abs(t[idx]).max()
        jax_err = max(jax_err, np.abs(jax_g - t[idx]).max() / scale)
        port_err = max(port_err, np.abs(g32[name][idx] - t[idx]).max() / scale)
    with capsys.disabled():
        print(f"\nfull-width gradients vs float64, largest distance / leaf "
              f"max: JAX fp32 {jax_err:.3g}, port fp32 {port_err:.3g}")
    assert port_err < 1e-3 and port_err < jax_err / 10
    assert jax_err <= TRAIN_TOL["grad"]
