"""Det6D's direct-regression ablation (``det6d_dr_car.yaml``,
``PointHeadBox6D``) and the non-ground-aware pitch variant
(``det6d_pitch_car.yaml``): the PyTorch port against the JAX package on
the CPU, module by module (the rotation conversions, the point coder's
encode, the per-class point targets with box labels, the rotation
targets, the losses), then a tiny D.R. forward in eval, a tiny D.R.
train step with 3 Adam steps, a tiny pitch-variant train step, and the
full-width references the card reads.

Tolerances, each with its reason:
- labels (class, ignore ring, slope class), picks and box labels are
  exact: containment rounds as jitted XLA does (``geometry``), the slope
  threshold reads the gt pitch itself;
- the rotation conversions and the rotation-vector targets within 2e-6
  absolute: XLA's CPU ``atan2``, ``asin`` and ``sqrt`` and its contracted
  products round the last bit otherwise than PyTorch's for some inputs
  (the angles are in [-pi, pi], the vectors' entries below 4);
- the code targets within 1e-6 (log of the two libraries);
- single losses and the train steps' loss terms within 1e-5 relative,
  gradients within 1e-4 of each leaf's largest entry, BatchNorm statistics
  within 1e-5, parameters after 3 Adam steps within 1e-5 (the Det6D train
  parity's tolerances);
- the tiny model's detections within 1e-4 (``test_torch_det6d.py``'s).
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.models import build_network as jax_build
from de6d_tpu.models.dense_heads import point_head_box as jax_box_head
from de6d_tpu.models.dense_heads import point_head_box6d as jax_dr_head
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.ops import geometry as jax_geometry
from de6d_tpu.utils import box_coder_utils as jax_coders
from de6d_tpu.utils.testing import tiny_det6d_cfg
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config, cfg_from_yaml_file
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.dense_heads import point_head_box as box_head
from de6d_tpu_torch.models.dense_heads import point_head_box6d as dr_head
from de6d_tpu_torch.models.detectors.detector3d_template import DatasetSpec
from de6d_tpu_torch.ops import geometry
from de6d_tpu_torch.utils import box_coder_utils
from test_torch_det6d import run_jax, run_torch, scene
from test_torch_det6d_train import _coder_inputs, _target_inputs, scene_batch
from torch_fixtures import flatten_variables, perturb, unflatten
import torch_point_train as tpt

ROOT = Path(__file__).resolve().parents[1]
DR_CFG = ROOT / "configs/slopedkitti_models/det6d_dr_car.yaml"
TINY_RANGE = (0.0, -16.0, -3.0, 32.0, 16.0, 4.0)
SPEC = dict(class_names=("Car",), point_feature_dim=4,
            point_cloud_range=TINY_RANGE)
ROT_TOL = 2e-6
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and ops on
    tensors above PyTorch's grain otherwise wait on OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# rotations and the coder
# ---------------------------------------------------------------------

def _angles(seed):
    """(yaw, pitch, roll): the identity, rotations of pi +- 1e-6 about
    each axis and about mixed ones (the quaternion's other branches and
    the rotation vector's far end), then random angles."""
    rng = np.random.RandomState(seed)
    special = [(0.0, 0.0, 0.0), (1e-9, 0.0, 0.0), (0.0, 1e-9, -1e-9)]
    for d in (-1e-6, 0.0, 1e-6):
        a = np.pi + d
        special += [(a, 0.0, 0.0), (0.0, 0.0, a), (a, 0.0, a), (-a, 0.0, 0.0),
                    (a, 0.2, -0.1), (0.3, 0.0, a)]
    e = np.asarray(special, np.float32)
    r = np.stack([rng.uniform(-np.pi, np.pi, 4000),
                  rng.uniform(-1.4, 1.4, 4000),
                  rng.uniform(-np.pi, np.pi, 4000)], -1).astype(np.float32)
    e = np.concatenate([e, r])
    return e[:, 0], e[:, 1], e[:, 2]


def test_rotation_conversions_equal_jitted_jax():
    """Matrix → quaternion → rotation vector and back, and both Euler
    conversions, against jitted JAX at the identity, at pi +- 1e-6 and
    at random angles; every quaternion branch and the small-angle branch
    of ``rotvec_to_matrix`` are taken."""
    yaw, pitch, roll = _angles(0)
    rot = np.asarray(jax.jit(jax_geometry.angles_to_matrix)(yaw, pitch, roll))
    q_ref = np.asarray(jax.jit(jax_geometry.matrix_to_quat)(rot))
    q = geometry.matrix_to_quat(T(rot)).numpy()
    np.testing.assert_allclose(q, q_ref, atol=ROT_TOL)
    branch = np.argmax(np.abs(q_ref), axis=-1)
    assert set(branch.tolist()) == {0, 1, 2, 3}
    v_ref = np.asarray(jax.jit(jax_geometry.euler_zyx_to_rotvec)(
        yaw, pitch, roll))
    v = geometry.euler_zyx_to_rotvec(T(yaw), T(pitch), T(roll)).numpy()
    np.testing.assert_allclose(v, v_ref, atol=ROT_TOL)
    assert np.abs(np.linalg.norm(v_ref, axis=-1) - np.pi).min() < 1e-5
    np.testing.assert_allclose(
        geometry.matrix_to_rotvec(T(rot)).numpy(),
        np.asarray(jax.jit(jax_geometry.matrix_to_rotvec)(rot)), atol=ROT_TOL)
    vecs = np.concatenate([v_ref, v_ref[:5] * 1e-9]).astype(np.float32)
    np.testing.assert_allclose(
        geometry.rotvec_to_matrix(T(vecs)).numpy(),
        np.asarray(jax.jit(jax_geometry.rotvec_to_matrix)(vecs)),
        atol=ROT_TOL)
    e_ref = np.asarray(jax.jit(jax_geometry.rotvec_to_euler_zyx)(vecs))
    e = geometry.rotvec_to_euler_zyx(T(vecs)).numpy()
    # a yaw or roll of pi +- 1e-6 may come back on either side of pi
    d = np.abs(e - e_ref)
    d = np.minimum(d, np.abs(d - 2 * np.pi))
    assert d.max() <= ROT_TOL * 4, d.max()
    for got, ref in zip(geometry.matrix_to_euler_zyx(T(rot)),
                        jax.jit(jax_geometry.matrix_to_euler_zyx)(rot)):
        d = np.abs(got.numpy() - np.asarray(ref))
        assert np.minimum(d, np.abs(d - 2 * np.pi)).max() <= ROT_TOL


@pytest.mark.parametrize("cols", [7, 9])
def test_point_residual_coder_encode_equals_jitted_jax(cols):
    """The 8-column code (columns past the yaw pass through) within 1e-6;
    decode(encode) gives the box back."""
    boxes, pts = _coder_inputs(3)
    boxes = boxes[:, :cols]
    cls = np.ones(len(boxes), np.int32)
    cfg = dict(use_mean_size=True, mean_size=[[3.9, 1.6, 1.56]])
    ref = np.asarray(jax.jit(lambda b, p, c: jax_coders.PointResidualCoder(
        **cfg).encode(b, p, c))(boxes, pts, cls))
    coder = box_coder_utils.PointResidualCoder(**cfg)
    got = coder.encode(T(boxes), T(pts), T(cls))
    assert got.shape == ref.shape == (len(boxes), 8 + cols - 7)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    back = coder.decode(got, T(pts), T(cls)).numpy()
    np.testing.assert_allclose(back[:, :6], boxes[:, :6], rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------

@pytest.mark.parametrize("cols,num_class,encode_dims", [
    (9, 1, 7), (9, 3, None), (7, 3, None)], ids=["9dof_dr", "9dof", "7dof"])
def test_assign_point_targets_with_box_labels_equals_jitted_jax(
        cols, num_class, encode_dims):
    """Per-class labels (the box's class where ``num_class`` > 1), box
    labels identical; the code targets within 1e-6; the label-only call
    (PointHeadSimple's, PV-RCNN's) returns the same labels."""
    pts, valid, gt = _target_inputs(8)
    gt = np.concatenate([gt[..., :cols], gt[..., -1:]], -1)
    gt[:, 1, -1] = np.where(gt[:, 1, -1] > 0, 2, 0)  # a second class
    mean = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.7], [1.7, 0.6, 1.7]]
    cfg = dict(use_mean_size=True, mean_size=mean)
    ew = [0.2, 0.2, 0.2]
    ref = jax.jit(lambda p, v, g: jax_box_head.assign_point_targets(
        p, v, g, box_coder=jax_coders.PointResidualCoder(**cfg),
        extra_width=ew, num_class=num_class, encode_dims=encode_dims))(
            pts, valid, gt)
    coder = box_coder_utils.PointResidualCoder(**cfg)
    got = box_head.assign_point_targets(
        T(pts), T(valid), T(gt), extra_width=ew, box_coder=coder,
        num_class=num_class, encode_dims=encode_dims)
    for a, r in zip(got, ref):
        assert tuple(a.shape) == r.shape
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6,
                               atol=1e-6)
    labels = np.asarray(ref[0])
    assert (labels == -1).any() and (labels > 0).sum() > 50
    if num_class > 1:
        assert (labels == 2).any()
    only = box_head.assign_point_targets(T(pts), T(valid), T(gt),
                                         extra_width=ew)
    np.testing.assert_array_equal(only.numpy(), np.minimum(labels, 1))


def test_assign_rot_targets_equals_jitted_jax():
    """Slope labels identical (pitches around -0.1 included), rotation
    vectors within ``ROT_TOL``."""
    pts, valid, gt = _target_inputs(9)
    gt[:, 0, 7] = np.float32(-0.1)
    gt[:, 1, 7] = np.nextafter(np.float32(-0.1), np.float32(-1))
    ref = jax.jit(jax_dr_head.assign_rot_targets)(pts, valid, gt)
    got = dr_head.assign_rot_targets(T(pts), T(valid), T(gt))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               atol=ROT_TOL)
    lab = np.asarray(ref[0])
    assert (lab == 1).any() and (lab == 0).any() and (lab == -1).any()


def test_rot_targets_on_7_column_boxes_read_the_yaw_as_jax_does():
    """On 7-DoF gt boxes (KITTI's) the JAX package reads the pitch and
    roll at columns 7 and 8, past the end; XLA clamps the index to the
    yaw. One box of yaw 0.7 gives every point inside it the rotation
    vector of Euler angles (0.7, 0.7, 0.7) and slope class 0; a yaw below
    -0.1 gives slope class 1. The port reads the same columns."""
    rng = np.random.RandomState(11)
    box = np.array([[10.0, 2.0, -0.5, 4.0, 1.8, 1.6, 0.7],
                    [20.0, -5.0, -0.5, 4.0, 1.8, 1.6, -0.4]], np.float32)
    gt = np.zeros((1, 3, 8), np.float32)
    gt[0, :2, :7], gt[0, :2, 7] = box, 1
    pts = np.concatenate([box[i, :3] + rng.uniform(-0.6, 0.6, (40, 3))
                          for i in range(2)])[None].astype(np.float32)
    valid = np.ones(pts.shape[:2], bool)
    ref = jax.jit(jax_dr_head.assign_rot_targets)(pts, valid, gt)
    got = dr_head.assign_rot_targets(T(pts), T(valid), T(gt))
    lab, vec = np.asarray(ref[0])[0], np.asarray(ref[1])[0]
    np.testing.assert_array_equal(got[0].numpy()[0], lab)
    np.testing.assert_allclose(got[1].numpy()[0], vec, atol=ROT_TOL)
    first = lab[:40] >= 0
    assert first.sum() > 20 and (lab[:40][first] == 0).all()
    np.testing.assert_allclose(vec[:40][first],
                               np.broadcast_to([0.8897, 0.4139, 0.8897],
                                               (first.sum(), 3)), atol=1e-4)
    second = lab[40:] >= 0
    assert second.sum() > 20 and (lab[40:][second] == 1).all()


# ---------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------

def dr_head_cfg(width=None):
    """``det6d_dr_car.yaml``'s POINT_HEAD, its FC stacks ``width`` wide."""
    head = copy.deepcopy(dict(cfg_from_yaml_file(DR_CFG).MODEL.POINT_HEAD))
    if width is not None:
        for k in ("CLS_FC", "REG_FC", "ROT_CLS_FC", "ROT_REG_FC"):
            head[k] = [width]
    return head


def test_point_head_box_and_6d_losses_equal_jax():
    """Every term of ``point_head_box6d_loss`` (and so of
    ``point_head_box_loss``, its first two) within 1e-5 relative, with
    their gradients into the predictions within 1e-5 of the largest."""
    rng = np.random.RandomState(12)
    pts, valid, gt = _target_inputs(12)
    cfg = dr_head_cfg()
    tcfg = cfg["TARGET_CONFIG"]
    coder = box_coder_utils.build_box_coder(tcfg["BOX_CODER"],
                                            **tcfg["BOX_CODER_CONFIG"])
    cls_l, reg_l, box_l = box_head.assign_point_targets(
        T(pts), T(valid), T(gt), extra_width=tcfg["GT_EXTRA_WIDTH"],
        box_coder=coder, encode_dims=7)
    rot_cls, rot_reg = dr_head.assign_rot_targets(T(pts), T(valid), T(gt))
    b, n = pts.shape[:2]
    preds = {"point_cls_preds": rng.randn(b, n, 1),
             "point_reg_preds": rng.randn(b, n, 8) * 0.5,
             "point_rot_cls_preds": rng.randn(b, n, 2),
             "point_rot_reg_preds": rng.randn(b, n, 3)}
    preds = {k: v.astype(np.float32) for k, v in preds.items()}
    labels = {"point_cls_labels": cls_l, "point_reg_labels": reg_l,
              "point_box_labels": box_l, "point_rot_cls_labels": rot_cls,
              "point_rot_reg_labels": rot_reg}
    jcoder = jax_coders.build_box_coder(tcfg["BOX_CODER"],
                                        **tcfg["BOX_CODER_CONFIG"])

    def jax_loss(p):
        d = {**p, **{k: jnp.asarray(v.numpy()) for k, v in labels.items()}}
        loss, tb = jax_dr_head.point_head_box6d_loss(d, cfg, 1, jcoder)
        return loss, tb

    (_, ref_tb), ref_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        {k: jnp.asarray(v) for k, v in preds.items()})
    tp = {k: T(v).requires_grad_() for k, v in preds.items()}
    loss, tb = dr_head.point_head_box6d_loss({**tp, **labels}, cfg, 1, coder)
    loss.backward()
    assert set(tb) == set(ref_tb) == {
        "point_loss_cls", "point_loss_box", "point_loss_rot_reg",
        "point_loss_rot_cls"}
    for k in tb:
        np.testing.assert_allclose(float(tb[k]), float(ref_tb[k]), rtol=1e-5,
                                   err_msg=k)
        assert float(ref_tb[k]) > 0
    for k, g in ref_g.items():
        tpt.leaf_close(tp[k].grad.numpy(), np.asarray(g), 1e-5, k)


# ---------------------------------------------------------------------
# tiny models
# ---------------------------------------------------------------------

def tiny_dr_cfg():
    """The JAX package's tiny Det6D backbone under ``det6d_dr_car.yaml``'s
    head, 32 wide."""
    cfg = copy.deepcopy(dict(tiny_det6d_cfg()))
    cfg["POINT_HEAD"] = dr_head_cfg(32)
    return cfg


def tiny_pitch_cfg():
    """The tiny Det6D with ``det6d_pitch_car.yaml``'s coder: the pitch
    regressed directly (``ground_aware: False``)."""
    cfg = copy.deepcopy(dict(tiny_det6d_cfg()))
    cfg["POINT_HEAD"]["TARGET_CONFIG"]["BOX_CODER_CONFIG"][
        "ground_aware"] = False
    return cfg


def tiny_pair(cfg):
    jmodel = jax_build(Config(copy.deepcopy(cfg)), num_class=1,
                       dataset=JaxSpec(**SPEC))
    tmodel = build_network(Config(copy.deepcopy(cfg)), 1, DatasetSpec(**SPEC),
                           device="cpu")
    return jmodel, tmodel


def test_tiny_dr_eval_matches_jax():
    """A tiny D.R. model in eval: picks identical, counts and labels
    equal, 9-column boxes (pitch zeroed where the slope class says flat)
    and scores within 1e-4 (``chip_smoke.check_det6d_parity``)."""
    from chip_smoke import check_det6d_parity

    jmodel, tmodel = tiny_pair(tiny_dr_cfg())
    pts, mask = scene(4, 2, 512, (0.0, -16.0, -2.0, 32.0, 16.0, 2.0))
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0),
        {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)})
    flat = perturb(flatten_variables(init), seed=6)
    weights.load_into(tmodel, flat)
    post_cfg = tiny_dr_cfg()["POST_PROCESSING"]
    ref = run_jax(jmodel, unflatten(flat), post_cfg, 1, pts, mask)
    out, post = run_torch(tmodel, post_cfg, 1, pts, mask)
    assert ref["pred_count"].min() > 0, "test needs detections"
    res = check_det6d_parity(out, post, ref, tol=1e-4)
    assert res["partings"] == []
    assert post["pred_boxes"].shape[-1] == 9
    # the pitch is zeroed exactly where the slope class says flat
    pitch = out["batch_box_preds"][..., 7]
    flat = out["point_rot_cls_preds"].argmax(dim=-1) == 0
    assert bool((pitch[flat] == 0).all()) and bool((pitch[~flat] != 0).all())
    assert bool(flat.any()) and bool((~flat).any())


DR_TARGETS = ("point_cls_labels", "point_reg_labels", "point_box_labels",
              "point_rot_cls_labels", "point_rot_reg_labels")
PITCH_TARGETS = ("vote_cls_labels", "vote_reg_labels", "point_cls_labels",
                 "point_reg_labels", "point_box_labels")


def run_pair(cfg, targets, seed, steps):
    jmodel, tmodel = tiny_pair(cfg)
    batch = scene_batch(16)
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    flat = perturb(flatten_variables(init), seed=seed)
    for k in flat:  # votes near their candidates (the vote head)
        if "vote_layers/Dense_1" in k:
            flat[k] = flat[k] * 0.01
    opt_cfg = tpt.opt_cfg_of(DR_CFG)
    ref = tpt.jax_train_reference(jmodel, unflatten(flat), batch, opt_cfg,
                                  targets, steps)
    got = tpt.port_train_run(tmodel, flat, batch, opt_cfg, ref, targets,
                             steps)
    return {"ref": ref, "got": got, "tmodel": tmodel, "flat": flat,
            "batch": batch, "opt_cfg": opt_cfg}


@pytest.fixture(scope="module")
def tiny_dr_train():
    return run_pair(tiny_dr_cfg(), DR_TARGETS, 5, 3)


def test_dr_train_step_picks_and_targets(tiny_dr_train):
    """Picks equal the reference's (or a certified near-tie); class,
    slope and box labels identical, code targets within 1e-6, rotation
    targets within ``ROT_TOL``."""
    tpt.certify_calls("tiny det6d_dr", tiny_dr_train, 0.0)
    ref = tiny_dr_train["ref"]["targets"]
    got = tiny_dr_train["got"]["targets"]
    for k in ("point_cls_labels", "point_box_labels",
              "point_rot_cls_labels"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    np.testing.assert_allclose(got["point_reg_labels"],
                               ref["point_reg_labels"], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got["point_rot_reg_labels"],
                               ref["point_rot_reg_labels"], atol=ROT_TOL)
    assert (ref["point_cls_labels"] > 0).sum() >= 4
    assert (ref["point_rot_cls_labels"] == 1).any()


def test_dr_train_step_losses_gradients_and_statistics(tiny_dr_train):
    tpt.check_metrics(tiny_dr_train)
    assert {"point_loss_rot_reg", "point_loss_rot_cls",
            "grad_norm"} <= set(tiny_dr_train["ref"]["metrics"])
    tpt.check_gradients(tiny_dr_train)
    tpt.check_batch_stats(tiny_dr_train)


def test_dr_train_step_params_after_three_steps(tiny_dr_train):
    tpt.check_three_steps(tiny_dr_train)


@pytest.fixture(scope="module")
def tiny_pitch_train():
    return run_pair(tiny_pitch_cfg(), PITCH_TARGETS, 5, 0)


def test_pitch_variant_train_step_equals_jax(tiny_pitch_train):
    """``det6d_pitch_car.yaml``'s coder (the pitch a regressed column, no
    pitch class): labels identical, targets within 1e-6, loss terms and
    BatchNorm statistics at the D.R. step's tolerances. Its gradient norm
    is ~200 (the raw pitch column's box loss), and both fp32 gradients lie
    up to ~1e-4 of a leaf's largest entry from the float64 step: each leaf
    is held to 1e-4 or twice that distance (``check_gradients_against_f64``)."""
    pair = tiny_pitch_train
    tpt.certify_calls("tiny det6d_pitch", pair, 0.0)
    ref, got = pair["ref"]["targets"], pair["got"]["targets"]
    for k in ("vote_cls_labels", "point_cls_labels", "point_box_labels"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    assert ref["point_reg_labels"].shape[-1] == 31
    for k in ("vote_reg_labels", "point_reg_labels"):
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert (ref["point_cls_labels"] > 0).sum() >= 4
    tpt.check_metrics(pair)
    tpt.check_gradients_against_f64(pair)
    tpt.check_batch_stats(pair)


# ---------------------------------------------------------------------
# full-width references for the card (which has no JAX)
# ---------------------------------------------------------------------

FIXTURE = ROOT / "de6d_tpu_torch/testdata/det6d_dr_jax_ref.npz"
TRAIN_FIXTURE = ROOT / "de6d_tpu_torch/testdata/det6d_dr_train_jax_ref.npz"


def full_jax_model():
    """``det6d_dr_car.yaml``'s model in the JAX package, fp32."""
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg
    from chip_smoke import spec_from_cfg

    cfg = jax_cfg(str(DR_CFG))
    mc = copy.deepcopy(dict(cfg.MODEL))
    mc["COMPUTE_DTYPE"] = "float32"
    spec = spec_from_cfg(cfg_from_yaml_file(DR_CFG))
    return jax_build(mc, num_class=1, dataset=JaxSpec(
        class_names=spec.class_names, point_feature_dim=4,
        point_cloud_range=spec.point_cloud_range)), mc


def jax_reference():
    """The JAX D.R. model in fp32 with ``weights.seeded_flax`` weights
    (``chip_smoke.DET6D_DR_SEED``; the repository has no trained D.R.
    weights) on the first 2 Det6D scans (``chip_smoke.load_det6d_dr_scans``) →
    detections, per-layer picks and the s-fps logits."""
    from chip_smoke import DET6D_DR_SEED, build_model, load_det6d_dr_scans

    jmodel, mc = full_jax_model()
    tmodel = build_model("float32", "cpu", DR_CFG, DET6D_DR_SEED)[0]
    flat = weights.torch_to_flax(tmodel)
    pts, mask = load_det6d_dr_scans()
    return run_jax(jmodel, unflatten(flat), mc["POST_PROCESSING"], 1,
                   pts[:2], mask[:2])


def write_fixture():
    """Rewrite ``testdata/det6d_dr_jax_ref.npz`` with ``python -c "import
    sys; sys.path.insert(0, 'tests'); import jax;
    jax.config.update('jax_platforms', 'cpu'); import test_torch_det6d_dr
    as t; t.write_fixture()"`` (~30 s)."""
    np.savez_compressed(FIXTURE, **jax_reference())


def test_fixture_holds_what_the_card_reads():
    with np.load(FIXTURE) as ref:
        assert [ref[f"picks_{k}"].shape for k in range(3)] == [
            (2, 4096), (2, 1024), (2, 512)]
        assert ref["pred_boxes"].shape == (2, 500, 9)
        assert ref["pred_count"].min() > 0


@pytest.mark.slow
def test_fixture_equals_fresh_jax_run():
    ref = jax_reference()
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_dr_matches_fixture_on_cpu():
    """The ``parity / det6d_dr`` phase of chip_smoke.py on the CPU."""
    from chip_smoke import DET6D_DR_PARITY, det6d_parity_run

    res = det6d_parity_run("cpu", **DET6D_DR_PARITY)
    assert res["picks_differing"][0] == 0


def train_fixture_content():
    """The JAX fp32 D.R. step from flax's initialisers
    (``chip_smoke.point_train_model``) on the Det6D train fixture's batch
    of 2 (``det6d_train_jax_ref.npz``: the JAX loader's, SlopeAug on):
    every sampling call's picks and scores, targets, loss terms, gradient
    norm, gradients and BatchNorm statistics after it in the port's
    layout."""
    from chip_smoke import DET6D_DR_TRAIN, point_train_model
    from test_torch_pointpillar_train import store_leaves

    tmodel = point_train_model("cpu", DET6D_DR_TRAIN)
    flat = weights.torch_to_flax(tmodel)
    jmodel, _ = full_jax_model()
    with np.load(ROOT / "de6d_tpu_torch/testdata/det6d_train_jax_ref.npz") \
            as det6d:
        batch = {k: det6d[k] for k in ("points", "points_mask", "gt_boxes")}
    ref = tpt.jax_step_reference(jmodel, unflatten(flat), batch,
                                 DET6D_DR_TRAIN.targets)
    return point_fixture(batch, ref, flat, tmodel, store_leaves)


def point_fixture(batch, ref, flat, tmodel, store_leaves):
    out = dict(batch)
    for k, p in enumerate(ref["picks"]):
        out[f"picks_{k}"] = p
        if ref["scores"][k] is not None:
            out[f"scores_{k}"] = ref["scores"][k]
    for k, v in ref["targets"].items():
        if isinstance(v, list):
            for i, x in enumerate(v):
                if x is not None:
                    out[f"target/{k}_{i}"] = x
        else:
            out[f"target/{k}"] = v
    for k, v in ref["metrics"].items():
        out[f"metric/{k}"] = np.float32(v)
    store_leaves(out, "grad", weights.flax_params_to_torch(ref["grads"],
                                                           tmodel))
    stats = weights.flax_to_torch({**flat, **ref["batch_stats"]}, tmodel)
    for name, v in stats.items():
        if "running" in name:
            out[f"stats/{name}"] = v.numpy()
    return out


def write_train_fixture():
    """Rewrite ``testdata/det6d_dr_train_jax_ref.npz`` with ``python -c
    "import sys; sys.path.insert(0, 'tests'); import jax;
    jax.config.update('jax_platforms', 'cpu'); import test_torch_det6d_dr
    as t; t.write_train_fixture()"`` (~1 min)."""
    np.savez_compressed(TRAIN_FIXTURE, **train_fixture_content())


def test_train_fixture_holds_what_the_card_reads():
    with np.load(TRAIN_FIXTURE) as ref:
        assert ref["points"].shape == (2, 16384, 4)
        assert [ref[f"picks_{k}"].shape[1] for k in range(3)] == [4096,
                                                                  1024, 512]
        assert (ref["target/point_cls_labels"] > 0).sum() > 0
        assert (ref["target/point_rot_cls_labels"] == 1).sum() > 0
        assert "metric/point_loss_rot_reg" in ref.files
    assert TRAIN_FIXTURE.stat().st_size <= (
        ROOT / "de6d_tpu_torch/testdata/det6d_train_jax_ref.npz").stat(
            ).st_size


@pytest.mark.slow
def test_train_fixture_equals_fresh_jax_run():
    ref = train_fixture_content()
    with np.load(TRAIN_FIXTURE) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in stored.files:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_train_step_matches_fixture_on_cpu():
    """The ``parity / train_det6d_dr`` phase of chip_smoke.py
    (``check_point_train_parity``) on the CPU."""
    from chip_smoke import DET6D_DR_TRAIN, check_point_train_parity

    r = check_point_train_parity("cpu", DET6D_DR_TRAIN, measure_f64=False)
    assert r["positives"] > 0


@pytest.mark.slow
def test_full_width_train_step_against_float64(capsys):
    """What ``chip_smoke.DET6D_DR_TRAIN.f64`` holds: the fixture's step
    evaluated by the port in float64 (the reference's picks) against the
    JAX fp32 step (its stored entries) and the port's fp32 step (every
    entry). Prints both; both must lie within the stored distances."""
    from chip_smoke import DET6D_DR_TRAIN

    print_f64_distances(DET6D_DR_TRAIN, capsys)


def print_f64_distances(spec, capsys):
    from chip_smoke import f64_distances, point_train_gradients

    ref = dict(np.load(spec.ref))
    g32, m32 = point_train_gradients("cpu", spec, ref, torch.float32)
    g64, m64 = point_train_gradients("cpu", spec, ref, torch.float64)
    jax_g32 = {}
    for name, t in g64.items():
        if f"grad/{name}" in ref:
            jax_g32[name] = (ref[f"grad/{name}"], t)
        else:
            idx = np.linspace(0, t.size - 1,
                              ref[f"grad_sample/{name}"].size).astype(
                                  np.int64)
            jax_g32[name] = (ref[f"grad_sample/{name}"], t[idx])
    jax_err = max(float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
                  for a, b in jax_g32.values())
    port = f64_distances(g32, m32, g64, m64)
    m_jax = {k: float(ref[f"metric/{k}"]) for k in m64}
    loss_jax = max(abs(m_jax[k] / v - 1) for k, v in m64.items() if v != 0)
    n64 = np.sqrt(sum(float((x ** 2).sum()) for x in g64.values()))
    norm_jax = abs(float(ref["metric/grad_norm"]) / n64 - 1)
    with capsys.disabled():
        print(f"\n{spec.name} full-width step vs float64: gradients, largest "
              f"distance / leaf max: JAX fp32 {jax_err:.3g}, port fp32 "
              f"{port['grad']:.3g}; loss terms, relative: JAX fp32 "
              f"{loss_jax:.3g}, port fp32 {port['loss']:.3g}; gradient "
              f"norm, relative: JAX fp32 {norm_jax:.3g}, port fp32 "
              f"{port['grad_norm']:.3g}")
    for k, j in {"grad": jax_err, "loss": loss_jax,
                 "grad_norm": norm_jax}.items():
        assert max(j, port[k]) <= spec.f64[k] * 1.01, k
