"""PV-RCNN training: the PyTorch port against the JAX package on the CPU.

Module by module: ``utils/jax_random`` against ``jax.random`` (bit for
bit); ``assign_roi_targets`` (the RoIs JAX's draws pick),
``canonical_transform_targets`` and ``roi_head_loss`` with its gradients;
``assign_point_targets``; the anchor head's train-mode decode of every
anchor; the cotangents the voxel set abstraction sends into the BEV map
and each ``x_conv*`` stage in train mode, against ``jax.vjp``; whole train
steps of the tiny PV-RCNN of ``tests/test_pvrcnn_e2e.py`` and 3 Adam
steps; ``tools/train.py`` and ``tools/test.py`` on a tiny PV-RCNN config.

Tolerances, each with its reason:
- keys, draws, picks, labels and masks are exact;
- the sampler's class targets: :data:`CLS_TARGET_TOL`. They are the 3D
  IoU scaled by 2, and JAX's fp32 IoU lies up to :data:`JAX_IOU_F64` from
  the float64 IoU at the test boxes' 60 m (the port's within 1e-6:
  :func:`test_iou_round_off_against_float64`); targets from a rotation:
  1e-6 (another fp32 rounding of cos or sin);
- the modules' outputs and gradients: 1e-5 of the largest |entry| (sums
  in another order);
- the tiny train step: :data:`TINY_TOL`, twice :data:`TINY_F64`, how far
  an fp32 step lies from the float64 step of the same decisions
  (:func:`test_tiny_step_float64_bounds` measures both packages' fp32
  steps against it).

Where a RoI overlaps no gt box, JAX's IoU leaves round-off (up to 1.6e-6
at 60 m) where the port's is exactly 0, so the gt box of the largest
round-off is its match. No target that a loss reads depends on that
match (its class label is 0 and it is not regressed), so ``gt_of_rois``
is compared where a RoI's best IoU exceeds :data:`JAX_IOU_F64`.

The reference for the cotangents of the voxel set abstraction is JAX's
eager VJP: on the CPU, a separately jitted VJP of JAX's SA layer in train
mode parts from its eager VJP and from central differences of its own
jitted forward (:func:`test_sa_layer_cotangent_equals_eager_jax`). The
jitted train step of the tiny PV-RCNN does not part.

The full-width reference for the card (:func:`write_fixture`) is held on
the CPU in the slow tier.
"""

import contextlib
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
from de6d_tpu.models.backbones_3d.pfe import voxel_set_abstraction as jax_vsa
from de6d_tpu.models.dense_heads import point_head_box as jax_point_head
from de6d_tpu.models.dense_heads.anchor_head import (
    AnchorHeadSingle as JaxAnchorHead,
)
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.models.roi_heads import roi_head_utils as jax_roi_utils
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.backbones_3d.pfe import voxel_set_abstraction
from de6d_tpu_torch.models.dense_heads.anchor_head import AnchorHeadSingle
from de6d_tpu_torch.models.dense_heads.point_head_box import (
    assign_point_targets,
)
from de6d_tpu_torch.models.detectors.detector3d_template import DatasetSpec
from de6d_tpu_torch.models.roi_heads import roi_head_utils
from de6d_tpu_torch.utils import jax_random
from test_torch_pvrcnn import (
    STRIDES, VS, tiny_pvrcnn_cfg, vsa_cfg, vsa_inputs,
)
from test_torch_pvrcnn import PC as FULL_PC
from test_torch_second import TINY_SPEC, scene, tiny_second_cfg
from torch_fixtures import flatten_variables, perturb, unflatten

ROOT = Path(__file__).resolve().parents[1]
PVRCNN_CFG = ROOT / "configs/kitti_models/pv_rcnn.yaml"
KITTI = ROOT / "data/kitti"
FIXTURE = ROOT / "de6d_tpu_torch/testdata/pvrcnn_train_jax_ref.npz"
T = torch.from_numpy
OP_TOL = 1e-5
ROT_TOL = 1e-6
PORT_IOU_F64 = 1e-6
JAX_IOU_F64 = 1e-4
CLS_TARGET_TOL = (JAX_IOU_F64 + PORT_IOU_F64) / (0.75 - 0.25)
TARGET_KEYS = ("rois", "gt_of_rois", "rcnn_cls_labels", "reg_valid_mask",
               "roi_labels", "roi_sample_valid")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and ops on
    tensors above PyTorch's grain otherwise wait on OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_key(seed):
    return jax.random.PRNGKey(seed)


# ---------------------------------------------------------------------
# jax_random
# ---------------------------------------------------------------------

SEEDS = [0, 1, 2 ** 31 + 12345]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [1, 512, 4096])
def test_split_and_uniform_are_jax_bits(seed, n):
    """``PRNGKey(seed)``, ``split(key, n)``, ``split`` of every split key
    again (nested, as a vmapped split runs it), and ``uniform(key, (n,))``,
    bit for bit."""
    key = jax_key(seed)
    tkey = jax_random.prng_key(seed)
    np.testing.assert_array_equal(tkey.numpy(), np.asarray(key, np.int64))
    keys = jax.random.split(key, n)
    tkeys = jax_random.split(tkey, n)
    np.testing.assert_array_equal(tkeys.numpy(), np.asarray(keys, np.int64))
    nested = jax.vmap(jax.random.split)(keys[:64])
    np.testing.assert_array_equal(jax_random.split(tkeys[:64]).numpy(),
                                  np.asarray(nested, np.int64))
    got = jax_random.uniform(tkey, n).numpy()
    want = np.asarray(jax.random.uniform(key, (n,)))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert 0.0 <= got.min() and got.max() < 1.0


def test_random_keys_and_shapes_are_jax_bits():
    """Keys of random words (every bit position used) and a 2-D shape."""
    rng = np.random.RandomState(0)
    words = rng.randint(0, 2 ** 32, (6, 2), dtype=np.uint64).astype(np.uint32)
    for k in words:
        key = jnp.asarray(k)
        tkey = T(k.astype(np.int64))
        np.testing.assert_array_equal(
            jax_random.split(tkey, 3).numpy(),
            np.asarray(jax.random.split(key, 3), np.int64))
        got = jax_random.uniform(tkey, (4, 33)).numpy()
        want = np.asarray(jax.random.uniform(key, (4, 33)))
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))


def test_sampler_draws_are_the_jax_sampler_draws():
    """The draws of ``assign_roi_targets``: ``split(PRNGKey(0), B)``, then
    each key split into the foreground's and the background's keys and
    ``uniform`` of 512 each, under ``jax.vmap`` and ``jax.jit`` as the JAX
    sampler draws them."""
    def draws(key):
        g1, g2 = jax.random.split(key)
        return jax.random.uniform(g1, (512,)), jax.random.uniform(g2, (512,))

    want = jax.jit(jax.vmap(draws))(jax.random.split(jax_key(0), 2))
    g = jax_random.split(jax_random.split(jax_random.prng_key(0), 2), 2)
    for i, w in enumerate(want):
        got = jax_random.uniform(g[:, i], 512).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      np.asarray(w).view(np.int32))


# ---------------------------------------------------------------------
# assign_roi_targets
# ---------------------------------------------------------------------

ROI_CASES = ["many_fg", "few_fg", "no_fg", "no_valid_roi", "class_mismatch",
             "padded_gts", "tied_bg"]


def roi_case(kind, seed=0, r=512, m=6):
    """(rois (2, R, 7), roi_valid, roi_labels (1-based), gt_boxes (2, M, 8))
    for one case of :data:`ROI_CASES`; RoIs are jittered copies of the gt
    boxes (foreground when close) or boxes elsewhere."""
    rng = np.random.RandomState(seed + ROI_CASES.index(kind))
    gt = np.zeros((2, m, 8), np.float32)
    gt[..., 0] = rng.uniform(2, 60, (2, m))
    gt[..., 1] = rng.uniform(-30, 30, (2, m))
    gt[..., 2] = rng.uniform(-1.5, -0.5, (2, m))
    gt[..., 3:6] = rng.uniform([3.2, 1.4, 1.4], [4.5, 1.9, 1.7], (2, m, 3))
    gt[..., 6] = rng.uniform(-np.pi, np.pi, (2, m))
    gt[..., 7] = rng.randint(1, 4, (2, m))
    rois = np.zeros((2, r, 7), np.float32)
    near = {"many_fg": 0.6, "few_fg": 0.05, "no_fg": 0.0,
            "no_valid_roi": 0.5, "class_mismatch": 0.6, "padded_gts": 0.5,
            "tied_bg": 0.9}[kind]
    src = rng.randint(0, m, (2, r))
    on_gt = rng.random_sample((2, r)) < near
    jitter = np.concatenate([rng.normal(0, 0.15, (2, r, 3)),
                             rng.normal(0, 0.1, (2, r, 3)),
                             rng.normal(0, 0.1, (2, r, 1))], -1)
    elsewhere = np.concatenate([rng.uniform(0, 70, (2, r, 1)),
                                rng.uniform(-40, 40, (2, r, 1)),
                                rng.uniform(-2, 0, (2, r, 1)),
                                rng.uniform(0.5, 4, (2, r, 3)),
                                rng.uniform(-np.pi, np.pi, (2, r, 1))], -1)
    picked = np.take_along_axis(gt[..., :7], src[..., None], axis=1)
    rois[:] = np.where(on_gt[..., None], picked + jitter, elsewhere)
    rois[..., 3:6] = np.abs(rois[..., 3:6]) + 0.1
    labels = np.where(on_gt, np.take_along_axis(gt[..., 7], src, axis=1),
                      rng.randint(1, 4, (2, r))).astype(np.int32)
    valid = np.ones((2, r), bool)
    valid[1, r - 100:] = False  # a ragged proposal count
    if kind == "no_valid_roi":
        valid[0] = False
    if kind == "class_mismatch":
        labels[0] = labels[0] % 3 + 1  # no RoI of sample 0 has its class
    if kind == "padded_gts":
        gt[0, 3:] = 0.0
        gt[1, 1:] = 0.0
    if kind == "tied_bg":  # fewer than 64 background RoIs
        valid[:, 200:] = False
    rois[~valid] = 0.0
    labels[~valid] = 0
    return rois, valid, labels, gt


@functools.lru_cache(maxsize=None)
def jitted_assign(roi_per_image, fg_ratio, fg_thresh):
    return jax.jit(lambda a, b, c, d, k: jax_roi_utils.assign_roi_targets(
        a, b, c, d, k, roi_per_image=roi_per_image, fg_ratio=fg_ratio,
        fg_thresh=fg_thresh))


def jax_assign(rois, valid, labels, gt, key=None, roi_per_image=128,
               fg_ratio=0.5, fg_thresh=0.55):
    out = jitted_assign(roi_per_image, fg_ratio, fg_thresh)(
        jnp.asarray(rois), jnp.asarray(valid), jnp.asarray(labels),
        jnp.asarray(gt), jax_key(0) if key is None else key)
    return {k: np.asarray(v) for k, v in out.items()}


@jax.jit
def _jax_best_iou(r, lab, g):
    from de6d_tpu.ops import iou3d as jax_iou3d

    iou = jax.vmap(jax_iou3d.boxes_iou3d)(r[..., :7], g[..., :7])
    same = lab[..., None] == g[..., None, :, 7].astype(jnp.int32)
    ok = same & jnp.any(jnp.abs(g[..., None, :, :7]) > 0, axis=-1)
    return jnp.max(jnp.where(ok, iou, -1.0), axis=-1)


def jax_max_iou(rois, labels, gt):
    """The JAX sampler's class-aware best IoU of each RoI, as the targets
    read it."""
    return np.asarray(_jax_best_iou(jnp.asarray(rois), jnp.asarray(labels),
                                    jnp.asarray(gt)))


def assert_targets_equal(got, ref, best_iou, box_tol=0.0,
                         cls_tol=CLS_TARGET_TOL, what=""):
    """Labels and masks exact; the RoI boxes within ``box_tol`` and the
    class targets within ``cls_tol``; the matched gt boxes where the RoI
    overlaps one by more than JAX's round-off (:data:`JAX_IOU_F64`)."""
    for k in ("reg_valid_mask", "roi_labels", "roi_sample_valid"):
        np.testing.assert_array_equal(np.asarray(got[k]), ref[k],
                                      err_msg=what + k)
    np.testing.assert_allclose(np.asarray(got["rois"]), ref["rois"],
                               rtol=box_tol, atol=box_tol,
                               err_msg=what + "rois")
    np.testing.assert_allclose(np.asarray(got["rcnn_cls_labels"]),
                               ref["rcnn_cls_labels"], rtol=0, atol=cls_tol,
                               err_msg=what + "rcnn_cls_labels")
    overlaps = best_iou > JAX_IOU_F64
    np.testing.assert_array_equal(np.asarray(got["gt_of_rois"])[overlaps],
                                  ref["gt_of_rois"][overlaps],
                                  err_msg=what + "gt_of_rois")


@pytest.mark.parametrize("kind", ROI_CASES)
def test_assign_roi_targets_equals_jax(kind):
    """The sampled RoIs (by their index: the port's ``roi_sample_idx``
    gathers JAX's RoI boxes bit for bit), labels and masks exact, the
    IoU-interpolated class targets within :data:`CLS_TARGET_TOL`, in every
    case: more than
    64 foreground RoIs a sample, fewer, none, no valid RoI, no RoI of a
    gt box's class, padded gt boxes, fewer than 64 background RoIs (the
    -1e9 keys tie; the lower index wins, and a RoI may fill a slot of
    each kind)."""
    rois, valid, labels, gt = roi_case(kind)
    ref = jax_assign(rois, valid, labels, gt)
    got = roi_head_utils.assign_roi_targets(T(rois), T(valid), T(labels),
                                            T(gt))
    sel = got["roi_sample_idx"].numpy()
    np.testing.assert_array_equal(np.take_along_axis(
        rois, sel[..., None], axis=1), ref["rois"])
    best = np.take_along_axis(jax_max_iou(rois, labels, gt), sel, axis=1)
    assert_targets_equal({k: v.numpy() for k, v in got.items()}, ref,
                         np.where(ref["roi_sample_valid"], best, 0.0))
    n_fg = ref["roi_sample_valid"][:, :64].sum(-1)
    n_bg = ref["roi_sample_valid"][:, 64:].sum(-1)
    expect = {"many_fg": lambda: (n_fg == 64).all(),
              "few_fg": lambda: (0 < n_fg).all() and (n_fg < 64).all(),
              "no_fg": lambda: (n_fg == 0).all(),
              "no_valid_roi": lambda: n_fg[0] + n_bg[0] == 0 < n_bg[1],
              "class_mismatch": lambda: n_fg[0] == 0 < n_fg[1],
              "padded_gts": lambda: (n_fg > 0).all(),
              "tied_bg": lambda: (n_bg < 64).all() and (
                  np.sort(sel, -1)[:, :-1] == np.sort(sel, -1)[:, 1:]).any()}
    assert expect[kind](), (kind, n_fg, n_bg)


def test_assign_roi_targets_other_key_and_sizes():
    """Another key (``PRNGKey(7)``), 32 RoIs of 96 proposals and a
    foreground share of 0.25, as a config may set them."""
    rois, valid, labels, gt = roi_case("few_fg", r=96)
    kw = dict(roi_per_image=32, fg_ratio=0.25, fg_thresh=0.6)
    ref = jax_assign(rois, valid, labels, gt, key=jax_key(7), **kw)
    got = roi_head_utils.assign_roi_targets(
        T(rois), T(valid), T(labels), T(gt), key=jax_random.prng_key(7),
        **kw)
    sel = got["roi_sample_idx"].numpy()
    best = np.take_along_axis(jax_max_iou(rois, labels, gt), sel, axis=1)
    assert_targets_equal({k: v.numpy() for k, v in got.items()}, ref,
                         np.where(ref["roi_sample_valid"], best, 0.0))
    assert sel.shape == (2, 32)


def test_iou_round_off_against_float64():
    """Where :data:`CLS_TARGET_TOL` comes from: on every case's RoIs and
    gt boxes, JAX's jitted fp32 3D IoU within :data:`JAX_IOU_F64` of the
    float64 IoU (the port's function on float64 boxes), the port's fp32
    IoU within :data:`PORT_IOU_F64`."""
    from de6d_tpu.ops import iou3d as jax_iou3d
    from de6d_tpu_torch.ops import iou3d

    fn = jax.jit(jax.vmap(jax_iou3d.boxes_iou3d))
    worst = {"jax": 0.0, "port": 0.0}
    for kind in ROI_CASES:
        rois, _, _, gt = roi_case(kind)
        f64 = iou3d.boxes_iou3d(T(rois).double(), T(gt[..., :7]).double())
        port = iou3d.boxes_iou3d(T(rois), T(gt[..., :7]))
        jx = np.asarray(fn(jnp.asarray(rois), jnp.asarray(gt[..., :7])))
        worst["jax"] = max(worst["jax"], float(np.abs(jx - f64.numpy()).max()))
        worst["port"] = max(worst["port"],
                            float((port.double() - f64).abs().max()))
    assert worst["jax"] <= JAX_IOU_F64 and worst["port"] <= PORT_IOU_F64
    assert worst["jax"] > 10 * worst["port"]


# ---------------------------------------------------------------------
# canonical targets and the RoI head's loss
# ---------------------------------------------------------------------

def loss_case(seed=3):
    """A sampled-RoI dict: the targets of :func:`roi_case` ``few_fg`` and
    random predictions."""
    rois, valid, labels, gt = roi_case("few_fg", seed=seed)
    ref = jax_assign(rois, valid, labels, gt)
    rng = np.random.RandomState(seed)
    ref["rcnn_cls"] = rng.normal(0, 1, (2, 128)).astype(np.float32)
    ref["rcnn_reg"] = rng.normal(0, 0.3, (2, 128, 7)).astype(np.float32)
    return ref


def test_canonical_transform_targets_equals_jax():
    ref = loss_case()
    want = np.asarray(jax.jit(jax_roi_utils.canonical_transform_targets)(
        jnp.asarray(ref["rois"]), jnp.asarray(ref["gt_of_rois"][..., :7])))
    got = roi_head_utils.canonical_transform_targets(
        T(ref["rois"]), T(ref["gt_of_rois"][..., :7])).numpy()
    assert got.shape == (2, 128, 7)
    np.testing.assert_allclose(got, want, rtol=ROT_TOL, atol=ROT_TOL)


@pytest.mark.parametrize("corner", [True, False], ids=["corner", "no_corner"])
def test_roi_head_loss_and_its_gradients_equal_jax(corner):
    """The loss terms within 1e-6 relative and their gradients in
    ``rcnn_cls`` and ``rcnn_reg`` within 1e-5 of the largest, with and
    without the corner loss."""
    ref = loss_case()
    ref["gt_of_rois_local"] = np.asarray(
        jax_roi_utils.canonical_transform_targets(
            jnp.asarray(ref["rois"]), jnp.asarray(ref["gt_of_rois"][..., :7])))
    cfg = {"CORNER_LOSS_REGULARIZATION": corner,
           "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.3,
                            "rcnn_corner_weight": 0.7,
                            "code_weights": [1.0] * 6 + [0.5]}}

    def jloss(cls, reg):
        d = {k: jnp.asarray(v) for k, v in ref.items()}
        d.update(rcnn_cls=cls, rcnn_reg=reg)
        return jax_roi_utils.roi_head_loss(d, cfg)

    (want, jtb), jgrads = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        jnp.asarray(ref["rcnn_cls"]), jnp.asarray(ref["rcnn_reg"]))
    d = {k: T(v) for k, v in ref.items()}
    cls = d["rcnn_cls"].requires_grad_(True)
    reg = d["rcnn_reg"].requires_grad_(True)
    got, tb = roi_head_utils.roi_head_loss(d, cfg)
    got.backward()
    assert set(tb) == set(jtb)
    assert ("rcnn_loss_corner" in tb) == corner
    assert ref["reg_valid_mask"].sum() > 0
    for k in tb:
        np.testing.assert_allclose(float(tb[k]), float(jtb[k]), rtol=1e-6,
                                   err_msg=k)
    for g, w in ((cls.grad, jgrads[0]), (reg.grad, jgrads[1])):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=OP_TOL * np.abs(w).max())


def test_roi_head_loss_survives_codes_that_overflow_unregressed():
    """A RoI that is not regressed, with box codes that overflow the
    decode's ``exp``: JAX's corner loss multiplies its inf by 0 and turns
    NaN; the port's loss and gradients are finite and equal JAX's on the
    same input with that RoI's codes at zero (which no term reads)."""
    ref = loss_case()
    ref["gt_of_rois_local"] = np.asarray(
        jax_roi_utils.canonical_transform_targets(
            jnp.asarray(ref["rois"]), jnp.asarray(ref["gt_of_rois"][..., :7])))
    cfg = {"CORNER_LOSS_REGULARIZATION": True,
           "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                            "rcnn_corner_weight": 1.0,
                            "code_weights": [1.0] * 7}}
    b, i = np.argwhere(~ref["reg_valid_mask"])[0]
    big = ref["rcnn_reg"].copy()
    big[b, i, 3:6] = 200.0  # exp(200) overflows fp32
    zeroed = big.copy()
    zeroed[b, i] = 0.0

    def jloss(reg):
        d = {k: jnp.asarray(v) for k, v in ref.items()}
        d["rcnn_reg"] = reg
        return jax_roi_utils.roi_head_loss(d, cfg)[0]

    assert np.isnan(float(jloss(jnp.asarray(big))))
    want, want_g = jax.value_and_grad(jloss)(jnp.asarray(zeroed))
    d = {k: T(v) for k, v in ref.items()}
    d["rcnn_reg"] = T(big).requires_grad_(True)
    got, _ = roi_head_utils.roi_head_loss(d, cfg)
    got.backward()
    assert np.isfinite(float(got))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(d["rcnn_reg"].grad.numpy(),
                               np.asarray(want_g), rtol=0,
                               atol=OP_TOL * np.abs(want_g).max())


# ---------------------------------------------------------------------
# keypoint targets
# ---------------------------------------------------------------------

@pytest.mark.parametrize("extra", [(0.2, 0.2, 0.2), None],
                         ids=["ring", "no_ring"])
def test_assign_point_targets_equals_jax(extra):
    """Labels exact: points inside boxes, in the 0.2 m ring around them,
    on the faces, invalid points, padded gt boxes."""
    rng = np.random.RandomState(4)
    gt = np.zeros((2, 5, 8), np.float32)
    gt[:, :4, :3] = rng.uniform([2, -8, -1.5], [20, 8, -0.5], (2, 4, 3))
    gt[:, :4, 3:6] = rng.uniform([3.2, 1.4, 1.4], [4.5, 1.9, 1.7], (2, 4, 3))
    gt[:, :4, 6] = rng.uniform(-np.pi, np.pi, (2, 4))
    gt[:, :4, 7] = 1
    gt[1, 3] = 0.0
    n = 3000
    src = rng.randint(0, 4, (2, n))
    centre = np.take_along_axis(gt[..., :3], src[..., None], axis=1)
    pts = (centre + rng.uniform(-3, 3, (2, n, 3))).astype(np.float32)
    pts[:, :200] = rng.uniform([0, -10, -2], [22, 10, 0], (2, 200, 3))
    pts[:, 200:260, :] = gt[:, :1, :3]  # at a centre
    pts[:, 260:300, 2] = gt[:, :1, 2] + gt[:, :1, 5] / 2  # on a top face
    valid = rng.random_sample((2, n)) > 0.1
    ref = jax.jit(lambda p, v, g: jax_point_head.assign_point_targets(
        p, v, g, extra_width=extra))(jnp.asarray(pts), jnp.asarray(valid),
                                     jnp.asarray(gt))
    got = assign_point_targets(T(pts), T(valid), T(gt), extra_width=extra)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref[0]))
    labels = got.numpy()
    assert (labels == 1).sum() > 100 and (labels == 0).sum() > 100
    assert (labels == -1).sum() > (~valid).sum() or extra is None


# ---------------------------------------------------------------------
# the anchor head's train-mode decode
# ---------------------------------------------------------------------

def test_anchor_head_decodes_every_anchor_in_train_mode():
    """Before a RoI head the train-mode head writes, besides its raw
    predictions and targets, every anchor's class logits and decoded box,
    as the JAX head's train branch does; alone it decodes nothing."""
    rng = np.random.RandomState(3)
    cfg = copy.deepcopy(dict(tiny_second_cfg()["DENSE_HEAD"]))
    cfg["TARGET_ASSIGNER_CONFIG"]["WINDOWED_ASSIGN"] = False
    grid, pc = (128, 128, 40), TINY_SPEC["point_cloud_range"]
    x = rng.normal(0, 1, (2, 16, 16, 32)).astype(np.float32)
    gt = np.zeros((2, 3, 8), np.float32)
    gt[:, :2] = [[4.0, 0.5, -0.95, 3.9, 1.6, 1.56, 0.0, 1],
                 [8.0, 3.0, -0.95, 3.9, 1.6, 1.56, 1.57, 1]]
    jmod = JaxAnchorHead(model_cfg=cfg, num_class=1, class_names=("Car",),
                         grid_size=grid, point_cloud_range=pc,
                         predict_boxes_when_training=True)
    bd = {"spatial_features_2d": jnp.asarray(x), "gt_boxes": jnp.asarray(gt)}
    flat = perturb(flatten_variables(jmod.init(jax.random.PRNGKey(0),
                                               dict(bd))), 3)
    ref = jax.jit(lambda v, d: jmod.apply(v, d, train=True))(
        unflatten(flat), dict(bd))
    cfg.get("TARGET_ASSIGNER_CONFIG").pop("WINDOWED_ASSIGN")
    for full in (True, False):
        tmod = AnchorHeadSingle(cfg, 32, 1, ("Car",), grid, pc,
                                predict_boxes_when_training=full)
        weights.load_into(tmod, flat).train()
        got = tmod({"spatial_features_2d": T(x), "gt_boxes": T(gt)})
        assert ("batch_box_preds" in got) == full
        assert "lazy_box_decode" not in got
        np.testing.assert_array_equal(got["box_cls_labels"].numpy(),
                                      np.asarray(ref["box_cls_labels"]))
    assert tuple(got["cls_preds"].shape) == (2, 512, 1)
    tmod = AnchorHeadSingle(cfg, 32, 1, ("Car",), grid, pc,
                            predict_boxes_when_training=True)
    weights.load_into(tmod, flat).train()
    got = tmod({"spatial_features_2d": T(x), "gt_boxes": T(gt)})
    assert tuple(got["batch_box_preds"].shape) == (2, 512, 7)
    assert got["batch_box_preds"].requires_grad
    for k in ("batch_cls_preds", "batch_box_preds", "cls_preds", "box_preds"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=OP_TOL,
                                   atol=OP_TOL, err_msg=k)


# ---------------------------------------------------------------------
# the voxel set abstraction in train mode: the cotangents into the stages
# ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def vsa_vjp():
    """Both packages' VoxelSetAbstraction in train mode on
    ``test_torch_pvrcnn.vsa_inputs``, pulled back from one random
    cotangent on ``point_features`` (JAX's VJP eager, not jitted: see the
    module's docstring): the cotangents into the BEV map and every
    stage's features (rows at invalid sites included), the fused output
    and the moved statistics."""
    cfg = vsa_cfg()
    pts, mask, ms, bev = vsa_inputs(7)
    names = list(ms)
    jmod = jax_vsa.VoxelSetAbstraction(model_cfg=cfg, voxel_size=VS,
                                       point_cloud_range=FULL_PC)
    base = {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask),
            "spatial_features_stride": 8,
            "multi_scale_3d_strides": dict(STRIDES)}
    keys = {k: jnp.asarray(ms[k][1]) for k in names}

    def jbd(bev_, feats, keys_):
        d = dict(base, spatial_features=bev_)
        d["multi_scale_3d_features"] = {
            k: (feats[k], keys_[k], ms[k][2]) for k in names}
        return d

    feats = {k: jnp.asarray(ms[k][0]) for k in names}
    init = jax.jit(lambda r, b, f, kk: jmod.init(r, jbd(b, f, kk)))(
        jax.random.PRNGKey(0), jnp.asarray(bev), feats, keys)
    flat = perturb(flatten_variables(init), 7)
    variables = unflatten(flat)
    ct = np.random.RandomState(8).normal(0, 1, (2, 96, 16)).astype(
        np.float32)

    def pull(v, b, f, kk):
        def fwd(b_, f_):
            out, mut = jmod.apply(v, jbd(b_, f_, kk), train=True,
                                  mutable=["batch_stats"])
            return out["point_features"], mut["batch_stats"]

        out, back, stats = jax.vjp(fwd, b, f, has_aux=True)
        return out, back(jnp.asarray(ct)), stats

    want_out, (want_bev, want_feats), want_stats = pull(
        variables, jnp.asarray(bev), feats, keys)
    tmod = voxel_set_abstraction.VoxelSetAbstraction(
        cfg, VS, FULL_PC, num_bev_features=16, num_rawpoint_features=1,
        multi_scale_channels={k: f.shape[-1] for k, (f, _, _) in ms.items()})
    weights.load_into(tmod, flat).train()
    tbev = T(bev).requires_grad_(True)
    tfeats = {k: T(ms[k][0]).requires_grad_(True) for k in names}
    tbd = {"points": T(pts), "points_mask": T(mask), "spatial_features": tbev,
           "spatial_features_stride": 8,
           "multi_scale_3d_strides": dict(STRIDES),
           "multi_scale_3d_features": {
               k: (tfeats[k], T(ms[k][1]), ms[k][2]) for k in names}}
    out = tmod(tbd)
    out["point_features"].backward(T(ct))
    got = {"out": out["point_features"].detach().numpy(),
           "bev": tbev.grad.numpy(),
           **{k: tfeats[k].grad.numpy() for k in names},
           "keypoint_idx": out["keypoint_idx"]}
    want = {"out": np.asarray(want_out), "bev": np.asarray(want_bev),
            **{k: np.asarray(want_feats[k]) for k in names}}
    stats = weights.flax_to_torch(
        {**flat, **{"batch_stats/" + "/".join(k): np.asarray(v)
                    for k, v in __import__("flax").traverse_util.flatten_dict(
                        want_stats).items()}}, tmod)
    return got, want, ms, tmod, stats


@pytest.mark.parametrize("source", ["bev", "x_conv1", "x_conv2", "x_conv3",
                                    "x_conv4"])
def test_vsa_train_cotangents_equal_jax_vjp(vsa_vjp, source):
    """The cotangent the train-mode VSA sends into the BEV map and into
    each stage's features within 1e-5 of its largest |entry|; rows at
    the stage's invalid sites (x_conv1's padding) exactly zero in both
    (the data gradient's mirrored read needs no more)."""
    got, want, ms, _, _ = vsa_vjp
    g, w = got[source], want[source]
    assert np.abs(w).max() > 0
    np.testing.assert_allclose(g, w, rtol=0, atol=OP_TOL * np.abs(w).max())
    if source != "bev":
        invalid = ms[source][1] == voxel_set_abstraction.sparse.INVALID
        assert invalid.any() or source != "x_conv1"  # its cap is not full
        assert not w[invalid].any() and not g[invalid].any()


def test_vsa_train_output_and_statistics_equal_jax(vsa_vjp):
    """The fused keypoint features in train mode (batch statistics of the
    SA layers and of ``SharedMLP_0``) within 1e-5 of their largest
    |entry|, and the running statistics moved by the step within 1e-5."""
    got, want, _, tmod, stats = vsa_vjp
    np.testing.assert_allclose(got["out"], want["out"], rtol=0,
                               atol=OP_TOL * np.abs(want["out"]).max())
    bufs = {n: b for n, b in tmod.named_buffers() if "running" in n}
    assert len(bufs) > 20
    for n, b in bufs.items():
        np.testing.assert_allclose(b.numpy(), stats[n].numpy(), rtol=OP_TOL,
                                   atol=OP_TOL, err_msg=n)


def test_sa_layer_cotangent_equals_eager_jax():
    """The train-mode SA layer's cotangent into its source features (two
    scales, BatchNorm, every ball full): the port's within 1e-5 of JAX's
    eager VJP; at the entry where JAX's separately jitted VJP parts most
    from the eager one, a central difference of the jitted JAX forward
    agrees with the eager VJP and the port, not with the jitted VJP."""
    from de6d_tpu.models.backbones_3d.pointnet2_modules import (
        PointnetSAModuleFSMSG as JaxSA,
    )
    from de6d_tpu_torch.models.backbones_3d.pointnet2_modules import (
        PointnetSAModuleFSMSG,
    )

    rng = np.random.RandomState(0)
    b, n, m, c = 2, 400, 48, 6
    xyz = rng.uniform([0, -5, -2], [10, 5, 0], (b, n, 3)).astype(np.float32)
    feats = rng.normal(0, 1, (b, n, c)).astype(np.float32)
    valid = np.ones((b, n), bool)
    valid[1, 300:] = False
    ctr = xyz[:, :m].copy()
    kw = dict(radii=(20.0, 30.0), nsamples=(8, 16), mlps=((8, 8), (8, 8)),
              use_xyz=True)
    jm = JaxSA(**kw)
    args = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(valid))
    init = jm.init(jax.random.PRNGKey(0), *args, new_xyz=jnp.asarray(ctr))
    variables = unflatten(perturb(flatten_variables(init), 1))
    ct = rng.normal(0, 1, (b, m, 16)).astype(np.float32)

    def fwd(f):
        out, _ = jm.apply(variables, args[0], f, args[2],
                          new_xyz=jnp.asarray(ctr), train=True,
                          mutable=["batch_stats"])
        return jnp.sum(out[1] * ct)

    eager = np.asarray(jax.grad(fwd)(args[1]))
    jitted = np.asarray(jax.jit(jax.grad(fwd))(args[1]))
    tm = PointnetSAModuleFSMSG(c, **kw)
    weights.load_into(tm, flatten_variables(variables)).train()
    tf = T(feats).requires_grad_(True)
    out = tm(T(xyz), tf, T(valid), new_xyz=T(ctr))[1]
    (out * T(ct)).sum().backward()
    got = tf.grad.numpy()
    np.testing.assert_allclose(got, eager, rtol=0,
                               atol=OP_TOL * np.abs(eager).max())
    i = np.unravel_index(np.abs(jitted - eager).argmax(), eager.shape)
    eps = 1e-2
    step = np.zeros_like(feats)
    step[i] = eps
    jit_fwd = jax.jit(fwd)
    central = (float(jit_fwd(args[1] + step)) - float(jit_fwd(args[1] - step))
               ) / (2 * eps)
    parting = abs(float(jitted[i] - eager[i]))
    print(f"\nJAX SA layer VJP: jitted parts from eager by {parting:.4g} at "
          f"{i}; eager {eager[i]:.6g}, port {got[i]:.6g}, central "
          f"difference of the jitted forward {central:.6g}")
    assert abs(central - eager[i]) <= 1e-2 * max(1.0, abs(eager[i]))
    assert abs(got[i] - eager[i]) <= OP_TOL * np.abs(eager).max()


# ---------------------------------------------------------------------
# a whole train step of the tiny PV-RCNN
# ---------------------------------------------------------------------

TINY_SEED = 5  # test_torch_pvrcnn's
# How far an fp32 evaluation of the tiny step lies from the float64 step
# of the same decisions (the port's, every layer in float64, the
# proposals and the sampled RoIs of the fp32 step), the larger of the JAX
# package's and the port's, rounded up to about twice it
# (:func:`test_tiny_step_float64_bounds` measures and asserts them; on
# the CPU: gradients JAX 1.04e-4, port 1.48e-5; loss terms 5.83e-6;
# gradient norm 2.56e-7; statistics 1.90e-7; boxes 1.18e-5; class
# targets 3.49e-4 (the port's); losses 8.35e-5; parameters JAX 3.56e-2,
# port 5.79e-3): gradients relative to each leaf's
# largest |entry|, loss terms and the gradient norm relative, BatchNorm
# statistics absolute, the sampled RoIs' boxes relative above 1 m (they
# are the anchor head's decode, through exp), their class targets
# absolute, the losses of the 3 Adam steps relative and the parameters
# after them relative to each leaf's largest |entry| (Adam moves an entry
# whose gradient sits at the summation noise by up to its learning rate
# either way).
TINY_F64 = {"grad": 2e-4, "loss": 1e-5, "grad_norm": 5e-7, "stats": 5e-7,
            "boxes": 2e-5, "cls_targets": 5e-4, "losses": 1.5e-4,
            "params": 5e-2}
# Both fp32 evaluations lie within TINY_F64 of the float64 one, so within
# twice that of each other.
TINY_TOL = {k: 2 * v for k, v in TINY_F64.items()}


def tiny_train_cfg(variant="e2e"):
    """``test_torch_pvrcnn.tiny_pvrcnn_cfg`` with its train settings:
    keypoint targets, the TRAIN NMS (128 -> 32, 0.8), 16 RoIs a sample,
    half foreground, the corner loss."""
    cfg = tiny_pvrcnn_cfg(variant)
    cfg["POINT_HEAD"]["TARGET_CONFIG"] = {"GT_EXTRA_WIDTH": [0.2, 0.2, 0.2]}
    cfg["POINT_HEAD"]["LOSS_CONFIG"] = {
        "LOSS_WEIGHTS": {"point_cls_weight": 1.0}}
    roi = cfg["ROI_HEAD"]
    roi["NMS_CONFIG"]["TRAIN"] = {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.8,
                                  "NMS_PRE_MAXSIZE": 128,
                                  "NMS_POST_MAXSIZE": 32}
    roi["TARGET_CONFIG"] = {"ROI_PER_IMAGE": 16, "FG_RATIO": 0.5,
                            "REG_FG_THRESH": 0.55}
    roi["LOSS_CONFIG"] = {
        "CORNER_LOSS_REGULARIZATION": True,
        "LOSS_WEIGHTS": {"rcnn_cls_weight": 1.0, "rcnn_reg_weight": 1.0,
                         "rcnn_corner_weight": 1.0,
                         "code_weights": [1.0] * 7}}
    return cfg


def tiny_models(variant):
    """(JAX model with the dense assigner, port model on the CPU with the
    seeded weights, the flat weights)."""
    cfg = tiny_train_cfg(variant)
    jcfg = copy.deepcopy(cfg)
    jcfg["DENSE_HEAD"]["TARGET_ASSIGNER_CONFIG"]["WINDOWED_ASSIGN"] = False
    jmodel = jax_build(JaxConfig(jcfg), num_class=1,
                       dataset=JaxSpec(**TINY_SPEC))
    tmodel = build_network(Config(copy.deepcopy(cfg)), 1,
                           DatasetSpec(**TINY_SPEC), device="cpu")
    flat = weights.seeded_flax(tmodel, TINY_SEED)
    weights.load_into(tmodel, flat)
    return jmodel, tmodel, flat


class Recorded:
    """Within the block, the port's ``proposal_layer`` and
    ``assign_roi_targets`` record what they return (``self.proposals``,
    ``self.targets``), or, given ``replay`` (a ``Recorded``), return its
    records instead, cast to ``dtype``."""

    def __init__(self, replay=None, dtype=None):
        self.replay, self.dtype = replay, dtype
        self.proposals, self.targets = [], []

    def __enter__(self):
        self.orig = (roi_head_utils.proposal_layer,
                     roi_head_utils.assign_roi_targets)
        prop, assign = self.orig

        def cast(d):
            return {k: v.to(self.dtype) if torch.is_tensor(v)
                    and v.is_floating_point() else v for k, v in d.items()}

        def proposal_layer(batch_dict, *a, **k):
            if self.replay is not None:
                batch_dict.update(cast(self.replay.proposals[
                    len(self.proposals)]))
                self.proposals.append(None)
                return batch_dict
            out = prop(batch_dict, *a, **k)
            self.proposals.append({k: out[k] for k in (
                "rois", "roi_scores", "roi_labels", "roi_valid",
                "roi_point_idx")})
            return out

        def assign_roi_targets(*a, **k):
            if self.replay is not None:
                self.targets.append(None)
                return cast(self.replay.targets[len(self.targets) - 1])
            out = assign(*a, **k)
            self.targets.append(dict(out))
            return out

        roi_head_utils.proposal_layer = proposal_layer
        roi_head_utils.assign_roi_targets = assign_roi_targets
        return self

    def __exit__(self, *exc):
        (roi_head_utils.proposal_layer,
         roi_head_utils.assign_roi_targets) = self.orig


def tiny_gt(tmodel, pts, mask):
    """Gt boxes (2, 4, 8) on the tiny scene for which the seeded model
    has foreground RoIs: jittered copies of three of each sample's
    train-mode proposals (sample 1's third slot empty), class 1. The
    proposals do not depend on the gt boxes."""
    model = copy.deepcopy(tmodel).train()
    gt0 = np.zeros((2, 4, 8), np.float32)
    gt0[:, 0] = [5.0, 0.0, -1.0, 3.9, 1.6, 1.56, 0.0, 1]
    with torch.no_grad(), Recorded() as rec:
        model({"points": T(pts), "points_mask": T(mask), "gt_boxes": T(gt0)})
    rois = rec.proposals[0]["rois"].numpy()
    rng = np.random.RandomState(0)
    gt = np.zeros((2, 4, 8), np.float32)
    for i in range(2):
        for j in range(3):
            gt[i, j, :7] = rois[i, 5 * j]
            gt[i, j, :3] += rng.uniform(-0.1, 0.1, 3)
            gt[i, j, 7] = 1
    gt[1, 2] = 0.0
    return gt


@contextlib.contextmanager
def record_jax_proposals():
    """Within the block the JAX proposal layer records its input
    (``cls``, ``boxes``: the anchor head's) and its output (``rois``,
    ``roi_valid``, ``roi_labels``; the sampler replaces them in the batch
    dict)."""
    rec = {}
    orig = jax_roi_utils.proposal_layer

    def run(batch_dict, nms_cfg, num_rois):
        rec["cls"] = batch_dict["batch_cls_preds"]
        rec["boxes"] = batch_dict["batch_box_preds"]
        out = orig(batch_dict, nms_cfg, num_rois)
        for k in ("rois", "roi_valid", "roi_labels"):
            rec[k] = out[k]
        return out

    jax_roi_utils.proposal_layer = run
    try:
        yield rec
    finally:
        jax_roi_utils.proposal_layer = orig


def jax_step(jmodel, variables, batch, opt_cfg, steps):
    """The JAX package's fp32 train steps, each the body of its
    ``make_train_step`` (loss and gradients of one jitted program, then
    the optimizer's update): the first step's loss terms, gradients and
    new BatchNorm statistics; every step's loss, keypoints, their labels,
    proposals and the RoI stage's targets (``keeps``); the parameters
    after ``steps`` steps."""
    from flax.traverse_util import flatten_dict
    from optax import apply_updates, global_norm

    from de6d_tpu.ops import sparse as jsp
    from de6d_tpu.train.optimization import build_optimizer_and_schedule
    from test_torch_det6d import record_jax_picks

    roi_cfg = jmodel.model_cfg["ROI_HEAD"]["NMS_CONFIG"]["TRAIN"]
    pre = int(roi_cfg["NMS_PRE_MAXSIZE"])

    def loss_fn(p, stats, b):
        with record_jax_picks() as picks, record_jax_proposals() as props:
            out, mutated = jmodel.apply({"params": p, "batch_stats": stats},
                                        dict(b), train=True,
                                        mutable=["batch_stats"])
        loss, tb = jmodel.get_training_loss(out)
        t = out["roi_targets_dict"]
        keep = {k: t[k] for k in TARGET_KEYS + ("gt_of_rois_local",)}
        keep.update({k: out[k] for k in (
            "point_coords", "point_cls_labels", "box_cls_labels")})
        keep["keypoint_idx"] = picks[0]
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


def pv_rcnn_opt_cfg():
    from de6d_tpu_torch.config import cfg_from_yaml_file

    opt = dict(cfg_from_yaml_file(PVRCNN_CFG).OPTIMIZATION)
    opt["NUM_EPOCHS"] = 20
    return opt


def f64_model(model):
    """A copy of ``model`` computing every layer in float64 (the anchors
    and the assigner's thresholds stay fp32, as the targets read
    them)."""
    m = copy.deepcopy(model).double()
    for mod in m.modules():
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = torch.float64
    head = m.dense_head
    for name in ("anchors", "matched_thr", "unmatched_thr"):
        setattr(head, name, getattr(head, name).float())
    return m


def port_gradients(model, batch):
    """One train-mode forward and backward of ``model``: (output,
    gradients per parameter as float64 numpy, loss terms, running
    statistics after the step)."""
    model.train()
    model.zero_grad(set_to_none=True)
    out = model({k: T(v) for k, v in batch.items()})
    loss, tb = model.get_training_loss(out)
    loss.backward()
    grads = {n: p.grad.detach().double().numpy().reshape(-1)
             for n, p in model.named_parameters()}
    stats = {n: b.detach().double().numpy() for n, b in model.named_buffers()
             if "running" in n}
    return out, grads, {k: float(v.detach()) for k, v in tb.items()}, stats


@functools.lru_cache(maxsize=None)
def tiny_run(variant, steps):
    """The JAX package's and the port's step on the tiny scene from the
    same seeded weights, then ``steps`` ``adam_onecycle`` steps; and the
    port's float64 step of the port's fp32 decisions."""
    import test_torch_pointpillar_train as ppt

    jmodel, tmodel, flat = tiny_models(variant)
    pts, mask = scene(0)
    batch = {"points": pts, "points_mask": mask,
             "gt_boxes": tiny_gt(tmodel, pts, mask)}
    opt_cfg = pv_rcnn_opt_cfg()
    ref = jax_step(jmodel, unflatten(flat), batch, opt_cfg, steps)
    m64 = f64_model(tmodel)
    out, g32, m32, _ = port_gradients(copy.deepcopy(tmodel), batch)
    with Recorded() as rec:
        got = ppt.port_train_run(tmodel, flat, batch, opt_cfg, steps=steps)
    f64 = f64_run(m64, batch, opt_cfg, steps, rec)
    return {"ref": ref, "got": got, "out": out, "rec": rec, "g32": g32,
            "m32": m32, "f64": f64, "tmodel": tmodel, "flat": flat,
            "batch": batch, "opt_cfg": opt_cfg, "steps": steps}


def f64_run(model, batch, opt_cfg, steps, rec):
    """``steps`` train steps of the float64 ``model`` with the proposals
    and sampled RoIs that the fp32 run recorded in ``rec``, each step as
    ``make_train_step`` runs it: the first step's gradients, loss terms
    and running statistics, and every step's loss."""
    from de6d_tpu_torch.train import build_optimizer_and_schedule

    opt, _ = build_optimizer_and_schedule(opt_cfg, model, 1)
    tb_batch = {k: T(v) for k, v in batch.items()}
    res = {"losses": []}
    with Recorded(replay=rec, dtype=torch.float64):
        for i in range(steps):
            model.train()
            opt.zero_grad(set_to_none=True)
            out = model(dict(tb_batch))
            loss, tb = model.get_training_loss(out)
            loss.backward()
            if i == 0:
                res["box_preds"] = out["batch_box_preds"].detach()
                res["grads"] = {n: p.grad.detach().numpy().reshape(-1)
                                for n, p in model.named_parameters()}
                res["metrics"] = {k: float(v.detach()) for k, v in tb.items()}
                res["stats"] = {n: b.numpy().copy() for n, b in
                                model.named_buffers() if "running" in n}
            opt.step()
            res["losses"].append(float(loss.detach()))
    res["params"] = {n: p.detach().numpy().copy()
                     for n, p in model.named_parameters()}
    return res


@pytest.fixture(scope="module")
def tiny_train():
    """tests/test_pvrcnn_e2e.py's tiny PV-RCNN (BEV, raw points and
    x_conv3 keypoint features; a RoI head with BatchNorm), 3 steps."""
    return tiny_run("e2e", 3)


def test_tiny_step_picks_and_targets(tiny_train):
    """Keypoints and their labels, the anchors' labels, the proposals'
    count and the sampled RoIs' labels and masks exact; the RoIs' boxes
    and class targets within :data:`TINY_TOL`; the matched gt boxes
    where a RoI overlaps one."""
    ref, out, rec = tiny_train["ref"]["keep"], tiny_train["out"], \
        tiny_train["rec"]
    for k in ("point_coords", "point_cls_labels", "box_cls_labels"):
        np.testing.assert_array_equal(out[k].detach().numpy(), ref[k],
                                      err_msg=k)
    assert (ref["point_cls_labels"] == 1).sum() > 0
    targets = {k: v.numpy() for k, v in rec.targets[0].items()}
    assert 0 < ref["reg_valid_mask"].sum() < ref["roi_sample_valid"].sum()
    best = jax_max_iou(ref["rois"], ref["roi_labels"],
                       tiny_train["batch"]["gt_boxes"])
    assert_targets_equal(targets, ref,
                         np.where(ref["roi_sample_valid"], best, 0.0),
                         box_tol=TINY_TOL["boxes"],
                         cls_tol=TINY_TOL["cls_targets"])
    np.testing.assert_allclose(
        out["roi_targets_dict"]["gt_of_rois_local"].numpy()[
            ref["reg_valid_mask"]],
        ref["gt_of_rois_local"][ref["reg_valid_mask"]],
        rtol=TINY_TOL["boxes"], atol=TINY_TOL["boxes"])


def test_tiny_step_losses_and_grad_norm(tiny_train):
    ref, got = tiny_train["ref"]["metrics"], tiny_train["got"]["metrics"]
    assert set(got) == set(ref) == {
        "loss", "rpn_loss_cls", "rpn_loss_loc", "rpn_loss_dir", "rpn_loss",
        "point_loss_cls", "rcnn_loss_cls", "rcnn_loss_reg",
        "rcnn_loss_corner", "rcnn_loss", "grad_norm"}
    for k in ref:
        tol = TINY_TOL["grad_norm" if k == "grad_norm" else "loss"]
        np.testing.assert_allclose(got[k], ref[k], rtol=tol, err_msg=k)


def test_tiny_step_gradients(tiny_train):
    """Every parameter's gradient within :data:`TINY_TOL` of its leaf's
    largest |entry|: the 12 sparse-conv kernels (through the port's
    backward), the VSA's SA layers, the keypoint head, the RoI-grid pool
    and the RoI head's FCs among them."""
    want = weights.flax_params_to_torch(tiny_train["ref"]["grads"],
                                        tiny_train["tmodel"])
    got = tiny_train["got"]["grads"]
    assert set(want) == set(got)
    for name, g in want.items():
        w = g.numpy()
        err = float(np.abs(got[name].numpy() - w).max())
        assert err <= TINY_TOL["grad"] * max(np.abs(w).max(), 1e-12), name
    prefixes = {n.split(".")[0] for n in want}
    assert prefixes == {"backbone_3d", "pfe", "backbone_2d", "dense_head",
                        "point_head", "roi_head"}


def test_tiny_step_batch_stats(tiny_train):
    want = weights.flax_to_torch(
        {**tiny_train["flat"], **tiny_train["ref"]["batch_stats"]},
        tiny_train["tmodel"])
    got = tiny_train["got"]["buffers"]
    assert sum("roi_head" in n for n in got) >= 8
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
    package's against the port's float64 run of the same decisions (the
    first step's gradients, loss terms, gradient norm and statistics, the
    losses of the 3 steps); both within it. Prints the distances."""
    from chip_smoke import f64_distances

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
    # the sampled RoIs' boxes in float64 (the anchor head's decode of the
    # anchors they came from) and their class targets
    from de6d_tpu_torch.ops import iou3d

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
        want = boxes64.numpy()[valid]
        d["boxes"] = float((np.abs(b - want) / np.maximum(1.0, np.abs(want)))
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
        print(f"\ntiny PV-RCNN step vs float64: port fp32 {port}; JAX fp32 "
              f"{jaxd}")
    for k, bound in TINY_F64.items():
        assert port[k] <= bound and jaxd[k] <= bound, (k, port, jaxd)


# ---------------------------------------------------------------------
# the CLIs on a cut of data/kitti
# ---------------------------------------------------------------------

def tiny_pv_rcnn_yaml(path):
    """``pv_rcnn.yaml`` with its data config as shipped and small widths
    (sparse filters [8, 8, 16, 16, 16], BEV [32, 64], 4000 voxels, 256
    keypoints, SA and RoI widths of 8-16, a 3 x 3 x 3 RoI grid, 16 RoIs of
    64 proposals), written to ``path``."""
    import yaml

    from test_torch_second_train import _cfgs

    _, tcfg = _cfgs(PVRCNN_CFG)

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
    m["PFE"].update(NUM_KEYPOINTS=256, NUM_OUTPUT_FEATURES=32)
    for src in m["PFE"]["SA_LAYER"].values():
        src["MLPS"] = [[8, 8], [8, 8]]
    m["POINT_HEAD"]["CLS_FC"] = [16]
    roi = m["ROI_HEAD"]
    roi.update(SHARED_FC=[32], CLS_FC=[16], REG_FC=[16])
    roi["ROI_GRID_POOL"].update(GRID_SIZE=3, MLPS=[[8, 8], [8, 8]])
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
    cfg = tiny_pv_rcnn_yaml(work / "configs/kitti_models/pv_rcnn_tiny.yaml")
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


def test_train_cli_trains_pv_rcnn(trained_cli):
    """One epoch of the tiny PV-RCNN through ``tools/train.py``: 2 steps
    of batch 2, every loss term finite, a checkpoint, the post-training
    KITTI eval over the RoI head's detections."""
    work, _, _, run, ret = trained_cli
    out = work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG / "a"
    assert type(run.model).__name__ == "PVRCNN"
    assert (out / "ckpt/checkpoint_epoch_1").is_file()
    assert (out / "eval/eval_with_train/result.pkl").is_file()
    assert run.state.step == 2 and len(run.step_log) == 2
    assert np.isfinite([float(x[2]) for x in run.step_log]).all()
    assert ret["recall_counts"]["gt"] > 0
    assert "Car_3d/moderate_R40" in ret


def test_test_cli_evaluates_the_pv_rcnn_checkpoint(trained_cli):
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
    """The JAX loader's first batch of 2 on ``data/kitti``'s train split
    (``pv_rcnn.yaml``'s ``DATA_CONFIG``, one worker, seed 0)."""
    from de6d_tpu.datasets import build_dataloader as jax_build_loader
    from test_torch_second_train import _cfgs

    jcfg, _ = _cfgs(PVRCNN_CFG)
    _, loader = jax_build_loader(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, 2,
                                 root_path=str(KITTI), training=True, seed=0,
                                 workers=1)
    loader.set_epoch(0)
    raw = next(iter(loader))
    return {k: np.asarray(raw[k]) for k in ("points", "points_mask",
                                             "gt_boxes")}


def row_index(rows, table):
    """(B, R, C) rows → (B, R) the first row of (B, T, C) ``table`` equal
    to each (0 where none is)."""
    same = (rows[:, :, None] == table[:, None]).all(-1)
    return same.argmax(-1).astype(np.int32)


def fixture_content():
    """The JAX package's fp32 train step from the weights of
    ``chip_smoke.pvrcnn_train_model`` (flax's initialisers, a torch seed;
    dense assigner) on :func:`jax_kitti_batch`: stage
    keys, keypoint picks and labels, anchor labels, the proposal layer's
    candidates (a window of the best anchors, their boxes) and RoIs, the
    sampled RoIs (and which proposal each is) with their targets, loss
    terms, gradient norm, gradients, statistics, the losses of 3 Adam
    steps, each later step's proposals and sampled RoIs (``step2/``,
    ``step3/``) and the parameters after them, per parameter in the
    port's layout."""
    import test_torch_pointpillar_train as ppt
    from chip_smoke import pvrcnn_opt_cfg, pvrcnn_train_model

    batch = jax_kitti_batch()
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        jmodel, tmodel = ppt.build_pair_train(str(PVRCNN_CFG))
        flat = weights.torch_to_flax(pvrcnn_train_model("cpu")[0])
    finally:
        os.chdir(cwd)
    ref = jax_step(jmodel, unflatten(flat), batch, pvrcnn_opt_cfg(), 3)
    keep = ref["keep"]
    out = dict(batch)
    for k in [f"keys_{i}" for i in range(1, 6)] + ["keypoint_idx",
                                                   "point_cls_labels"]:
        out[k] = keep[k].astype(np.int32)
    labels = keep["box_cls_labels"].reshape(-1)
    nz = np.flatnonzero(labels)
    out["labels_idx"] = nz.astype(np.int64)
    out["labels_val"] = labels[nz].astype(np.int32)
    out["prop_order"] = keep["prop_order"].astype(np.int32)
    out["prop_scores"] = keep["prop_scores"]
    out["prop_boxes"] = keep["prop_boxes"]
    # each step's decisions (the later steps' replayed by the card)
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
    """Rewrite ``testdata/pvrcnn_train_jax_ref.npz`` with ``python -c
    "import sys; sys.path.insert(0, 'tests'); import
    test_torch_pvrcnn_train as t; t.write_fixture()"``."""
    np.savez_compressed(FIXTURE, **fixture_content())


def test_fixture_holds_what_the_card_reads():
    """The card's parity phase (``chip_smoke.check_pvrcnn_train_parity``)
    reads these keys; the batch is the JAX loader's first of 2."""
    with np.load(FIXTURE) as ref:
        files = set(ref.files)
        assert ref["points"].shape == (2, 16384, 4)
        assert ref["keypoint_idx"].shape == (2, 2048)
        assert ref["proposals"].shape == (2, 512, 7)
        assert ref["target/rois"].shape == (2, 128, 7)
        assert ref["roi_sample_idx"].shape == (2, 128)
        assert ref["losses"].shape == (3,)
        assert ref["labels_idx"].size > 0
        assert ref["target/roi_sample_valid"].sum() > 0
    assert {"points_mask", "gt_boxes", "keys_5", "point_cls_labels",
            "prop_order", "prop_scores", "proposal_idx", "proposal_labels",
            "metric/loss", "metric/rcnn_loss_corner",
            "metric/grad_norm"} <= files
    assert sum(f.startswith("stats/") for f in files) > 50
    assert FIXTURE.stat().st_size < 8 * 2 ** 20


def port_side_of_fixture():
    """The fixture's proposal layer and sampler as the port's side of
    ``chip_smoke.check_pvrcnn_proposals`` / ``check_pvrcnn_sampling``
    would hand them over (scores outside the stored window below every
    stored one)."""
    ref = dict(np.load(FIXTURE))
    b = ref["prop_order"].shape[0]
    scores = np.full((b, 211200), -1.0, np.float32)
    np.put_along_axis(scores, ref["prop_order"].astype(np.int64),
                      ref["prop_scores"], axis=1)
    pre = ref["prop_boxes"].shape[1]
    port = {"scores": scores, "dir_margin": np.ones((b, 211200), np.float32),
            "cand_order": ref["prop_order"][:, :pre].astype(np.int64),
            "prop_idx": ref["proposal_idx"].copy(),
            "prop_valid": ref["proposal_valid"].copy(),
            "rois": ref["proposals"].copy()}
    targets = {k: T(ref[f"target/{k}"].copy()) for k in
               TARGET_KEYS + ("gt_of_rois_local",)}
    targets["roi_sample_idx"] = T(ref["roi_sample_idx"].copy())
    return ref, port, targets


@pytest.mark.parametrize("fault", ["none", "swap", "turned", "turned_tie",
                                   "count", "sample", "cls_target"])
def test_parity_checks_refuse_faults(fault):
    """``chip_smoke``'s proposal and sampling checks pass the fixture
    against itself and refuse a candidate swap that is no near-tie, a box
    turned by pi without a direction tie (one with a tie counts as a
    parting, to be replayed), a changed proposal count, another sampled
    RoI and a moved class target."""
    from chip_smoke import (
        PARITY_TOL, PVRCNN_TRAIN_TOL, check_pvrcnn_proposals,
        check_pvrcnn_sampling,
    )

    ref, port, targets = port_side_of_fixture()
    if fault == "swap":
        port["cand_order"][0, [0, 5000]] = port["cand_order"][0, [5000, 0]]
    elif fault.startswith("turned"):
        port["rois"][0, 3, 6] += np.float32(np.pi)
        if fault == "turned_tie":
            port["dir_margin"][0, port["prop_idx"][0, 3]] = 1e-4
    elif fault == "count":
        port["prop_valid"][1, -1] = False
    elif fault == "sample":
        valid = np.flatnonzero(ref["target/roi_sample_valid"][0])
        targets["roi_sample_idx"][0, valid[0]] += 1
    elif fault == "cls_target":
        targets["rcnn_cls_labels"][0, 70] += 0.01
    args = [port[k] for k in ("scores", "dir_margin", "cand_order",
                              "prop_idx", "prop_valid", "rois")]
    if fault in ("swap", "turned", "count", "sample", "cls_target"):
        with pytest.raises(RuntimeError):
            check_pvrcnn_proposals("t", *args, ref, PARITY_TOL)
            check_pvrcnn_sampling("t", targets, ref, PVRCNN_TRAIN_TOL)
        return
    report, whole = check_pvrcnn_proposals("t", *args, ref, PARITY_TOL)
    check_pvrcnn_sampling("t", targets, ref, PVRCNN_TRAIN_TOL)
    assert whole == (fault == "none")
    assert len(report["turned_at_direction_ties"]) == (fault != "none")


@pytest.mark.slow
def test_fixture_equals_fresh_jax_run():
    ref = fixture_content()
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in stored.files:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_train_step_matches_fixture_on_cpu(capsys):
    """The card's parity phase (``chip_smoke.check_pvrcnn_train_parity``,
    its tolerances in ``chip_smoke.PVRCNN_TRAIN_TOL``) here on the CPU,
    with the float64 step of the same decisions behind
    ``chip_smoke.PVRCNN_TRAIN_F64``: the port's fp32 step and the
    fixture's JAX step both within it. Prints the distances."""
    from chip_smoke import (
        PVRCNN_TRAIN_F64, check_pvrcnn_train_parity, measure_pvrcnn_train_f64,
    )

    f64 = measure_pvrcnn_train_f64("cpu")
    with capsys.disabled():
        print(f"\nPV-RCNN full-width step vs float64: {f64}")
    for side in ("port", "jax"):
        for k, v in f64[side].items():
            assert v <= PVRCNN_TRAIN_F64[k], (side, k, v)
    report = check_pvrcnn_train_parity("cpu", measure_f64=False)
    with capsys.disabled():
        print(f"proposals {report['proposals']}; sampling "
              f"{report['sampling']}")
    assert report["positives"] > 0


def test_numpy_generator_draws_flax_initialisers():
    """``build_network(..., generator=numpy Generator)`` (the train phases'
    weights, ``chip_smoke.pvrcnn_train_model``): the same weights from the
    same seed, and flax's distributions: lecun-normal kernels truncated at
    two standard deviations, the anchor head's focal prior on its class
    bias and normal(0.001) box kernel, BatchNorm at one and zero."""
    from chip_smoke import pvrcnn_train_model

    a = pvrcnn_train_model("cpu")[0].state_dict()
    b = pvrcnn_train_model("cpu")[0].state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = a["roi_head.shared_fc.Dense_0.weight"].numpy()  # fan-in 27,648
    std = 27648 ** -0.5
    assert abs(w.std() / std - 1) < 0.01
    assert np.abs(w).max() <= 2 * std / 0.87962566103423978 + 1e-9
    np.testing.assert_allclose(a["dense_head.conv_cls.bias"].numpy(),
                               -np.log((1 - 0.01) / 0.01), rtol=1e-6)
    assert abs(a["dense_head.conv_box.weight"].numpy().std() / 0.001 - 1) \
        < 0.05
    assert (a["pfe.SharedMLP_0.BatchNorm_0.weight"] == 1).all()
