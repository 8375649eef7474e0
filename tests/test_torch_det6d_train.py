"""Det6D training: the PyTorch port against the JAX package on the CPU,
module by module (glibc-rounded trig and the Euler rotation matrix,
7- and 9-DoF containment with points planted on the faces of sloped
boxes, the coders' encodes at the yaw-bin edges and the pitch threshold,
the target functions, centerness, aligned IoU, the losses, the SA
layer's train path) and whole train steps of the tiny Det6D and of a
tiny 3DSSD-SASA from the same weights and batch.

Tolerances, each with its reason:
- containment, every label (vote, point-cls, pitch-cls, SASA), the yaw
  bins and the rotation matrix are exact: the port rounds as jitted XLA
  does on the CPU (glibc ``sinf`` / ``cosf``, its FMAs);
- regression targets and single loss functions: 1e-6 (log / exp /
  sigmoid of the two libraries differ by an ulp), the head loss's terms
  1e-5 relative;
- train steps in fp32: loss terms within 1e-5 relative, every gradient
  within 1e-4 of its leaf's largest entry, BatchNorm statistics 1e-5,
  parameters after 3 Adam steps within 1e-5 of the leaf's largest entry
  (the PointPillars train parity's tolerances).

The full-width reference for the card (``write_fixture``) is held on the
CPU in the slow tier, with the float64 measurement behind
``chip_smoke.DET6D_TRAIN_TOL``.
"""

import contextlib
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.models import build_network as jax_build
from de6d_tpu.models.backbones_3d.pointnet2_modules import (
    PointnetSAModuleFSMSG as JaxSA,
)
from de6d_tpu.models.dense_heads import point_head_vote as jax_head
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.ops import geometry as jax_geometry
from de6d_tpu.ops import iou3d as jax_iou3d
from de6d_tpu.ops import sampling as jax_sampling
from de6d_tpu.utils import box_coder_utils as jax_coders
from de6d_tpu.utils import loss_utils as jax_losses
from de6d_tpu.utils.testing import tiny_det6d_cfg
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.backbones_3d.pointnet2_modules import (
    PointnetSAModuleFSMSG,
)
from de6d_tpu_torch.models.dense_heads import point_head_vote as head
from de6d_tpu_torch.models.detectors.detector3d_template import DatasetSpec
from de6d_tpu_torch.ops import ball_query as bq
from de6d_tpu_torch.ops import geometry, iou3d
from de6d_tpu_torch.utils import box_coder_utils, loss_utils
from torch_fixtures import flatten_variables, perturb, unflatten

ROOT = Path(__file__).resolve().parents[1]
TINY_RANGE = (0.0, -16.0, -3.0, 32.0, 16.0, 4.0)
SPEC = dict(class_names=("Car",), point_feature_dim=4,
            point_cloud_range=TINY_RANGE)
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and ops on
    tensors above PyTorch's grain otherwise wait on OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ulps_around(values, k=4):
    """Each float32 value and its k neighbours either side."""
    out = []
    for v in np.asarray(values, np.float32):
        w = v
        for _ in range(k):
            w = np.nextafter(w, np.float32(-np.inf))
        for _ in range(2 * k + 1):
            out.append(w)
            w = np.nextafter(w, np.float32(np.inf))
    return np.asarray(out, np.float32)


def rotation(yaw, pitch, roll):
    """float64 R = Rx(roll) Ry(pitch) Rz(yaw) (scipy's 'zyx' Euler)."""
    from scipy.spatial.transform import Rotation

    return Rotation.from_euler("zyx", [yaw, pitch, roll]).as_matrix()


def sloped_boxes(rng, m, dof=9):
    """(m, dof) boxes: sizes of cars, pitch up to 0.4 rad, small rolls."""
    b = np.zeros((m, dof), np.float32)
    b[:, 0] = rng.uniform(2, 30, m)
    b[:, 1] = rng.uniform(-14, 14, m)
    b[:, 2] = rng.uniform(-1.5, 0.5, m)
    b[:, 3] = rng.uniform(3.2, 4.8, m)
    b[:, 4] = rng.uniform(1.4, 1.9, m)
    b[:, 5] = rng.uniform(1.3, 1.8, m)
    b[:, 6] = rng.uniform(-np.pi, np.pi, m)
    if dof == 9:
        b[:, 7] = rng.uniform(-0.4, 0.15, m)
        b[:, 8] = rng.uniform(-0.08, 0.08, m)
    return b


def face_points(rng, boxes, per_box, margin=0.0):
    """Points on the faces of each box (a random face, the other two
    coordinates inside), ``margin`` metres outside, rounded to float32
    from float64 world coordinates."""
    out = []
    for g in boxes.astype(np.float64):
        pitch, roll = (g[7], g[8]) if g.shape[0] >= 9 else (0.0, 0.0)
        r = rotation(g[6], pitch, roll)
        local = rng.uniform(-0.5, 0.5, (per_box, 3)) * g[3:6]
        axis = rng.randint(0, 3, per_box)
        side = rng.choice([-1.0, 1.0], per_box)
        local[np.arange(per_box), axis] = side * (
            g[3 + axis] / 2 + margin)
        out.append(local @ r.T + g[:3])
    return np.concatenate(out).astype(np.float32)


def scene_batch(seed, b=2, n=512, n_gt=6, per_box=60):
    """Points uniform in the tiny range, ``per_box`` of them inside each
    sloped gt box (9-DoF + class; the last row a zero pad) and a few on
    its faces; gt pitch in [-0.4, 0.1] rad, so some boxes lie below the
    coder's -10 degree threshold."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, 4), np.float32)
    for d, (lo, hi) in enumerate(((0, 32), (-16, 16), (-2, 2), (0, 1))):
        pts[..., d] = rng.uniform(lo, hi, (b, n))
    gt = np.zeros((b, n_gt, 10), np.float32)
    for bi in range(b):
        gt[bi, :, :9] = sloped_boxes(rng, n_gt)
        gt[bi, :, 9] = 1
        gt[bi, -1] = 0
        for gi in range(n_gt - 1):
            g = gt[bi, gi].astype(np.float64)
            local = rng.uniform(-0.5, 0.5, (per_box, 3)) * g[3:6]
            sl = slice(gi * per_box, (gi + 1) * per_box)
            pts[bi, sl, :3] = local @ rotation(*g[6:9]).T + g[:3]
        faces = face_points(rng, gt[bi, :n_gt - 1], 8)
        pts[bi, n - len(faces):, :3] = faces
    return {"points": pts, "points_mask": np.ones((b, n), bool),
            "gt_boxes": gt}


# ---------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------

def test_trig_and_rotation_matrix_equal_jitted_xla():
    """cos32 / sin32 equal XLA's CPU cosine and sine bit for bit (small
    arguments, multiples of pi/4 and their neighbours, the reduction's
    quadrants), and ``angles_to_matrix`` equals the jitted JAX matrix."""
    rng = np.random.RandomState(0)
    x = np.concatenate([
        rng.uniform(-8, 8, 20000), rng.uniform(-1e-3, 1e-3, 200),
        _ulps_around(np.arange(-12, 13) * np.pi / 4, 3),
        _ulps_around([0.75, -0.75, 2.0 ** -12, -(2.0 ** -12)], 3),
    ]).astype(np.float32)
    for jf, tf in ((jnp.cos, geometry.cos32), (jnp.sin, geometry.sin32)):
        np.testing.assert_array_equal(tf(T(x)).numpy(),
                                      np.asarray(jax.jit(jf)(x)))
    yaw, pitch, roll = (rng.uniform(lo, hi, 20000).astype(np.float32)
                        for lo, hi in ((-4, 4), (-1, 1), (-1, 1)))
    ref = np.asarray(jax.jit(jax_geometry.angles_to_matrix)(yaw, pitch,
                                                            roll))
    got = geometry.angles_to_matrix(T(yaw), T(pitch), T(roll)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dof", [7, 9])
def test_containment_with_face_planted_points(dof):
    """``points_in_boxes_mask`` and ``points_in_boxes_index`` against
    jitted JAX, batched as the target functions call them, on points
    planted on the faces of (sloped) boxes, 1e-6 m in and out of them
    and at random; overlapping boxes (a duplicate, a nested box) test
    that the last box wins."""
    rng = np.random.RandomState(1 + dof)
    b, m = 2, 8
    boxes = np.stack([sloped_boxes(rng, m, dof) for _ in range(b)])
    boxes[:, 5] = boxes[:, 2]  # a duplicate: the later one wins
    boxes[:, 6, :3] = boxes[:, 3, :3]  # a nested, smaller box
    boxes[:, 6, 3:6] = boxes[:, 3, 3:6] * 0.5
    pts = np.stack([np.concatenate([
        face_points(rng, boxes[i], 120),
        face_points(rng, boxes[i], 40, margin=1e-6),
        face_points(rng, boxes[i], 40, margin=-1e-6),
        rng.uniform(-5, 35, (300, 3)).astype(np.float32)]) for i in range(b)])
    valid = np.ones((b, m), bool)
    valid[1, 4] = False

    @jax.jit
    def ref_fn(p, bx, v):
        mask = jax.vmap(jax_geometry.points_in_boxes_mask)(p, bx)
        idx = jax.vmap(jax_geometry.points_in_boxes_index)(p, bx, v)
        return mask, idx

    ref_mask, ref_idx = (np.asarray(a) for a in ref_fn(pts, boxes, valid))
    mask = geometry.points_in_boxes_mask(T(pts), T(boxes)).numpy()
    idx = geometry.points_in_boxes_index(T(pts), T(boxes), T(valid)).numpy()
    np.testing.assert_array_equal(mask, ref_mask)
    np.testing.assert_array_equal(idx, ref_idx)
    out = np.stack([ref_mask[:, j, m * 120 + j * 40:m * 120 + (j + 1) * 40]
                    for j in range(m)])
    assert 0.1 < out.mean() < 0.9  # 1e-6 m out: rounding decides
    assert (ref_idx == 5).any() and not (ref_idx == 2).any()
    assert (ref_idx == 6).any()


def test_boxes_to_corners_equal_jax():
    rng = np.random.RandomState(3)
    boxes = sloped_boxes(rng, 200, 7)
    ref = np.asarray(jax.jit(jax_geometry.boxes_to_corners_3d)(boxes))
    got = geometry.boxes_to_corners_3d(T(boxes)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


# ---------------------------------------------------------------------
# coders
# ---------------------------------------------------------------------

def _coder_inputs(seed):
    """Boxes whose yaws sit at and around every multiple of 2 pi / 24 in
    [-4 pi, 4 pi] (bin centres and edges) and whose pitches sit at and
    around 0 and +-10 degrees, then random ones."""
    rng = np.random.RandomState(seed)
    yaw = np.concatenate([_ulps_around(np.arange(-48, 49) * np.pi / 12),
                          rng.uniform(-7, 7, 1500).astype(np.float32)])
    n = yaw.size
    thr = np.float32(np.deg2rad(10))
    pitch = rng.uniform(-0.5, 0.5, n).astype(np.float32)
    edges = _ulps_around([-thr, thr, 0.0])
    pitch[:edges.size] = edges
    boxes = sloped_boxes(rng, n)
    boxes[:, 6], boxes[:, 7] = yaw, pitch
    pts = boxes[:, :3] + rng.normal(0, 1, (n, 3)).astype(np.float32)
    return boxes, pts


@pytest.mark.parametrize("cfg", [
    dict(use_mean_size=False, ground_aware=True),
    dict(use_mean_size=False, ground_aware=True, minus=True),
    dict(use_mean_size=False, ground_aware=False),
    dict(use_mean_size=True, mean_size=[[3.9, 1.6, 1.56], [0.8, 0.6, 1.7]],
         ground_aware=True),
], ids=["ground_aware", "minus", "direct", "mean_size"])
def test_6d_coder_encode_equals_jitted_jax(cfg):
    """Yaw bins and the pitch class exact at their edges; the offsets and
    residuals within 1e-6 (log of the two libraries); decode(encode)
    returns the box where the decode's gate keeps the pitch."""
    boxes, pts = _coder_inputs(4)
    cls = (np.arange(len(boxes)) % 2 + 1).astype(np.int32)
    ref = np.asarray(jax.jit(
        lambda b, p, c: jax_coders.PointBinResidual6DCoder(**cfg).encode(
            b, p, c))(boxes, pts, cls))
    coder = box_coder_utils.PointBinResidual6DCoder(**cfg)
    got = coder.encode(T(boxes), T(pts), T(cls)).numpy()
    assert got.shape == ref.shape == (len(boxes), coder.code_size)
    np.testing.assert_array_equal(got[:, 6:18], ref[:, 6:18])  # yaw bins
    np.testing.assert_array_equal(got[:, 30:] != 0, ref[:, 30:] != 0)
    if cfg["ground_aware"]:
        np.testing.assert_array_equal(got[:, 30], ref[:, 30])
        assert 0 < ref[:, 30].mean() < 1
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=2e-6)


def test_bin_coder_encode_equals_jitted_jax():
    boxes, pts = _coder_inputs(5)
    boxes = boxes[:, :7]
    ref = np.asarray(jax.jit(
        lambda b, p: jax_coders.PointBinResidualCoder(
            use_mean_size=False).encode(b, p))(boxes, pts))
    got = box_coder_utils.PointBinResidualCoder(use_mean_size=False).encode(
        T(boxes), T(pts)).numpy()
    np.testing.assert_array_equal(got[:, 6:18], ref[:, 6:18])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_6d_coder_on_7_column_boxes_reads_the_yaw_as_jax_does():
    """``kitti_models/det6d_car.yaml`` trains on KITTI's 7-DoF boxes (gt
    width 8 with the class); the 6-DoF coder reads the pitch at column 7,
    past the end. The JAX package does not raise: its static index is
    clamped to the last column, so the yaw is coded as the pitch (a yaw
    below -10 degrees gives pitch class 1). The port does the same."""
    boxes, pts = _coder_inputs(18)
    boxes = boxes[:, :7]
    ref = np.asarray(jax.jit(jax_coders.PointBinResidual6DCoder(
        use_mean_size=False).encode)(boxes, pts))
    got = box_coder_utils.PointBinResidual6DCoder(use_mean_size=False).encode(
        T(boxes), T(pts)).numpy()
    np.testing.assert_array_equal(got[:, 30], ref[:, 30])
    np.testing.assert_array_equal(ref[:, 30], boxes[:, 6] < np.float32(
        np.deg2rad(10)) * -1)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=2e-6)



# ---------------------------------------------------------------------
# targets
# ---------------------------------------------------------------------

def _target_inputs(seed):
    """Votes / candidates in and around the boxes of ``scene_batch``, some
    invalid, and a sample without any gt box."""
    batch = scene_batch(seed, b=3, n=400)
    batch["gt_boxes"][2] = 0.0
    pts = batch["points"][..., :3].copy()
    valid = np.ones(pts.shape[:2], bool)
    valid[:, ::17] = False
    return pts, valid, batch["gt_boxes"]


def test_assign_targets_simple_and_mask_equal_jitted_jax():
    pts, valid, gt = _target_inputs(6)
    coder_cfg = dict(use_mean_size=False, angle_bin_num=12,
                     ground_aware=True, threshold=10, factor=45)
    ref_s = jax.jit(lambda p, v, g: jax_head.assign_targets_simple(
        p, v, g, extra_width=[1.0, 1.0, 1.0]))(pts, valid, gt)
    ref_m = jax.jit(lambda p, v, g: jax_head.assign_targets_mask(
        p, v, g, jax_coders.PointBinResidual6DCoder(**coder_cfg), 1,
        central_radius=1.5))(pts, valid, gt)
    got_s = head.assign_targets_simple(T(pts), T(valid), T(gt),
                                       extra_width=[1.0, 1.0, 1.0])
    got_m = head.assign_targets_mask(
        T(pts), T(valid), T(gt),
        box_coder_utils.PointBinResidual6DCoder(**coder_cfg), 1,
        central_radius=1.5)
    np.testing.assert_array_equal(got_s[0].numpy(), np.asarray(ref_s[0]))
    np.testing.assert_array_equal(got_s[1].numpy(), np.asarray(ref_s[1]))
    np.testing.assert_array_equal(got_m[0].numpy(), np.asarray(ref_m[0]))
    labels = np.asarray(ref_m[0])
    assert (labels == 1).sum() > 50 and (labels == -1).sum() > 50
    assert not (labels[2] > 0).any()
    np.testing.assert_array_equal(got_m[2].numpy(), np.asarray(ref_m[2]))
    reg, ref_reg = got_m[1].numpy(), np.asarray(ref_m[1])
    np.testing.assert_array_equal(reg[..., 6:18], ref_reg[..., 6:18])
    np.testing.assert_array_equal(reg[..., 30], ref_reg[..., 30])
    assert 0 < ref_reg[labels == 1, 30].mean() < 1  # pitch classes
    np.testing.assert_allclose(reg, ref_reg, rtol=1e-6, atol=1e-6)


def test_assign_targets_iou_equals_jitted_jax():
    pts, valid, gt = _target_inputs(7)
    rng = np.random.RandomState(8)
    idx = rng.randint(0, 5, pts.shape[:2])
    preds = np.take_along_axis(gt[..., :9], idx[..., None], axis=1).copy()
    preds[..., :3] += rng.normal(0, 0.3, preds[..., :3].shape)
    preds[..., 3:6] *= rng.uniform(0.8, 1.2, preds[..., 3:6].shape)
    preds = preds.astype(np.float32)
    coder = dict(use_mean_size=False)
    ref = jax.jit(lambda p, v, b, g: jax_head.assign_targets_iou(
        p, v, b, g, jax_coders.PointBinResidualCoder(**coder), 1))(
        pts, valid, preds, gt[..., [0, 1, 2, 3, 4, 5, 6, 9]])
    got = head.assign_targets_iou(
        T(pts), T(valid), T(preds), T(np.ascontiguousarray(
            gt[..., [0, 1, 2, 3, 4, 5, 6, 9]])),
        box_coder_utils.PointBinResidualCoder(**coder), 1)
    labels = np.asarray(ref[0])
    assert (labels == 1).sum() > 20 and (labels == 0).sum() > 20
    np.testing.assert_array_equal(got[0].numpy(), labels)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("ignore", [False, True])
def test_assign_sasa_labels_equal_jitted_jax(ignore):
    pts, valid, gt = _target_inputs(9)
    coords = [pts, pts[:, ::2].copy()]
    valids = [valid, valid[:, ::2].copy()]
    ref = jax.jit(lambda c, v, g: jax_head.assign_sasa_labels(
        c, v, g, extra_width=[0.5, 0.5, 0.5], set_ignore_flag=ignore))(
        coords, valids, gt)
    got = head.assign_sasa_labels([T(c) for c in coords],
                                  [T(v) for v in valids], T(gt),
                                  extra_width=[0.5, 0.5, 0.5],
                                  set_ignore_flag=ignore)
    for a, r in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    assert (np.asarray(ref[0]) == 1).sum() > 50
    assert ((np.asarray(ref[0]) == -1).sum() > (valid == 0).sum()) == ignore


def test_centerness_and_aligned_iou_equal_jax():
    pts, valid, gt = _target_inputs(10)
    boxes = np.take_along_axis(
        gt[..., :9], np.zeros(pts.shape[:2], np.int64)[..., None],
        axis=1).reshape(-1, 9)
    p = pts.reshape(-1, 3)
    pos = valid.reshape(-1)
    ref = jax.jit(jax_head.generate_centerness_label)(p, boxes, pos)
    got = head.generate_centerness_label(T(p), T(boxes), T(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    other = boxes[::-1, :7].copy()
    ref = jax.jit(jax_iou3d.boxes_aligned_iou3d)(boxes[:, :7], other)
    got = iou3d.boxes_aligned_iou3d(T(boxes[:, :7]), T(other))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)
    assert (np.asarray(ref) > 0.1).sum() > 10


# ---------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------

def test_bce_and_corner_loss_equal_jax():
    rng = np.random.RandomState(11)
    logits = (rng.randn(500, 2) * 3).astype(np.float32)
    targets = rng.rand(500, 2).astype(np.float32)
    w = rng.rand(500).astype(np.float32)
    np.testing.assert_allclose(
        loss_utils.weighted_binary_cross_entropy(T(logits), T(targets),
                                                 T(w)).numpy(),
        np.asarray(jax_losses.weighted_binary_cross_entropy(logits, targets,
                                                            w)),
        rtol=1e-6, atol=1e-7)
    gt = sloped_boxes(rng, 300, 7)
    pred = gt + rng.normal(0, 0.3, gt.shape).astype(np.float32)
    pred[::3, 6] += np.pi  # the flipped gt is nearer
    np.testing.assert_allclose(
        loss_utils.get_corner_loss_lidar(T(pred), T(gt)).numpy(),
        np.asarray(jax.jit(jax_losses.get_corner_loss_lidar)(pred, gt)),
        rtol=1e-5, atol=1e-6)


def _head_loss_batch(seed, cfg):
    """A train-mode head's outputs and targets, made by the port's target
    functions on random votes and predictions."""
    rng = np.random.RandomState(seed)
    pts, valid, gt = _target_inputs(seed)
    coder = box_coder_utils.build_box_coder(
        cfg["TARGET_CONFIG"]["BOX_CODER"],
        **cfg["TARGET_CONFIG"]["BOX_CODER_CONFIG"])
    cand = T(pts)
    vote_cls, vote_reg = head.assign_targets_simple(cand, T(valid), T(gt),
                                                    [1.0, 1.0, 1.0])
    votes = cand + T(rng.normal(0, 0.3, pts.shape).astype(np.float32))
    cls_l, reg_l, box_l = head.assign_targets_mask(votes, T(valid), T(gt),
                                                   coder, 1, 10.0)
    reg_preds = T((rng.randn(*reg_l.shape) * 0.5).astype(np.float32))
    b = {
        "point_vote_coords": votes, "vote_cls_labels": vote_cls,
        "vote_reg_labels": vote_reg, "point_cls_labels": cls_l,
        "point_reg_labels": reg_l, "point_box_labels": box_l,
        "point_cls_preds": T(rng.randn(*pts.shape[:2], 1).astype(
            np.float32)),
        "point_reg_preds": reg_preds,
        "point_box_preds": coder.decode(reg_preds, votes),
    }
    b["point_sasa_labels"] = head.assign_sasa_labels(
        [cand, cand[:, ::2]], [T(valid), T(valid[:, ::2])], T(gt))
    b["point_sasa_preds"] = [T(rng.randn(*pts.shape[:2]).astype(np.float32)),
                             T(rng.randn(pts.shape[0], pts.shape[1] // 2)
                               .astype(np.float32)), None]
    b["point_sasa_labels"].append(b["point_sasa_labels"][0])
    return b, coder


@pytest.mark.parametrize("variant", ["det6d", "focal_direct", "bin_coder"])
def test_point_vote_head_loss_equals_jax(variant):
    """Every term of ``point_vote_head_loss`` within 1e-5 relative: the
    Det6D config (WithCenterness BCE, ground-aware pitch, IoU and corner
    regularisers, SASA BCE), focal classification with the direct pitch
    and focal SASA, and the 7-DoF bin coder."""
    cfg = copy.deepcopy(dict(tiny_det6d_cfg()["POINT_HEAD"]))
    if variant == "focal_direct":
        cfg["LOSS_CONFIG"]["LOSS_CLS"] = "WeightedClassificationLoss"
        cfg["TARGET_CONFIG"]["BOX_CODER_CONFIG"]["ground_aware"] = False
        cfg["LOSS_CONFIG"]["LOSS_SASA_CONFIG"]["func"] = "Focal"
    elif variant == "bin_coder":
        cfg["TARGET_CONFIG"]["BOX_CODER"] = "PointBinResidualCoder"
        cfg["TARGET_CONFIG"]["BOX_CODER_CONFIG"] = {
            "use_mean_size": False, "angle_bin_num": 12}
    batch, coder = _head_loss_batch(12, cfg)
    if variant == "bin_coder":
        batch["point_box_labels"] = batch["point_box_labels"][..., :7]
    jcoder = jax_coders.build_box_coder(
        cfg["TARGET_CONFIG"]["BOX_CODER"],
        **cfg["TARGET_CONFIG"]["BOX_CODER_CONFIG"])

    def to_jax(v):
        if isinstance(v, list):
            return [None if x is None else jnp.asarray(x.numpy()) for x in v]
        return jnp.asarray(v.numpy())

    ref_total, ref_tb = jax.jit(lambda b: jax_head.point_vote_head_loss(
        b, cfg, 1, jcoder))({k: to_jax(v) for k, v in batch.items()})
    got_total, got_tb = head.point_vote_head_loss(batch, cfg, 1, coder)
    assert set(got_tb) == set(ref_tb)
    assert float(ref_tb["point_pos_num"]) > 20
    for k in ref_tb:
        np.testing.assert_allclose(float(got_tb[k]), float(ref_tb[k]),
                                   rtol=1e-5, err_msg=k)
    np.testing.assert_allclose(float(got_total), float(ref_total), rtol=1e-5)


# ---------------------------------------------------------------------
# the SA layer's train path
# ---------------------------------------------------------------------

def _sa_train_pair(seed, binned):
    kw = dict(radii=(0.6, 1.2), nsamples=(8, 16), mlps=((16, 16), (16, 32)),
              npoint_list=(96,), sample_range_list=((0, -1),),
              sample_method_list=("s-fps",), dilated_radius_group=True,
              aggregation_mlp=(32,), confidence_mlp=(16,),
              pc_range=TINY_RANGE if binned else (), bin_cell_cap=16,
              bin_spill_cap=32)
    batch = scene_batch(seed, b=2, n=512)
    xyz = batch["points"][..., :3]
    feats = batch["points"][..., 3:]
    valid = np.ones(xyz.shape[:2], bool)
    valid[1, 400:] = False
    scores = np.random.RandomState(seed).normal(0, 2, valid.shape).astype(
        np.float32)
    jmod = JaxSA(**kw)
    args = [jnp.asarray(a) for a in (xyz, feats, valid, scores)]
    flat = perturb(flatten_variables(jmod.init(jax.random.PRNGKey(seed),
                                               *args)), seed)
    ref, mutated = jax.jit(lambda v, *a: jmod.apply(
        v, *a, train=True, mutable=["batch_stats"]))(unflatten(flat), *args)
    tmod = PointnetSAModuleFSMSG(in_channels=1, **kw)
    weights.load_into(tmod, flat).train()
    assert tmod._binned_ok(512) == jmod._binned_ok(512) == binned
    inputs = [T(a) for a in (xyz, feats, valid, scores)]
    return ref, mutated, tmod(*inputs), tmod, flat, inputs


@pytest.mark.parametrize("binned", [True, False], ids=["binned", "brute"])
def test_sa_layer_train_mode_uses_batch_statistics(binned):
    """The repaired train path: in train mode the SA layer normalises with
    the batch's statistics over every grouped slot (also where JAX queries
    through its binned path, which the folded eval path would take) and
    moves its running statistics: features and scores within 1e-5 of
    JAX's ``train=True`` output, the new running statistics within 1e-5.
    The folded eval path, which the layer took in train mode before the
    repair, gives other features."""
    ref, mutated, got, tmod, flat, inputs = _sa_train_pair(13, binned)
    np.testing.assert_array_equal(got[0].detach().numpy(), np.asarray(ref[0]))
    for i in (1, 2):
        np.testing.assert_allclose(got[i].detach().numpy(),
                                   np.asarray(ref[i]), rtol=1e-5, atol=1e-5)
    want = weights.flax_to_torch({**flat, **{
        "/".join(("batch_stats",) + k): np.asarray(v)
        for k, v in __import__("flax").traverse_util.flatten_dict(
            mutated["batch_stats"]).items()}}, tmod)
    moved = 0
    for name, buf in tmod.named_buffers():
        if "running" in name:
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
            moved += int(not np.allclose(buf.numpy(), flat[
                weights.flax_path("batch_stats." + name.rsplit(".", 1)[0])
                + ("/mean" if "mean" in name else "/var")]))
    assert moved == sum("running" in n for n, _ in tmod.named_buffers())
    # the running statistics normalise otherwise: the folded eval path,
    # which the binned layer took in train mode before the repair
    with torch.no_grad():
        eval_feats = tmod.eval()(*inputs)[1]
    assert float((eval_feats - got[1]).abs().max()) > 1e-2


def test_ball_query_equals_binned_query_with_padding_slots():
    """On Det6D-shaped SA2 input (2 x 4096 points, 1024 centres, radii
    0.4 / 0.8 / 1.6 dilated, 32 / 32 / 64 slots) the port's brute query
    gives the JAX binned query's ``(idx, cnt)`` in full, the slots past
    ``cnt`` (which BatchNorm's batch statistics read) included: with
    empty groups (centres far from every point, invalid centres) and full
    ones (dense clusters)."""
    from de6d_tpu.ops import binned as jax_binned

    rng = np.random.RandomState(14)
    pc = (0.0, -40.0, -3.0, 70.4, 40.0, 4.0)
    b, n, m = 2, 4096, 1024
    xyz = np.zeros((b, n, 3), np.float32)
    xyz[..., 0] = rng.uniform(0, 70, (b, n))
    xyz[..., 1] = rng.uniform(-40, 40, (b, n))
    xyz[..., 2] = rng.uniform(-2, 1, (b, n))
    xyz[:, :1500] = (xyz[:, :1500:100].repeat(100, axis=1)[:, :1500]
                     + rng.normal(0, 0.3, (b, 1500, 3)))
    valid = np.ones((b, n), bool)
    valid[1, 3500:] = False
    centres = xyz[:, ::4].copy()
    centres[:, 900:] += 30.0  # far away: empty groups
    cvalid = np.ones((b, m), bool)
    cvalid[0, 10:20] = False
    scales = [(0.4, 0.0, 32), (0.8, 0.4, 32), (1.6, 0.8, 64)]
    ref, overflow = jax.jit(lambda *a: jax_binned.binned_msg_query(
        *a[:2], (0.4, 0.8, 1.6), (32, 32, 64), *a[2:],
        radius_in_list=(0.0, 0.4, 0.8), pc_range=pc))(
        xyz, centres, valid, cvalid)
    assert int(np.asarray(overflow).max()) == 0
    got = bq.ball_query_scales(T(xyz), T(centres), scales, T(valid),
                               T(cvalid))
    for (idx, cnt), (r_idx, r_cnt), (_, _, ns) in zip(got, ref, scales):
        np.testing.assert_array_equal(idx.numpy(), np.asarray(r_idx))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(r_cnt))
        c = np.asarray(r_cnt)
        assert (c == 0).sum() > 100 and (c == ns).sum() > 50


def test_no_gradient_reaches_the_picks():
    """s-fps weights come from the confidence logits, which carry a graph
    in train mode; the picks carry none, and the backward of a loss on the
    logits reaches the logits' parameters but nothing through the picks."""
    from de6d_tpu_torch.ops import sampling

    rng = np.random.RandomState(15)
    xyz = T(rng.uniform(-5, 5, (2, 300, 3)).astype(np.float32))
    logits = torch.nn.Parameter(T(rng.randn(2, 300).astype(np.float32)))
    with torch.enable_grad():
        w = torch.sigmoid(logits) ** 1.0
        picks = sampling.weighted_farthest_point_sample(xyz, w, 64)
        assert picks.grad_fn is None and not picks.requires_grad
        assert picks.dtype == torch.int32
        torch.gather(w, 1, picks.long()).sum().backward()
    picked = torch.zeros(2, 300, dtype=torch.bool)
    picked.scatter_(1, picks.long(), True)
    assert torch.equal(logits.grad != 0, picked)


# ---------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------

@contextlib.contextmanager
def recorded_jax_sampling():
    """Inside a JAX trace, record each FPS call's picks (in call order)."""
    rec = []
    orig = (jax_sampling.farthest_point_sample,
            jax_sampling.weighted_farthest_point_sample,
            jax_sampling.matrix_farthest_point_sample)

    def wrap(fn):
        def run(*a, **k):
            rec.append(fn(*a, **k))
            return rec[-1]
        return run

    (jax_sampling.farthest_point_sample,
     jax_sampling.weighted_farthest_point_sample,
     jax_sampling.matrix_farthest_point_sample) = (wrap(f) for f in orig)
    try:
        yield rec
    finally:
        (jax_sampling.farthest_point_sample,
         jax_sampling.weighted_farthest_point_sample,
         jax_sampling.matrix_farthest_point_sample) = orig


TARGET_KEYS = ("vote_cls_labels", "vote_reg_labels", "point_cls_labels",
               "point_reg_labels", "point_box_labels")


def _flat(tree, prefix):
    from flax.traverse_util import flatten_dict

    return {"/".join((prefix,) + k): np.asarray(v, np.float32)
            for k, v in flatten_dict(tree).items()}


def jax_step_reference(jmodel, variables, batch):
    """One JAX loss-and-gradient evaluation in train mode, as numpy: the
    loss terms and the gradient norm, the gradients, the new BatchNorm
    statistics, the targets (and SASA labels), each FPS call's picks and
    the s-fps logits."""
    from optax import global_norm

    params, stats = variables["params"], variables["batch_stats"]
    with recorded_jax_sampling() as rec:
        def loss_fn(p, b):
            rec.clear()
            out, mutated = jmodel.apply(
                {"params": p, "batch_stats": stats}, dict(b), train=True,
                mutable=["batch_stats"])
            loss, tb = jmodel.get_training_loss(out)
            keep = {k: out[k] for k in TARGET_KEYS}
            keep["sasa"] = out["point_sasa_labels"]
            keep["picks"] = list(rec)
            keep["scores"] = [s for s in out["point_scores_list"]
                              if s is not None]
            return loss, (tb, mutated["batch_stats"], keep)

        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        (_, (tb, new_stats, keep)), grads = jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(params, jb)
    return {
        "metrics": {k: float(v) for k, v in tb.items()}
        | {"grad_norm": float(global_norm(grads))},
        "grads": _flat(grads, "params"),
        "batch_stats": _flat(new_stats, "batch_stats"),
        "targets": {k: np.asarray(keep[k]) for k in TARGET_KEYS},
        "sasa": [np.asarray(x) for x in keep["sasa"]],
        "picks": [np.asarray(x) for x in keep["picks"]],
        "scores": [np.asarray(x) for x in keep["scores"]],
    }


def jax_train_reference(jmodel, variables, batch, opt_cfg, steps=3):
    """:func:`jax_step_reference`, then ``steps`` steps of the JAX
    package's ``make_train_step``: each step's picks, loss and the state
    before and after it (parameters, statistics, Adam's moments and
    count, as numpy)."""
    from de6d_tpu.train.optimization import build_optimizer_and_schedule
    from de6d_tpu.train.train_state import TrainState, make_train_step

    out = jax_step_reference(jmodel, variables, batch)
    params, stats = variables["params"], variables["batch_stats"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def flat_state(st):
        """Numpy copies (the JAX step donates its state's buffers)."""
        adam = st.opt_state[1].inner_state[0]  # clip, then the chain
        return (_flat(st.params, "params"),
                _flat(st.batch_stats, "batch_stats"),
                _flat(adam.mu, "params"), _flat(adam.nu, "params"),
                int(adam.count))

    optimizer, _ = build_optimizer_and_schedule(opt_cfg, params,
                                                steps_per_epoch=1)
    step = make_train_step(jmodel, optimizer)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=jax.tree_util.tree_map(jnp.array, params),
                       batch_stats=jax.tree_util.tree_map(jnp.array, stats),
                       opt_state=optimizer.init(params))
    with recorded_jax_sampling() as rec:
        @jax.jit
        def picks_of(p, s, b):
            rec.clear()
            jmodel.apply({"params": p, "batch_stats": s}, dict(b),
                         train=True, mutable=["batch_stats"])
            return list(rec)

        step_picks, states, losses = [], [], []
        for k in range(steps):
            # the picks the k-th step takes (its parameters' scores)
            step_picks.append([np.asarray(x) for x in picks_of(
                state.params, state.batch_stats, jb)])
            states.append(flat_state(state))
            state, m = step(state, dict(jb))
            losses.append(float(m["loss"]))
        states.append(flat_state(state))

    return out | {"losses": losses, "states": states,
                  "step_picks": step_picks}


def port_train_run(tmodel, flat, batch, opt_cfg, ref_picks, step_picks,
                   states, steps=3):
    """The port's step from the same variables, every sampling call
    forced to the reference's picks (``chip_smoke.forced_sampling``:
    ``ref_picks`` for the first forward, ``step_picks[k]`` in step k) and
    its own picks of the first forward kept: metrics, targets, gradients
    and BatchNorm statistics of the first step; then each of ``steps``
    steps from the JAX state before it (``states[k]``: parameters,
    statistics, Adam's moments and count), with its loss and the
    parameters after it."""
    from chip_smoke import forced_sampling
    from de6d_tpu_torch.train import (
        build_optimizer_and_schedule, create_train_state, make_train_step,
    )

    weights.load_into(tmodel, flat)
    opt, _ = build_optimizer_and_schedule(opt_cfg, tmodel, 1)
    state = create_train_state(tmodel, opt)
    tb = {k: T(v) for k, v in batch.items()}
    out = {"losses": []}
    with forced_sampling(ref_picks) as calls:
        tmodel.train()
        fwd = tmodel(dict(tb))
    out["targets"] = {k: fwd[k].detach().numpy() for k in TARGET_KEYS}
    out["sasa"] = [x.numpy() for x in fwd["point_sasa_labels"]]
    out["calls"] = list(calls)
    step = make_train_step(tmodel, opt)
    out["params_after"] = []
    for i in range(steps):
        sd, named = weights.flax_train_state_to_torch(tmodel, *states[i])
        tmodel.load_state_dict(sd)
        opt.load_named_state(named)
        with forced_sampling(step_picks[i]):
            state, m = step(state, tb)
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["metrics"] = {k: float(v) for k, v in m.items()}
            out["grads"] = {n: p.grad.clone()
                            for n, p in tmodel.named_parameters()}
            out["buffers"] = {n: b.clone()
                              for n, b in tmodel.named_buffers()
                              if "running" in n}
        out["params_after"].append({n: p.detach().clone()
                                    for n, p in tmodel.named_parameters()})
    return out


def det6d_opt_cfg():
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg

    opt = dict(jax_cfg(str(ROOT / "configs/slopedkitti_models/"
                           "det6d_car.yaml")).OPTIMIZATION)
    opt["NUM_EPOCHS"] = 20
    return opt


def tiny_det6d_pair():
    jcfg = tiny_det6d_cfg()
    jmodel = jax_build(jcfg, num_class=1, dataset=JaxSpec(**SPEC))
    tmodel = build_network(Config(copy.deepcopy(dict(jcfg))), 1,
                           DatasetSpec(**SPEC), device="cpu")
    return jmodel, tmodel


def trainable_flat(jmodel, batch, seed):
    """Perturbed variables whose votes start near their candidates (the
    vote layer's last Dense scaled down), so votes land in gt boxes."""
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    flat = perturb(flatten_variables(init), seed=seed)
    for k in flat:
        if "vote_layers/Dense_1" in k:
            flat[k] = flat[k] * 0.01
    return flat


def run_pair(jmodel, tmodel, batch, seed):
    flat = trainable_flat(jmodel, batch, seed)
    opt_cfg = det6d_opt_cfg()
    ref = jax_train_reference(jmodel, unflatten(flat), batch, opt_cfg)
    got = port_train_run(tmodel, flat, batch, opt_cfg, ref["picks"],
                         ref["step_picks"], ref["states"])
    return {"ref": ref, "got": got, "tmodel": tmodel, "flat": flat,
            "batch": batch, "opt_cfg": opt_cfg}


@pytest.fixture(scope="module")
def tiny_train():
    jmodel, tmodel = tiny_det6d_pair()
    return run_pair(jmodel, tmodel, scene_batch(16), seed=5)


def test_train_step_picks_are_the_references(tiny_train):
    """The port's own picks of every sampling call (d-fps, s-fps, s-fps)
    equal JAX's, or part only at certified near-ties."""
    from chip_smoke import certify_sampling_call

    ref, got = tiny_train["ref"], tiny_train["got"]
    assert len(got["calls"]) == len(ref["picks"]) == 3
    assert [c["method"] for c in got["calls"]] == ["d-fps", "s-fps", "s-fps"]
    for k, call in enumerate(got["calls"]):
        certify_sampling_call("tiny det6d", k, call,
                              None if k == 0 else ref["scores"][k - 1], 0.0)


def test_train_step_labels_and_targets(tiny_train):
    """Vote, point-cls, pitch-cls and SASA labels identical; regression
    targets within 1e-6."""
    ref, got = tiny_train["ref"], tiny_train["got"]
    for k in ("vote_cls_labels", "point_cls_labels", "point_box_labels"):
        np.testing.assert_array_equal(got["targets"][k], ref["targets"][k],
                                      err_msg=k)
    assert (ref["targets"]["point_cls_labels"] > 0).sum() >= 4
    reg, ref_reg = (x["targets"]["point_reg_labels"] for x in (got, ref))
    np.testing.assert_array_equal(reg[..., 30], ref_reg[..., 30])
    assert ref_reg[..., 30].sum() > 0  # a pitch below the threshold
    np.testing.assert_array_equal(reg[..., 6:18], ref_reg[..., 6:18])
    for k in ("vote_reg_labels", "point_reg_labels"):
        np.testing.assert_allclose(got["targets"][k], ref["targets"][k],
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert len(got["sasa"]) == 3
    for a, r in zip(got["sasa"], ref["sasa"]):
        np.testing.assert_array_equal(a, r)


def test_train_step_loss_terms_and_grad_norm(tiny_train):
    ref, got = tiny_train["ref"]["metrics"], tiny_train["got"]["metrics"]
    assert set(got) == set(ref)
    assert {"vote_loss_reg", "point_loss_cls", "point_loss_box",
            "point_loss_sasa", "grad_norm"} <= set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, err_msg=k)


def leaf_close(got, ref, rel, what):
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max |d| {err} > {rel} * {scale}"


def test_train_step_gradients(tiny_train):
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
    assert len(got) > 40
    for name, b in got.items():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


def test_train_step_params_after_three_steps(tiny_train):
    """3 Adam steps, each from the JAX state before it (so that one
    step's partings do not feed the next through the max-pools' routing):
    the loss of each within 1e-5 relative, the parameters after it within
    1e-5 of the leaf's largest entry. Adam divides each entry by its own
    root-mean-square gradient, so an entry whose gradient sits at the
    level of the two libraries' summation-order noise moves by up to its
    learning rate either way: such entries may part (at most 0.5 % of a
    leaf), by no more than the learning rates summed over the steps."""
    from de6d_tpu_torch.train.optimization import (
        build_optimizer_and_schedule,
    )

    ref, got = tiny_train["ref"], tiny_train["got"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    _, sched = build_optimizer_and_schedule(tiny_train["opt_cfg"],
                                            tiny_train["tmodel"], 1)
    lr_sum = sum(sched(k) for k in range(3))
    for k in range(3):
        want = weights.flax_params_to_torch(ref["states"][k + 1][0],
                                            tiny_train["tmodel"])
        for name, p in want.items():
            r = p.numpy()
            err = np.abs(got["params_after"][k][name].numpy() - r)
            parted = err > 1e-5 * np.abs(r).max()
            assert parted.mean() <= 0.005, (k, name, parted.mean())
            assert err.max() <= lr_sum, (k, name, err.max(), lr_sum)


def test_train_model_three_steps(tiny_train):
    """``train_model`` over 3 epochs of the tiny batch: 3 steps, finite
    losses that fall, a checkpoint that restores a fresh Det6D model to
    the trained parameters and statistics."""
    from de6d_tpu_torch.train import (
        build_optimizer_and_schedule, create_train_state,
    )
    from de6d_tpu_torch.train.checkpoint import restore_checkpoint
    from de6d_tpu_torch.train.train_loop import train_model
    import tempfile

    class Loader:
        def __init__(self, batch):
            self.batch = batch

        def set_epoch(self, epoch):
            pass

        def __iter__(self):
            yield self.batch

    _, tmodel = tiny_det6d_pair()
    weights.load_into(tmodel, tiny_train["flat"])
    opt, sched = build_optimizer_and_schedule(tiny_train["opt_cfg"], tmodel,
                                              1)
    state = create_train_state(tmodel, opt)
    log = []
    with tempfile.TemporaryDirectory() as tmp:
        state = train_model(tmodel, opt, state, Loader(tiny_train["batch"]),
                            tiny_train["opt_cfg"], total_epochs=3,
                            ckpt_dir=Path(tmp), step_log=log)
        assert state.step == 3 and len(log) == 3
        losses = [float(x[2]) for x in log]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
        _, fresh = tiny_det6d_pair()
        opt2, _ = build_optimizer_and_schedule(tiny_train["opt_cfg"], fresh,
                                               1)
        restored, meta = restore_checkpoint(
            Path(tmp) / "checkpoint_epoch_3", create_train_state(fresh,
                                                                 opt2))
    assert restored.step == 3 and int(meta["epoch"]) == 3
    trained = dict(tmodel.state_dict())
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, trained[k]), k


def test_det6d_mapping_carries_every_batchnorm_statistic():
    """Every BatchNorm of the port's Det6D (full width) has a running mean
    and variance in ``bench_assets/det6d_car_params.npz`` through the
    flax→torch mapping, with the stored values."""
    from de6d_tpu_torch.config import cfg_from_yaml_file

    cfg = cfg_from_yaml_file(str(ROOT / "configs/slopedkitti_models/"
                                 "det6d_car.yaml"))
    model = build_network(cfg.MODEL, 1, DatasetSpec(
        class_names=("Car",), point_feature_dim=4,
        point_cloud_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)),
        device="cpu")
    flat = weights.load_flax_npz(ROOT / "bench_assets/det6d_car_params.npz")
    sd = weights.flax_to_torch(flat, model)
    stats = [n for n, _ in model.named_buffers() if "running" in n]
    assert len(stats) == 86 and all(n in sd for n in stats)
    for n in stats[:5]:
        key = weights.flax_path("batch_stats." + n.rsplit(".", 1)[0]) + (
            "/mean" if n.endswith("mean") else "/var")
        np.testing.assert_array_equal(sd[n].numpy(), flat[key])


# ---------------------------------------------------------------------
# 3DSSD-SASA: the same loss, f-fps and s-fps sampling
# ---------------------------------------------------------------------

def tiny_sasa_cfg():
    """``3dssd_sasa_car.yaml``'s structure at tiny widths: D-FPS, then
    f-fps + d-fps fusion, then s-fps; SASA layer weights; the 7-DoF bin
    coder."""
    cfg = copy.deepcopy(dict(tiny_det6d_cfg()))
    cfg["NAME"] = "SSD3D"
    sa = cfg["BACKBONE_3D"]["SA_CONFIG"]
    sa["NPOINT_LIST"] = [[256], [64, 64], [64]]
    sa["SAMPLE_RANGE_LIST"] = [[[0, -1]], [[0, -1], [0, -1]], [[0, -1]]]
    sa["SAMPLE_METHOD_LIST"] = [["d-fps"], ["f-fps", "d-fps"], ["s-fps"]]
    sa["CONFIDENCE_MLPS"] = [[], [16], []]
    h = cfg["POINT_HEAD"]
    h["NAME"] = "PointHeadBoxVote"
    h["TARGET_CONFIG"]["BOX_CODER"] = "PointBinResidualCoder"
    h["TARGET_CONFIG"]["BOX_CODER_CONFIG"] = {"use_mean_size": False,
                                              "angle_bin_num": 12}
    h["LOSS_CONFIG"]["LOSS_SASA_CONFIG"] = {"func": "BCE",
                                            "layer_weights": [0.0, 1.0, 0.0],
                                            "extra_width": [1.0, 1.0, 1.0]}
    return cfg


def test_tiny_3dssd_sasa_train_step_equals_jax():
    """One fp32 step of the tiny 3DSSD-SASA on 7-DoF gt: labels exact,
    loss terms within 1e-5 relative, gradients within 1e-4 of each leaf's
    max."""
    jcfg = tiny_sasa_cfg()
    from de6d_tpu.config import Config as JaxConfig

    jmodel = jax_build(JaxConfig(copy.deepcopy(jcfg)), num_class=1,
                       dataset=JaxSpec(**SPEC))
    tmodel = build_network(Config(copy.deepcopy(jcfg)), 1,
                           DatasetSpec(**SPEC), device="cpu")
    batch = scene_batch(17)
    batch["gt_boxes"] = np.ascontiguousarray(
        batch["gt_boxes"][..., [0, 1, 2, 3, 4, 5, 6, 9]])
    res = run_pair(jmodel, tmodel, batch, seed=6)
    ref, got = res["ref"], res["got"]
    from chip_smoke import certify_sampling_call

    for k, call in enumerate(got["calls"]):
        certify_sampling_call("tiny 3dssd-sasa", k, call,
                              ref["scores"][0] if k == 3 else None, 0.0)
    for k in ("vote_cls_labels", "point_cls_labels"):
        np.testing.assert_array_equal(got["targets"][k], ref["targets"][k])
    for a, r in zip(got["sasa"], ref["sasa"]):
        np.testing.assert_array_equal(a, r)
    assert (ref["targets"]["point_cls_labels"] > 0).sum() >= 2
    for k in ref["metrics"]:
        np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                   rtol=1e-5, err_msg=k)
    want = weights.flax_params_to_torch(ref["grads"], tmodel)
    for name, g in want.items():
        leaf_close(got["grads"][name].numpy(), g.numpy(), 1e-4, name)


# ---------------------------------------------------------------------
# full-width reference for the card (which has no JAX)
# ---------------------------------------------------------------------

SLOPED = ROOT / "configs/slopedkitti_models/det6d_car.yaml"
TRAIN_FIXTURE = ROOT / "de6d_tpu_torch/testdata/det6d_train_jax_ref.npz"
PARAMS = ROOT / "bench_assets/det6d_car_params.npz"
BATCH_KEYS = ("points", "points_mask", "gt_boxes")


def jax_loader_batches(batch_size):
    """The JAX loader's train batches of epoch 0 on ``data/slopedkitti``
    (``det6d_car.yaml``'s data config, augmentation on, one worker)."""
    import os

    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg
    from de6d_tpu.datasets import build_dataloader

    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        cfg = jax_cfg(str(SLOPED))
        _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size, root_path=str(
                                         ROOT / "data/slopedkitti"),
                                     training=True, seed=0, workers=1)
    finally:
        os.chdir(cwd)
    loader.set_epoch(0)
    for batch in loader:
        yield {k: np.asarray(batch[k]) for k in BATCH_KEYS}


def full_width_jax_model():
    """``det6d_car.yaml``'s Det6D in the JAX package, fp32 everywhere."""
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg

    cfg = jax_cfg(str(SLOPED))
    mc = copy.deepcopy(dict(cfg.MODEL))
    mc["COMPUTE_DTYPE"] = "float32"
    mc["POINT_HEAD"].pop("_COMPUTE_DTYPE", None)
    return jax_build(mc, num_class=1, dataset=JaxSpec(
        class_names=("Car",), point_feature_dim=4,
        point_cloud_range=tuple(cfg.DATA_CONFIG.POINT_CLOUD_RANGE)))


def train_fixture_content():
    """The fixture's content: the first batch of 2 of epoch 0 with a
    positive whose pitch class is 1 (``batch_index``), the JAX fp32 step
    on it from the trained weights (every sampling call's picks and
    logits, targets, loss terms, gradient norm, gradients in the port's
    layout, BatchNorm statistics after it), and the loader's first batch
    of 8 (``train8_*``, the frames of the card's train phase)."""
    from test_torch_pointpillar_train import store_leaves

    from chip_smoke import build_model

    jmodel = full_width_jax_model()
    flat = weights.load_flax_npz(PARAMS)
    variables = unflatten(flat)
    for index, batch in enumerate(jax_loader_batches(2)):
        ref = jax_step_reference(jmodel, variables, batch)
        t = ref["targets"]
        if ((t["point_cls_labels"] > 0)
                & (t["point_reg_labels"][..., 30] > 0)).any():
            break
    tmodel = build_model("float32", "cpu", SLOPED, PARAMS)[0]
    out = dict(batch)
    out["batch_index"] = np.int64(index)
    for k, p in enumerate(ref["picks"]):
        out[f"picks_{k}"] = p
    for k, s in enumerate(ref["scores"]):
        out[f"scores_{k}"] = s
    for k, v in ref["targets"].items():
        out[f"target/{k}"] = v
    for k, v in enumerate(ref["sasa"]):
        out[f"target/point_sasa_labels_{k}"] = v
    for k, v in ref["metrics"].items():
        out[f"metric/{k}"] = np.float32(v)
    store_leaves(out, "grad", weights.flax_params_to_torch(ref["grads"],
                                                           tmodel))
    stats = weights.flax_to_torch({**flat, **ref["batch_stats"]}, tmodel)
    for name, v in stats.items():
        if "running" in name:
            out[f"stats/{name}"] = v.numpy()
    for k, v in next(jax_loader_batches(8)).items():
        out[f"train8_{k}"] = v
    return out


def write_fixture():
    """Rewrite ``testdata/det6d_train_jax_ref.npz`` with ``python -c
    "import sys; sys.path.insert(0, 'tests'); import
    test_torch_det6d_train as t; t.write_fixture()"`` (a few minutes)."""
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(TRAIN_FIXTURE, **train_fixture_content())


def test_train_fixture_holds_what_the_card_reads():
    with np.load(TRAIN_FIXTURE) as ref:
        assert ref["points"].shape == (2, 16384, 4)
        assert ref["train8_points"].shape == (8, 16384, 4)
        assert [ref[f"picks_{k}"].shape[1] for k in range(3)] == [4096,
                                                                  1024, 512]
        t = ref["target/point_reg_labels"][..., 30]
        assert ((ref["target/point_cls_labels"] > 0) & (t > 0)).any()


@pytest.mark.slow
def test_train_fixture_equals_fresh_jax_run():
    ref = train_fixture_content()
    with np.load(TRAIN_FIXTURE) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in stored.files:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_train_step_matches_fixture_on_cpu():
    """The train parity phase of chip_smoke.py
    (``check_det6d_train_parity``, its tolerances in
    ``chip_smoke.DET6D_TRAIN_TOL``), here on the CPU."""
    from chip_smoke import check_det6d_train_parity

    report = check_det6d_train_parity("cpu", measure_f64=False)
    assert report["positives"] > 0 and report["pitch_positives"] > 0


@pytest.mark.slow
def test_full_width_gradients_against_float64(capsys):
    """What ``chip_smoke.DET6D_TRAIN_F64`` (and from it
    ``DET6D_TRAIN_TOL``) holds: the fixture's step evaluated by the port in
    float64 (every layer in float64, the reference's picks), against the
    JAX fp32 gradients and the port's fp32 ones, as the largest distance
    over the stored entries (JAX) or all entries (the port) of each leaf
    relative to its largest |entry|, and the same for the loss terms and
    the gradient norm. Prints both;
    both must lie within the stored distances."""
    from chip_smoke import (
        DET6D_TRAIN_F64, det6d_train_batch, det6d_train_gradients,
    )

    ref = dict(np.load(TRAIN_FIXTURE))
    batch = det6d_train_batch("cpu")
    g32, m32 = det6d_train_gradients("cpu", batch, ref, torch.float32)
    g64, m64 = det6d_train_gradients("cpu", batch, ref, torch.float64)
    jax_err = port_err = 0.0
    for name, t in g64.items():
        if f"grad/{name}" in ref:
            idx = np.arange(t.size)
            jax_g = ref[f"grad/{name}"]
        else:
            jax_g = ref[f"grad_sample/{name}"]
            idx = np.linspace(0, t.size - 1, jax_g.size).astype(np.int64)
        jax_err = max(jax_err, np.abs(jax_g - t[idx]).max()
                      / np.abs(t[idx]).max())
        # the port's every entry, as chip_smoke measures the card's
        port_err = max(port_err, np.abs(g32[name] - t).max()
                       / np.abs(t).max())
    loss_jax = max(abs(float(ref[f"metric/{k}"]) / v - 1)
                   for k, v in m64.items() if v != 0)
    loss_port = max(abs(m32[k] / v - 1) for k, v in m64.items() if v != 0)

    def norm(g):
        return np.sqrt(sum(float((x.astype(np.float64) ** 2).sum())
                           for x in g.values()))

    n64 = norm(g64)
    norm_jax = abs(float(ref["metric/grad_norm"]) / n64 - 1)
    norm_port = abs(norm(g32) / n64 - 1)
    with capsys.disabled():
        print(f"\nDet6D full-width step vs float64: gradients, largest "
              f"distance / leaf max: JAX fp32 {jax_err:.3g}, port fp32 "
              f"{port_err:.3g}; loss terms, relative: JAX fp32 "
              f"{loss_jax:.3g}, port fp32 {loss_port:.3g}; gradient norm, "
              f"relative: JAX fp32 {norm_jax:.3g}, port fp32 "
              f"{norm_port:.3g}")
    for k, (j, p) in {"grad": (jax_err, port_err),
                      "loss": (loss_jax, loss_port),
                      "grad_norm": (norm_jax, norm_port)}.items():
        assert max(j, p) <= DET6D_TRAIN_F64[k] * 1.01, k
