"""PointRCNN training (``pointrcnn.yaml``, ``pointrcnn_slopeaug.yaml``):
the PyTorch port against the JAX package on the CPU, module by module
(``PointHeadBox``'s train targets on 8- and 10-column gt boxes, the FP
module in train mode, ``PointRCNNHead``'s train branch: proposals,
sampled RoIs, targets, pooled features, and the RoI loss's gradient
through the pooled features into the point features and scores), then a
tiny PointRCNN train step with 3 Adam steps on 10-column gt boxes,
``class_agnostic_nms``, and the full-width reference the card reads.

Tolerances, each with its reason:
- labels, owning boxes, proposals, sampled RoIs and which proposal each
  is, the masks and the picks are exact (containment rounds as jitted XLA
  does, the RoIs are gathered rows);
- code targets within 1e-6 (log of the two libraries), the RoI class
  targets within 1e-5 (the 3D IoU's round-off in the two libraries,
  ``tests/test_torch_pvrcnn_train.py::test_iou_round_off_against_float64``);
- loss terms within 1e-5 relative, gradients within 1e-4 of each leaf's
  largest entry, BatchNorm statistics within 1e-5 (the Det6D train
  parity's tolerances); parameters after 3 Adam steps within 1e-5 of the
  leaf's largest entry of the JAX package's float64 steps, but for
  entries the fp32 gradient does not resolve
  (``jax_float64.check_adam_steps``).
"""

import ast
import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.models import build_network as jax_build
from de6d_tpu.models.backbones_3d.pointnet2_modules import (
    PointnetFPModule as JaxFP,
)
from de6d_tpu.models.dense_heads import point_head_box as jax_pbox
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.models.roi_heads import pointrcnn_head as jax_head
from de6d_tpu.models.roi_heads import roi_head_utils as jax_roi_utils
from de6d_tpu.ops import nms as jax_nms
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.backbones_3d.pointnet2_modules import (
    PointnetFPModule,
)
from de6d_tpu_torch.models.dense_heads import point_head_box as pbox
from de6d_tpu_torch.models.detectors.detector3d_template import DatasetSpec
from de6d_tpu_torch.models.roi_heads import pointrcnn_head, roi_head_utils
from de6d_tpu_torch.ops import nms as nms_ops
from test_pointrcnn_e2e import tiny_pointrcnn_cfg
from test_torch_det6d_train import (
    face_points, rotation, scene_batch, sloped_boxes,
)
from torch_fixtures import flatten_variables, perturb, unflatten
import jax_float64 as jf
import torch_point_train as tpt

ROOT = Path(__file__).resolve().parents[1]
PRCNN_CFG = ROOT / "configs/kitti_models/pointrcnn.yaml"
TINY_RANGE = (0.0, -16.0, -3.0, 32.0, 16.0, 4.0)
CLASSES = ("Car", "Pedestrian", "Cyclist")
MEAN_SIZE = [[3.9, 1.6, 1.56], [0.8, 0.6, 1.73], [1.76, 0.6, 1.73]]
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and ops on
    tensors above PyTorch's grain otherwise wait on OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gt_columns(gt, ncol):
    """``scene_batch``'s (B, M, 10) 9-DoF gt boxes as 10 columns or as 8
    (7-DoF box and class), classes 1, 2, 3 in turn."""
    out = gt.copy()
    real = np.any(out[..., :7] != 0, axis=-1)
    out[..., -1] = np.where(real, np.arange(out.shape[1]) % 3 + 1, 0)
    if ncol == 8:
        out = np.concatenate([out[..., :7], out[..., -1:]], -1)
    return np.ascontiguousarray(out)


def tiny_cfg():
    """The JAX package's tiny PointRCNN (``tests/test_pointrcnn_e2e.py``)
    for the 3 KITTI classes, its RoI head without BatchNorm as
    ``pointrcnn.yaml`` ships it, and a 64-proposal train NMS."""
    cfg = copy.deepcopy(dict(tiny_pointrcnn_cfg()))
    cfg["POINT_HEAD"]["TARGET_CONFIG"]["BOX_CODER_CONFIG"]["mean_size"] = (
        copy.deepcopy(MEAN_SIZE))
    roi = cfg["ROI_HEAD"]
    roi["USE_BN"] = False
    roi["NMS_CONFIG"]["TRAIN"] = {"NMS_THRESH": 0.8, "NMS_PRE_MAXSIZE": 256,
                                  "NMS_POST_MAXSIZE": 64}
    return cfg


# ---------------------------------------------------------------------
# the first stage's train targets
# ---------------------------------------------------------------------

def head_inputs(seed, ncol):
    batch = scene_batch(seed, b=2, n=400)
    rng = np.random.RandomState(seed)
    pts = batch["points"][..., :3].copy()
    valid = np.ones(pts.shape[:2], bool)
    valid[:, ::13] = False
    feats = rng.normal(0, 1, pts.shape[:2] + (24,)).astype(np.float32)
    return {"point_coords": pts, "point_valid": valid,
            "point_features": feats,
            "gt_boxes": gt_columns(batch["gt_boxes"], ncol)}


@pytest.mark.parametrize("ncol", [8, 10], ids=["8col", "10col"])
def test_point_head_box_train_targets_equal_jax(ncol):
    """``PointHeadBox`` in train mode on 7-DoF and 9-DoF gt boxes (3
    classes): class labels, owning boxes identical (containment is 9-DoF
    on 10 columns), code targets within 1e-6 and only as wide as the
    coder; logits and codes within 1e-5, BatchNorm statistics within
    1e-5; the boxes are decoded in train mode (a RoI head follows)."""
    cfg = copy.deepcopy(dict(tiny_cfg()["POINT_HEAD"]))
    d = head_inputs(31, ncol)
    jmod = jax_pbox.PointHeadBox(model_cfg=cfg, num_class=3,
                                 predict_boxes_when_training=True)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    flat = perturb(flatten_variables(jmod.init(jax.random.PRNGKey(0),
                                               dict(jd))), 31)
    ref, mut = jax.jit(lambda v, b: jmod.apply(
        v, b, train=True, mutable=["batch_stats"]))(unflatten(flat),
                                                    dict(jd))
    tmod = pbox.PointHeadBox(Config(cfg), 24, 3,
                             predict_boxes_when_training=True)
    weights.load_into(tmod, flat).train()
    got = tmod({k: T(v) for k, v in d.items()})
    for k in ("point_cls_labels", "point_box_labels"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    assert got["point_reg_labels"].shape[-1] == 8
    np.testing.assert_allclose(got["point_reg_labels"].numpy(),
                               np.asarray(ref["point_reg_labels"]),
                               rtol=1e-6, atol=1e-6)
    for k in ("point_cls_preds", "point_reg_preds", "batch_box_preds"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    stats = weights.flax_to_torch(
        {**flat, **tpt.flat(mut["batch_stats"], "batch_stats")}, tmod)
    for n, b in tmod.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[n].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    lab = np.asarray(ref["point_cls_labels"])
    assert {1, 2, 3, 0, -1} <= set(np.unique(lab).tolist())
    assert got["point_box_labels"].shape[-1] == ncol - 1


def test_point_head_box_eval_is_unchanged():
    """In eval mode the head writes no targets and decodes as before."""
    cfg = copy.deepcopy(dict(tiny_cfg()["POINT_HEAD"]))
    d = head_inputs(32, 8)
    tmod = pbox.PointHeadBox(Config(cfg), 24, 3).eval()
    with torch.no_grad():
        got = tmod({k: T(v) for k, v in d.items()})
    assert "point_cls_labels" not in got
    assert tuple(got["batch_box_preds"].shape) == (2, 400, 7)


# ---------------------------------------------------------------------
# the FP module in train mode
# ---------------------------------------------------------------------

@pytest.mark.parametrize("skip", [True, False], ids=["skip", "no_skip"])
def test_fp_module_train_mode_equals_jax(skip):
    """Output within 1e-5, the BatchNorm statistics after it within 1e-5,
    and the backward of a random cotangent into the known and unknown
    features and every parameter within 1e-4 of each one's largest
    entry (``three_interpolate``'s backward is ``group_points``'s
    scatter-add), against the JAX module run eagerly: jitted on the CPU,
    its train-mode forward lies up to 0.1 from its eager one and from a
    float64 evaluation (the port's fp32 lies 2e-6 from it), as was found
    for the SA layer's VJP (``tests/test_torch_pvrcnn_train.py::
    test_sa_layer_cotangent_equals_eager_jax``)."""
    rng = np.random.RandomState(33)
    batch = scene_batch(33, b=2, n=400)
    unknown = batch["points"][..., :3].copy()
    known = unknown[:, ::4].copy()
    kvalid = np.ones(known.shape[:2], bool)
    kvalid[1, 80:] = False
    ufeat = rng.normal(0, 1, (2, 400, 5)).astype(np.float32) if skip \
        else None
    kfeat = rng.normal(0, 1, (2, 100, 12)).astype(np.float32)
    cot = rng.normal(0, 1, (2, 400, 24)).astype(np.float32)
    jmod = JaxFP(mlp=(16, 24))
    ja = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    flat = perturb(flatten_variables(jmod.init(
        jax.random.PRNGKey(0), ja(unknown), ja(known), ja(ufeat), ja(kfeat),
        ja(kvalid))), 33)
    var = unflatten(flat)

    def loss(p, kf, uf):
        out, mut = jmod.apply({"params": p, "batch_stats": var[
            "batch_stats"]}, ja(unknown), ja(known), uf, kf, ja(kvalid),
            train=True, mutable=["batch_stats"])
        return (out * cot).sum(), (out, mut)

    (_, (ref, mut)), (gp, gk, gu) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(var["params"], ja(kfeat),
                                               ja(ufeat))
    tmod = PointnetFPModule(12 + (5 if skip else 0), (16, 24))
    weights.load_into(tmod, flat).train()
    tk = T(kfeat).requires_grad_()
    tu = None if ufeat is None else T(ufeat).requires_grad_()
    out = tmod(T(unknown), T(known), tu, tk, T(kvalid))
    (out * T(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)
    stats = weights.flax_to_torch(
        {**flat, **tpt.flat(mut["batch_stats"], "batch_stats")}, tmod)
    for n, b in tmod.named_buffers():
        np.testing.assert_allclose(b.numpy(), stats[n].numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    tpt.leaf_close(tk.grad.numpy(), np.asarray(gk), 1e-4, "known feats")
    if skip:
        tpt.leaf_close(tu.grad.numpy(), np.asarray(gu), 1e-4,
                       "unknown feats")
    want = weights.flax_params_to_torch(tpt.flat(gp, "params"), tmod)
    for n, p in tmod.named_parameters():
        tpt.leaf_close(p.grad.numpy(), want[n].numpy(), 1e-4, n)


# ---------------------------------------------------------------------
# the RoI head's train branch
# ---------------------------------------------------------------------

ROI_TARGETS = ("rois", "gt_of_rois", "gt_of_rois_local", "rcnn_cls_labels",
               "reg_valid_mask", "roi_labels", "roi_sample_valid")


def roi_inputs(seed, ncol=10):
    """What ``PointRCNNHead`` reads in train mode: points and their
    features and scores, first-stage boxes (each point's gt box jittered,
    or a random box) and logits, the gt boxes."""
    rng = np.random.RandomState(seed)
    batch = scene_batch(seed, b=2, n=512)
    pts = batch["points"][..., :3].copy()
    gt = gt_columns(batch["gt_boxes"], ncol)
    b, n = pts.shape[:2]
    boxes = np.zeros((b, n, 7), np.float32)
    boxes[..., :3] = pts + rng.normal(0, 0.3, pts.shape)
    boxes[..., 3:6] = rng.uniform(0.5, 4.0, (b, n, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, n))
    own = np.arange(n) // 60
    for bi in range(b):
        for i in np.flatnonzero(own < gt.shape[1] - 1):
            g = gt[bi, own[i], :7]
            boxes[bi, i] = g + np.concatenate([
                rng.normal(0, 0.25, 3), rng.normal(0, 0.1, 3),
                rng.normal(0, 0.1, 1)])
    valid = np.ones((b, n), bool)
    valid[:, ::29] = False
    cls = rng.normal(0, 1, (b, n, 3)).astype(np.float32)
    return {"point_coords": pts, "point_valid": valid,
            "point_features": rng.normal(0, 1, (b, n, 16)).astype(
                np.float32),
            "point_cls_scores": rng.uniform(0, 1, (b, n)).astype(np.float32),
            "batch_cls_preds": cls, "batch_box_preds": boxes.astype(
                np.float32), "gt_boxes": gt}


@pytest.fixture(scope="module")
def roi_pair():
    """The tiny RoI head of both packages in train mode on
    :func:`roi_inputs`, with the gradient of the RoI loss into the point
    features and scores."""
    cfg = copy.deepcopy(tiny_cfg()["ROI_HEAD"])
    d = roi_inputs(34)
    jmod = jax_head.PointRCNNHead(model_cfg=cfg, num_class=1)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    flat = perturb(flatten_variables(jax.jit(lambda r, b: jmod.init(
        r, b))(jax.random.PRNGKey(0), dict(jd))), 34)
    diff = ("point_features", "point_cls_scores")

    def loss(p, x):
        out = jmod.apply({"params": p}, {**jd, **x}, train=True)
        total, tb = jax_roi_utils.roi_head_loss(out["roi_targets_dict"],
                                               cfg["LOSS_CONFIG"])
        keep = {k: out[k] for k in ("rois", "roi_labels", "roi_valid",
                                    "rcnn_cls", "rcnn_reg")}
        keep["targets"] = {k: out["roi_targets_dict"][k]
                           for k in ROI_TARGETS}
        return total, (tb, keep)

    (_, (tb, keep)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(unflatten(flat)["params"],
                                             {k: jd[k] for k in diff})
    tmod = pointrcnn_head.PointRCNNHead(Config(cfg), 16, 1)
    weights.load_into(tmod, flat).train()
    td = {k: T(v) for k, v in d.items()}
    for k in diff:
        td[k].requires_grad_()
    from chip_smoke import RecordedRoIStage

    with RecordedRoIStage() as stage:
        out = tmod(dict(td))
    total, got_tb = roi_head_utils.roi_head_loss(out["roi_targets_dict"],
                                                 cfg["LOSS_CONFIG"])
    total.backward()
    return {"ref_tb": tb, "keep": keep, "gp": gp, "gx": gx, "got": out,
            "got_tb": got_tb, "td": td, "tmod": tmod,
            "props": stage.proposals[0],
            "inputs": d, "cfg": cfg}


def test_roi_head_train_proposals_and_samples_equal_jax(roi_pair):
    """``NMS_CONFIG.TRAIN``'s proposals identical to JAX's
    ``proposal_layer`` on the same boxes; the sampled RoIs (``PRNGKey(0)``
    draws), their labels and masks identical, their matched gt boxes
    where they overlap one, the RoI-local targets within 1e-6, the class
    targets within 1e-5."""
    d, got, keep = roi_pair["inputs"], roi_pair["got"], roi_pair["keep"]
    nms_cfg = roi_pair["cfg"]["NMS_CONFIG"]["TRAIN"]
    ref_p = jax.jit(lambda b: jax_roi_utils.proposal_layer(
        b, nms_cfg, 64))({k: jnp.asarray(d[k]) for k in (
            "batch_cls_preds", "batch_box_preds")})
    for k in ("rois", "roi_labels", "roi_valid"):
        np.testing.assert_array_equal(roi_pair["props"][k].numpy(),
                                      np.asarray(ref_p[k]), err_msg=k)
    assert int(roi_pair["props"]["roi_valid"].sum()) > 40
    t, rt = got["roi_targets_dict"], keep["targets"]
    for k in ("rois", "reg_valid_mask", "roi_labels", "roi_sample_valid"):
        np.testing.assert_array_equal(t[k].numpy(), np.asarray(rt[k]),
                                      err_msg=k)
    # a RoI that overlaps no gt box takes the first of equal IoUs: JAX's
    # IoU is a little above 0 where the port's is 0, so it may name
    # another box (no loss reads it)
    overlap = np.asarray(rt["rcnn_cls_labels"]) > 0
    np.testing.assert_array_equal(t["gt_of_rois"].numpy()[overlap],
                                  np.asarray(rt["gt_of_rois"])[overlap])
    np.testing.assert_allclose(t["gt_of_rois_local"].numpy()[overlap],
                               np.asarray(rt["gt_of_rois_local"])[overlap],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t["rcnn_cls_labels"].numpy(),
                               np.asarray(rt["rcnn_cls_labels"]), atol=1e-5)
    assert t["gt_of_rois"].shape[-1] == 9  # 9-DoF boxes, read as [:7]
    for k in ("rois", "roi_labels", "roi_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(keep[k]),
                                      err_msg=k)
    fg = np.asarray(rt["reg_valid_mask"])
    assert fg.sum() >= 8 and np.asarray(rt["roi_sample_valid"]).sum() >= 20


def test_roi_head_train_pooled_features_and_outputs_equal_jax(roi_pair):
    """The pooled point sets of the sampled RoIs (first hits, padded with
    the first, empty RoIs zero) equal JAX's ``roipoint_pool3d``'s, and
    ``rcnn_cls`` / ``rcnn_reg`` (the SA encoder without BatchNorm in train
    mode, empty RoIs at -1e4) within 1e-5."""
    d, got, keep = roi_pair["inputs"], roi_pair["got"], roi_pair["keep"]
    rois = np.asarray(keep["rois"])
    feats = np.concatenate([d["point_cls_scores"][..., None],
                            d["point_features"]], -1)
    ref = jax_head.roipoint_pool3d(
        jnp.asarray(d["point_coords"]), jnp.asarray(feats),
        jnp.asarray(d["point_valid"]), jnp.asarray(rois), 64)
    mine = pointrcnn_head.roipoint_pool3d(
        T(d["point_coords"]), T(feats), T(d["point_valid"]), T(rois), 64)
    np.testing.assert_array_equal(mine[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(mine[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(mine[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-5)
    for k in ("rcnn_cls", "rcnn_reg"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(keep[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    np.testing.assert_array_equal(got["roi_empty"].numpy(),
                                  np.asarray(keep["rcnn_cls"]) == -1e4)


def test_roi_loss_gradient_reaches_the_point_features(roi_pair):
    """JAX's ``roipoint_pool3d`` gathers the point features and scores
    without ``stop_gradient``, so the RoI loss's gradient reaches them
    (and, in the detector, the backbone and the first stage's class
    layers); the port's takes the same gradient: within 1e-4 of each
    one's largest entry, and not zero. The loss terms within 1e-5
    relative, the head's parameters' gradients within 1e-4."""
    ref_tb, got_tb = roi_pair["ref_tb"], roi_pair["got_tb"]
    assert set(got_tb) == set(ref_tb)
    for k in ref_tb:
        np.testing.assert_allclose(float(got_tb[k].detach()),
                                   float(ref_tb[k]), rtol=1e-5, err_msg=k)
    for k, g in roi_pair["gx"].items():
        g = np.asarray(g)
        assert np.abs(g).max() > 0, k
        tpt.leaf_close(roi_pair["td"][k].grad.numpy(), g, 1e-4, k)
    want = weights.flax_params_to_torch(tpt.flat(roi_pair["gp"], "params"),
                                        roi_pair["tmod"])
    for n, p in roi_pair["tmod"].named_parameters():
        tpt.leaf_close(p.grad.numpy(), want[n].numpy(), 1e-4, n)


# ---------------------------------------------------------------------
# a tiny PointRCNN's train step on 10-column gt boxes
# ---------------------------------------------------------------------

def sloped_scene(seed, b=2, n=512, n_gt=6, per_box=60):
    """``scene_batch``'s layout with boxes a first stage near its init
    regresses: yaws within 0.3 rad of 0, each class's mean size within 10
    %, classes 1, 2, 3 in turn; 9-DoF boxes and class (the last a zero
    pad)."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, 4), np.float32)
    for d, (lo, hi) in enumerate(((0, 32), (-16, 16), (-2, 2), (0, 1))):
        pts[..., d] = rng.uniform(lo, hi, (b, n))
    gt = np.zeros((b, n_gt, 10), np.float32)
    for bi in range(b):
        g = sloped_boxes(rng, n_gt - 1)
        cls = np.arange(n_gt - 1) % 3 + 1
        g[:, 3:6] = np.float32(MEAN_SIZE)[cls - 1] * rng.uniform(
            0.9, 1.1, (n_gt - 1, 3))
        g[:, 6] = rng.uniform(-0.3, 0.3, n_gt - 1)
        gt[bi, :-1, :9], gt[bi, :-1, 9] = g, cls
        for gi in range(n_gt - 1):
            box = g[gi].astype(np.float64)
            local = rng.uniform(-0.5, 0.5, (per_box, 3)) * box[3:6]
            sl = slice(gi * per_box, (gi + 1) * per_box)
            pts[bi, sl, :3] = local @ rotation(*box[6:9]).T + box[:3]
        faces = face_points(rng, g, 8)
        pts[bi, n - len(faces):, :3] = faces
    return {"points": pts, "points_mask": np.ones((b, n), bool),
            "gt_boxes": gt}


TARGETS = ("point_cls_labels", "point_reg_labels", "point_box_labels",
           "rois", "roi_labels", "roi_valid", "roi_targets_dict")


@pytest.fixture(scope="module")
def tiny_train():
    """After ``tests/test_sloped_point_heads.py::
    test_pointrcnn_trains_on_10col_gts``: the tiny PointRCNN of 3 classes
    on SlopeAug's 10-column gt boxes, flax's initialiser perturbed, one
    step and 3 Adam steps of both packages (``pointrcnn.yaml``'s
    optimizer), the JAX picks forced."""
    spec = dict(class_names=CLASSES, point_feature_dim=4,
                point_cloud_range=TINY_RANGE)
    cfg = tiny_cfg()
    from de6d_tpu.config import Config as JaxConfig

    jmodel = jax_build(JaxConfig(copy.deepcopy(cfg)), num_class=3,
                       dataset=JaxSpec(**spec))
    tmodel = build_network(Config(copy.deepcopy(cfg)), 3, DatasetSpec(**spec),
                           device="cpu")
    batch = sloped_scene(35)
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    flat = perturb(flatten_variables(init), seed=35)
    # box codes near 0: boxes of the class's mean size at the points, so
    # that some proposals overlap their gt box enough to be regressed
    box_out = [k for k in flat if "point_head/box_layers/Dense_1" in k]
    assert box_out
    for k in box_out:
        flat[k] = flat[k] * 0.01
    opt_cfg = tpt.opt_cfg_of(PRCNN_CFG)
    ref = tpt.jax_train_reference(jmodel, unflatten(flat), batch, opt_cfg,
                                  TARGETS)
    got = tpt.port_train_run(tmodel, flat, batch, opt_cfg, ref, TARGETS)
    return {"ref": ref, "got": got, "tmodel": tmodel, "flat": flat,
            "batch": batch, "opt_cfg": opt_cfg, "jmodel": jmodel}


def test_train_step_picks_and_targets(tiny_train):
    """The backbone's and the RoI encoder's d-fps picks identical (the
    encoder's over pooled sets padded with repeats: ties go to the lower
    index in both); point labels and owning boxes, the proposals' and
    sampled RoIs' labels and masks identical, codes within 1e-6; the RoI
    boxes, decoded from each package's fp32 first stage, within 1e-4
    relative above 1 m, so their class targets (IoUs) within 1e-4; the
    matched gt boxes identical where a RoI overlaps one."""
    tpt.certify_calls("tiny pointrcnn", tiny_train, 0.0)
    calls = tiny_train["got"]["calls"]
    assert [c["method"] for c in calls] == ["d-fps"] * 3
    ref, got = tiny_train["ref"]["targets"], tiny_train["got"]["targets"]
    for k in TARGETS[:3] + TARGETS[4:-1]:
        if k == "point_reg_labels":
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    rt, gt = ref["roi_targets_dict"].item(), got["roi_targets_dict"].item()
    for k in ("reg_valid_mask", "roi_labels", "roi_sample_valid"):
        np.testing.assert_array_equal(gt[k].detach().numpy(),
                                      np.asarray(rt[k]), err_msg=k)
    overlap = np.asarray(rt["rcnn_cls_labels"]) > 0
    np.testing.assert_array_equal(gt["gt_of_rois"].numpy()[overlap],
                                  np.asarray(rt["gt_of_rois"])[overlap])
    for a, r in ((got["rois"], ref["rois"]),
                 (gt["rois"].numpy(), np.asarray(rt["rois"]))):
        assert (np.abs(a - r) <= 1e-4 * np.maximum(1, np.abs(r))).all()
    np.testing.assert_allclose(gt["rcnn_cls_labels"].numpy(),
                               np.asarray(rt["rcnn_cls_labels"]), atol=1e-4)
    assert gt["gt_of_rois"].shape[-1] == 9
    assert (ref["point_cls_labels"] > 0).sum() >= 20
    assert np.asarray(rt["reg_valid_mask"]).sum() >= 1


def test_get_training_loss_equals_jax(tiny_train):
    """``PointRCNN.get_training_loss``: the point head's class and box
    terms and the RoI head's class, regression and corner terms within
    1e-5 relative, the gradient norm too."""
    assert set(tiny_train["ref"]["metrics"]) == {
        "point_loss_cls", "point_loss_box", "rcnn_loss_cls",
        "rcnn_loss_reg", "rcnn_loss_corner", "rcnn_loss", "loss",
        "grad_norm"}
    tpt.check_metrics(tiny_train)


def test_train_step_gradients_and_statistics(tiny_train):
    tpt.check_gradients(tiny_train)
    tpt.check_batch_stats(tiny_train)


def test_train_step_params_after_three_steps(tiny_train):
    """The loss of each step within 1e-5 relative of the JAX fp32 step's;
    the parameters after each within 1e-5 of the leaf's largest entry of
    the JAX package's float64 step from the same state (its picks and its
    fp32 proposals replayed), but for the entries the fp32 gradient does
    not resolve (``jax_float64.check_adam_steps``; measured: 18, 21 and 41
    such entries in the 3 steps, of which 0, 1 and 0 part)."""
    ref, got = tiny_train["ref"], tiny_train["got"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    assert len(jf.check_adam_steps(tiny_train, tiny_train["jmodel"],
                                   roi=True)) == 3


# ---------------------------------------------------------------------
# class_agnostic_nms
# ---------------------------------------------------------------------

@pytest.mark.parametrize("thresh", [None, 0.3], ids=["no_gate", "gate"])
def test_class_agnostic_nms_equals_jax(thresh):
    """Selected indices (padding included), counts and scores identical
    to the JAX function's on one sample's boxes, with and without a score
    gate and a validity mask; the aligned IoU raises, as the port's
    ``nms`` does."""
    rng = np.random.RandomState(36)
    n = 300
    boxes = np.zeros((n, 7), np.float32)
    boxes[:, :3] = rng.uniform(-10, 10, (n, 3))
    boxes[:, :2] = np.round(boxes[:, :2] / 3) * 3  # overlapping clusters
    boxes[:, 3:6] = rng.uniform(1, 4, (n, 3))
    boxes[:, 6] = rng.uniform(-np.pi, np.pi, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(0, 1, n) > 0.1
    cfg = {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.1, "NMS_PRE_MAXSIZE": 200,
           "NMS_POST_MAXSIZE": 40}
    from de6d_tpu.config import Config as JaxConfig

    for mask in (None, valid):
        ref = jax_nms.class_agnostic_nms(
            jnp.asarray(scores), jnp.asarray(boxes), JaxConfig(cfg),
            score_thresh=thresh,
            valid_mask=None if mask is None else jnp.asarray(mask))
        got = nms_ops.class_agnostic_nms(
            T(scores), T(boxes), cfg, score_thresh=thresh,
            valid_mask=None if mask is None else T(mask))
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert 5 < int(got[1]) <= 40
    with pytest.raises(NotImplementedError):
        nms_ops.class_agnostic_nms(T(scores), T(boxes),
                                   {**cfg, "NMS_TYPE": "nms_normal_gpu"})


# ---------------------------------------------------------------------
# the port imports nothing of the JAX package
# ---------------------------------------------------------------------

def test_port_and_chip_script_import_no_jax_statically():
    """No module of the port and neither card script names ``jax``,
    ``flax``, ``optax`` or ``de6d_tpu`` in an import statement."""
    files = sorted((ROOT / "de6d_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "sparse_conv_ab.py"]
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [(f.name, n) for n in names if n.split(".")[0] in (
                "jax", "jaxlib", "flax", "optax", "de6d_tpu")]
    assert len(files) > 50 and not bad, bad


# ---------------------------------------------------------------------
# the full-width reference for the card (which has no JAX)
# ---------------------------------------------------------------------

TRAIN_FIXTURE = ROOT / "de6d_tpu_torch/testdata/pointrcnn_train_jax_ref.npz"
BATCH_KEYS = ("points", "points_mask", "gt_boxes")
ROI_KEYS = ("rois", "gt_of_rois", "rcnn_cls_labels", "reg_valid_mask",
            "roi_labels", "roi_sample_valid", "gt_of_rois_local")


def jax_kitti_batch(cfg_path, batch_size):
    """The JAX loader's first train batch of epoch 0 on ``data/kitti``
    (``cfg_path``'s data config, augmentation on, one worker)."""
    import os

    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg
    from de6d_tpu.datasets import build_dataloader

    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        cfg = jax_cfg(str(cfg_path))
        _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size, root_path=str(
                                         ROOT / "data/kitti"),
                                     training=True, seed=0, workers=1)
    finally:
        os.chdir(cwd)
    loader.set_epoch(0)
    batch = next(iter(loader))
    return {k: np.asarray(batch[k]) for k in BATCH_KEYS}


def full_width_jax_model(cfg_path):
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg

    cfg = jax_cfg(str(cfg_path))
    return jax_build(copy.deepcopy(dict(cfg.MODEL)),
                     num_class=len(cfg.CLASS_NAMES), dataset=JaxSpec(
                         class_names=tuple(cfg.CLASS_NAMES),
                         point_feature_dim=4, point_cloud_range=tuple(
                             cfg.DATA_CONFIG.POINT_CLOUD_RANGE)))


class jax_proposals_in_batch:
    """Within the block the JAX proposal layer also writes, into the batch
    dict its train step returns, the proposals before sampling and the
    candidates they came from: a window of the best first-stage scores
    past ``NMS_PRE_MAXSIZE`` (for near-ties) and the boxes of the first
    ``NMS_PRE_MAXSIZE``."""

    def __enter__(self):
        self.orig = jax_roi_utils.proposal_layer

        def run(batch_dict, nms_cfg, num_rois):
            scores = jnp.max(jax.nn.sigmoid(jax.lax.stop_gradient(
                batch_dict["batch_cls_preds"])), axis=-1)
            boxes = jax.lax.stop_gradient(batch_dict["batch_box_preds"])
            pre = int(nms_cfg["NMS_PRE_MAXSIZE"])
            out = self.orig(batch_dict, nms_cfg, num_rois)
            s, o = jax.lax.top_k(scores, min(scores.shape[1], pre + 1024))
            out["_prop_scores"], out["_prop_order"] = s, o
            out["_prop_boxes"] = jnp.take_along_axis(boxes, o[:, :pre, None],
                                                     axis=1)
            for k in ("rois", "roi_valid", "roi_labels"):
                out["_proposal_" + k] = out[k]
            return out

        jax_roi_utils.proposal_layer = run
        return self

    def __exit__(self, *exc):
        jax_roi_utils.proposal_layer = self.orig


PROPOSAL_KEYS = ("_prop_scores", "_prop_order", "_prop_boxes",
                 "_proposal_rois", "_proposal_roi_valid",
                 "_proposal_roi_labels")


def train_fixture_content():
    """The JAX fp32 PointRCNN step (``pointrcnn.yaml``) from flax's
    initialisers (``chip_smoke.point_train_model``) on the JAX loader's
    first batch of 2 on ``data/kitti``: every sampling call's picks (the
    backbone's 4, the RoI encoder's 2), the point targets, the proposal
    layer's candidates (a window of the best points by score, their
    boxes), proposals and which point each came from, the sampled RoIs
    (and which proposal each is) with their targets, loss terms,
    gradient norm, gradients and BatchNorm statistics after it, in the
    port's layout."""
    from chip_smoke import POINTRCNN_TRAIN, point_train_model
    from test_torch_det6d_dr import point_fixture
    from test_torch_pointpillar_train import store_leaves
    from test_torch_pvrcnn_train import row_index

    spec = POINTRCNN_TRAIN
    tmodel = point_train_model("cpu", spec)
    flat = weights.torch_to_flax(tmodel)
    jmodel = full_width_jax_model(spec.cfg)
    batch = jax_kitti_batch(spec.cfg, 2)
    with jax_proposals_in_batch():
        ref = tpt.jax_step_reference(
            jmodel, unflatten(flat), batch,
            spec.targets + PROPOSAL_KEYS + ("roi_targets_dict",))
    t = ref["targets"]
    roi = t.pop("roi_targets_dict").item()
    prop = {k: np.asarray(t.pop(k)) for k in PROPOSAL_KEYS}
    out = point_fixture(batch, ref, flat, tmodel, store_leaves)
    out["prop_order"] = prop["_prop_order"].astype(np.int32)
    out["prop_scores"] = prop["_prop_scores"]
    valid = prop["_proposal_roi_valid"]
    out["proposals"] = prop["_proposal_rois"]
    out["proposal_valid"] = valid
    out["proposal_labels"] = prop["_proposal_roi_labels"].astype(np.int32)
    rows = row_index(prop["_proposal_rois"], prop["_prop_boxes"])
    out["proposal_idx"] = np.where(valid, np.take_along_axis(
        out["prop_order"], rows, axis=1), 0).astype(np.int32)
    sampled = np.asarray(roi["rois"])
    out["roi_sample_idx"] = row_index(sampled, prop["_proposal_rois"])
    for k in ROI_KEYS:
        out[f"target/{k}"] = np.asarray(roi[k])
    return out


def write_train_fixture():
    """Rewrite ``testdata/pointrcnn_train_jax_ref.npz`` with ``python -c
    "import sys; sys.path.insert(0, 'tests'); import jax;
    jax.config.update('jax_platforms', 'cpu'); import
    test_torch_pointrcnn_train as t; t.write_train_fixture()"``."""
    np.savez_compressed(TRAIN_FIXTURE, **train_fixture_content())


def test_train_fixture_holds_what_the_card_reads():
    """The card's ``parity / train_pointrcnn`` and ``train / pointrcnn``
    read these keys: the loader's first batch of 2, 6 sampling calls
    (the backbone's 4096, 1024, 256, 64; the RoI encoder's 128 and 32 over
    2 x 128 RoIs), the proposals and the sampled RoIs with their
    targets; the fixture no larger than PV-RCNN's."""
    with np.load(TRAIN_FIXTURE) as ref:
        assert ref["points"].shape == (2, 16384, 4)
        assert [ref[f"picks_{k}"].shape for k in range(6)] == [
            (2, 4096), (2, 1024), (2, 256), (2, 64), (256, 128), (256, 32)]
        assert (ref["target/point_cls_labels"] > 0).sum() > 0
        assert ref["proposals"].shape == (2, 512, 7)
        assert ref["target/rois"].shape == (2, 128, 7)
        assert ref["roi_sample_idx"].shape == (2, 128)
        assert "metric/rcnn_loss_corner" in ref.files
    assert TRAIN_FIXTURE.stat().st_size <= (
        ROOT / "de6d_tpu_torch/testdata/pvrcnn_train_jax_ref.npz").stat(
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
    """The ``parity / train_pointrcnn`` phase of chip_smoke.py on the
    CPU."""
    from chip_smoke import POINTRCNN_TRAIN, check_point_train_parity

    r = check_point_train_parity("cpu", POINTRCNN_TRAIN, measure_f64=False)
    assert r["positives"] > 0 and r["roi_stage"] is not None


@pytest.mark.slow
def test_full_width_train_step_against_float64(capsys):
    """What ``chip_smoke.POINTRCNN_TRAIN.f64`` holds (see
    ``test_torch_det6d_dr.print_f64_distances``; the float64 step replays
    the fixture's proposals and sampled RoIs)."""
    from chip_smoke import POINTRCNN_TRAIN
    from test_torch_det6d_dr import print_f64_distances

    print_f64_distances(POINTRCNN_TRAIN, capsys)
