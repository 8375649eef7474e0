"""IA-SSD training (``IA-SSD.yaml``): the PyTorch port against the JAX
package on the CPU, module by module (the bin-orientation coder's encode
at the bin edges, centerness, ``assign_iassd_targets`` in its three
modes, ``IASSD_Head.assign_targets``, ``iassd_head_loss`` with its
gradients), then a tiny IA-SSD train step with 3 Adam steps, and the
full-width reference the card reads.

Tolerances, each with its reason:
- labels, box indices, owning boxes, the bin one-hots and the picks are
  exact (containment and the bins round as jitted XLA does);
- code targets within 1e-6 (log of the two libraries), centerness
  within 1e-6 (the cube root of the two libraries);
- single losses and the train step's loss terms within 1e-5 relative,
  gradients within 1e-4 of each leaf's largest entry, BatchNorm
  statistics within 1e-5, parameters after 3 Adam steps within 1e-5 (the
  Det6D train parity's tolerances); the centre-aware top-k's scores
  within 1e-5 where the picks part (a certified near-tie).
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.models import build_network as jax_build
from de6d_tpu.models.dense_heads import iassd_head as jax_head
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.utils import box_coder_utils as jax_coders
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.dense_heads import iassd_head as head
from de6d_tpu_torch.models.detectors.detector3d_template import DatasetSpec
from de6d_tpu_torch.utils import box_coder_utils
from test_iassd import _tiny_iassd_cfg
from test_torch_det6d_train import _coder_inputs, _target_inputs, scene_batch
from torch_fixtures import flatten_variables, perturb, unflatten
import torch_point_train as tpt

ROOT = Path(__file__).resolve().parents[1]
IASSD_CFG = ROOT / "configs/kitti_models/IA-SSD.yaml"
TINY_RANGE = (0.0, -16.0, -3.0, 32.0, 16.0, 4.0)
SPEC = dict(class_names=("Car", "Pedestrian"), point_feature_dim=4,
            point_cloud_range=TINY_RANGE)
CODER = dict(angle_bin_num=12, use_mean_size=True,
             mean_size=[[3.9, 1.6, 1.56], [0.8, 0.6, 1.73]])
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and ops on
    tensors above PyTorch's grain otherwise wait on OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seven_dof(gt):
    """(B, M, 10) 9-DoF gt boxes → (B, M, 8), class 2 on every third box."""
    out = np.concatenate([gt[..., :7], gt[..., -1:]], -1)
    out[:, ::3, -1] = np.where(out[:, ::3, -1] > 0, 2, 0)
    return out


def test_bin_ori_coder_encode_equals_jitted_jax():
    """Yaws at and around every bin edge and centre of [-2 pi, 2 pi] and at
    the clamp (pi - 1e-5): the one-hot bins identical, offsets and
    residuals within 1e-6."""
    boxes, pts = _coder_inputs(21)
    boxes = boxes[:, :7].copy()
    boxes[:8, 6] = np.float32([np.pi, -np.pi, np.pi - 1e-5, -np.pi + 1e-5,
                               3.2, -3.2, 0.0, 1e-7])
    cls = (np.arange(len(boxes)) % 2 + 1).astype(np.int32)
    ref = np.asarray(jax.jit(lambda b, p, c: jax_coders.
                             PointResidual_BinOri_Coder(**CODER).encode(
                                 b, p, c))(boxes, pts, cls))
    coder = box_coder_utils.PointResidual_BinOri_Coder(**CODER)
    got = coder.encode(T(boxes), T(pts), T(cls)).numpy()
    assert got.shape == ref.shape == (len(boxes), 30)
    np.testing.assert_array_equal(got[:, 6:18], ref[:, 6:18])
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    back = coder.decode(T(got), T(pts), T(cls)).numpy()
    d = np.abs(back[:, 6] - np.clip(boxes[:, 6], -np.pi + 1e-5,
                                    np.pi - 1e-5))
    assert np.minimum(d, 2 * np.pi - d).max() < 1e-5


def test_centerness_equals_jax():
    pts, valid, gt = _target_inputs(22)
    owner = gt[:, np.arange(pts.shape[1]) % gt.shape[1], :8].reshape(-1, 8)
    p = pts.reshape(-1, 3) * 0.1 + owner[:, :3] * 0.9
    ref = np.asarray(jax.jit(jax_head._centerness)(p, owner))
    got = head._centerness(T(p), T(owner)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert (ref > 0.3).any()


MODES = {"ignore": dict(set_ignore_flag=True),
         "ex_gt": dict(use_ex_gt_assign=True),
         "plain": dict(set_ignore_flag=False)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_assign_iassd_targets_equals_jitted_jax(mode):
    """The three assignments (extended, tight with an ignore ring, tight)
    on 2 classes: labels, box indices and owning boxes identical, codes
    within 1e-6."""
    pts, valid, gt = _target_inputs(23)
    gt = seven_dof(gt)
    kw = dict(extra_width=[1.0, 1.0, 1.0], num_class=2, **MODES[mode])
    ref = jax.jit(lambda p, v, g: jax_head.assign_iassd_targets(
        p, v, g, box_coder=jax_coders.PointResidual_BinOri_Coder(**CODER),
        ret_box_labels=True, **kw))(pts, valid, gt)
    got = head.assign_iassd_targets(
        T(pts), T(valid), T(gt),
        box_coder=box_coder_utils.PointResidual_BinOri_Coder(**CODER),
        ret_box_labels=True, **kw)
    assert set(got) == set(ref)
    for k in ("cls_labels", "box_idx", "gt_box_of_points"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    np.testing.assert_allclose(got["box_labels"].numpy(),
                               np.asarray(ref["box_labels"]), rtol=1e-6,
                               atol=1e-6)
    lab = np.asarray(ref["cls_labels"])
    assert (lab == 2).any() and (lab == 1).any()
    assert (lab == -1).any() == (mode == "ignore")


def head_batch(seed, num_class=2):
    """What the head's targets and loss read, on random centres around the
    boxes, their vote origins, three encoder layers (two with confidence
    logits) and random predictions."""
    rng = np.random.RandomState(seed)
    pts, valid, gt = _target_inputs(seed)
    gt = seven_dof(gt)
    b, n = pts.shape[:2]
    f32 = np.float32
    origin = pts + rng.normal(0, 0.8, pts.shape).astype(f32)
    offsets = (pts - origin).astype(f32)
    return {
        "gt_boxes": gt, "centers": pts, "centers_valid": valid,
        "centers_origin": origin, "ctr_offsets": offsets,
        "encoder_coords": [pts, pts[:, ::2].copy(), pts[:, ::4].copy()],
        "encoder_valid": [valid, valid[:, ::2].copy(),
                          valid[:, ::4].copy()],
        "sa_ins_preds": [None, rng.randn(b, n // 2, num_class).astype(f32),
                         rng.randn(b, (n + 3) // 4, num_class).astype(f32)],
        "center_cls_preds": rng.randn(b, n, num_class).astype(f32),
        "center_box_preds": (rng.randn(b, n, 30) * 0.5).astype(f32),
        "box_iou3d_preds": rng.rand(b, n, 1).astype(f32),
    }


def head_cfg(iou=True):
    cfg = copy.deepcopy(_tiny_iassd_cfg()["POINT_HEAD"])
    cfg["TARGET_CONFIG"]["BOX_CODER_CONFIG"] = dict(CODER)
    cfg["LOSS_CONFIG"]["IOU3D_REGULARIZATION"] = iou
    return cfg


def jax_head_module(cfg, num_class=2):
    return jax_head.IASSD_Head(model_cfg=cfg, num_class=num_class)


def test_head_assign_targets_equals_jax():
    """``IASSD_Head.assign_targets``: the centres' (ignore ring, codes),
    the vote origins' (extended) and the two confidence layers' instance
    labels (the first tight with a ring, the second extended)."""
    cfg = head_cfg()
    b = head_batch(24)
    jb = {k: v if not isinstance(v, list) else [
        None if x is None else jnp.asarray(x) for x in v]
        for k, v in b.items()}
    ref = jax.jit(lambda d: jax_head_module(cfg).apply(
        {}, d, method=jax_head.IASSD_Head.assign_targets))(jb)
    tmod = head.IASSD_Head(Config(cfg), 16, 2)
    tb = {k: T(v) if isinstance(v, np.ndarray) else [
        None if x is None else T(x) for x in v] for k, v in b.items()}
    got = tmod.assign_targets(tb)
    assert set(got) == set(ref)
    for k, r in ref.items():
        g = got[k]
        if isinstance(r, list):
            assert [x is None for x in g] == [x is None for x in r]
            pairs = [(x, y) for x, y in zip(g, r) if y is not None]
        else:
            pairs = [(g, r)]
        for x, y in pairs:
            if k == "center_box_labels":
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(x.numpy(), np.asarray(y),
                                              err_msg=k)
    sa = [np.asarray(x) for x in ref["sa_ins_labels"] if x is not None]
    assert (sa[0] == -1).any() and not (sa[1] == -1).any()


@pytest.mark.parametrize("iou", [True, False], ids=["iou", "no_iou"])
def test_iassd_head_loss_equals_jax(iou):
    """Every term of ``iassd_head_loss`` (contextual vote, centerness-
    scaled class, both instance-aware layers, bin-orientation box,
    corner, IoU) within 1e-5 relative; the gradients into the predictions,
    the centres and the offsets within 1e-5 of each one's largest."""
    cfg = head_cfg(iou)
    b = head_batch(25)
    tmod = head.IASSD_Head(Config(cfg), 16, 2)
    tb = {k: T(v) if isinstance(v, np.ndarray) else [
        None if x is None else T(x) for x in v] for k, v in b.items()}
    targets = tmod.assign_targets(tb)
    coder = box_coder_utils.PointResidual_BinOri_Coder(**CODER)
    diff = ("center_cls_preds", "center_box_preds", "box_iou3d_preds",
            "centers", "ctr_offsets")
    preds = {k: b[k] for k in diff}

    def inputs(p, tg, to_dev, sa_preds):
        d = {**tg, **p, "centers_origin": to_dev(b["centers_origin"]),
             "encoder_coords": [to_dev(x) for x in b["encoder_coords"]],
             "sa_ins_preds": sa_preds}
        d["point_box_preds"] = coder_of(d)
        return d

    def jax_loss(p, sa_preds):
        tg = {k: ([None if x is None else jnp.asarray(x.numpy())
                   for x in v] if isinstance(v, list)
                  else jnp.asarray(v.numpy())) for k, v in targets.items()}
        d = {**tg, **p, "centers_origin": jnp.asarray(b["centers_origin"]),
             "encoder_coords": [jnp.asarray(x) for x in b["encoder_coords"]],
             "sa_ins_preds": sa_preds}
        jc = jax_coders.PointResidual_BinOri_Coder(**CODER)
        d["point_box_preds"] = jc.decode(
            d["center_box_preds"], d["centers"],
            jnp.argmax(d["center_cls_preds"], -1) + 1)
        return jax_head.iassd_head_loss(d, cfg, 2)

    def coder_of(d):
        return coder.decode(d["center_box_preds"], d["centers"],
                            torch.argmax(d["center_cls_preds"], -1) + 1)

    sa_np = [x for x in b["sa_ins_preds"] if x is not None]
    (_, ref_tb), (ref_g, ref_sa) = jax.jit(jax.value_and_grad(
        lambda p, s: jax_loss(p, [None] + s), argnums=(0, 1),
        has_aux=True))({k: jnp.asarray(v) for k, v in preds.items()},
                       [jnp.asarray(x) for x in sa_np])
    tp = {k: T(v).requires_grad_() for k, v in preds.items()}
    ts = [T(x).requires_grad_() for x in sa_np]
    loss, tb_got = head.iassd_head_loss(
        inputs(tp, targets, T, [None] + ts), Config(cfg), 2)
    loss.backward()
    assert set(tb_got) == set(ref_tb)
    want = {"center_origin_loss_reg", "center_loss_cls", "sa0_loss_ins",
            "sa1_loss_ins", "sa_loss_ins", "center_loss_box",
            "corner_loss_reg", "point_loss"} | (
                {"iou3d_loss_reg"} if iou else set())
    assert set(ref_tb) == want
    for k in ref_tb:
        np.testing.assert_allclose(float(tb_got[k]), float(ref_tb[k]),
                                   rtol=1e-5, err_msg=k)
    for k, g in ref_g.items():
        got = tp[k].grad  # None where no term reads it (JAX: zeros)
        got = np.zeros(g.shape, np.float32) if got is None else got.numpy()
        tpt.leaf_close(got, np.asarray(g), 1e-5, k)
    for t, g in zip(ts, ref_sa):
        tpt.leaf_close(t.grad.numpy(), np.asarray(g), 1e-5, "sa_ins_preds")


# ---------------------------------------------------------------------
# a tiny model's train step
# ---------------------------------------------------------------------

TARGETS = ("center_cls_labels", "center_box_labels",
           "center_gt_box_of_points", "center_origin_cls_labels",
           "gt_box_of_center_origin", "sa_ins_labels")


def tiny_cfg():
    """The JAX package's tiny IA-SSD (``tests/test_iassd.py``, IoU branch
    on) with IA-SSD.yaml's 1-class coder."""
    return copy.deepcopy(_tiny_iassd_cfg())


@pytest.fixture(scope="module")
def tiny_train():
    spec = dict(SPEC, class_names=("Car",))
    cfg = tiny_cfg()
    jmodel = jax_build(Config(copy.deepcopy(cfg)), num_class=1,
                       dataset=JaxSpec(**spec))
    tmodel = build_network(Config(copy.deepcopy(cfg)), 1, DatasetSpec(**spec),
                           device="cpu")
    batch = scene_batch(26)
    batch["gt_boxes"] = np.concatenate([batch["gt_boxes"][..., :7],
                                        batch["gt_boxes"][..., -1:]], -1)
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in batch.items()})
    flat = perturb(flatten_variables(init), seed=8)
    vote = [k for k in flat if "sa_modules_3/Dense_1" in k]
    assert vote  # the vote layer's last Dense: votes near their origins
    for k in vote:
        flat[k] = flat[k] * 0.01
    opt_cfg = tpt.opt_cfg_of(IASSD_CFG)
    ref = tpt.jax_train_reference(jmodel, unflatten(flat), batch, opt_cfg,
                                  TARGETS)
    got = tpt.port_train_run(tmodel, flat, batch, opt_cfg, ref, TARGETS)
    return {"ref": ref, "got": got, "tmodel": tmodel, "flat": flat,
            "batch": batch, "opt_cfg": opt_cfg}


def test_train_step_picks_and_targets(tiny_train):
    """D-FPS picks identical, the centre-aware top-k's equal or parted at
    a certified near-tie; every label and owning box identical, codes
    within 1e-6."""
    tpt.certify_calls("tiny ia_ssd", tiny_train, 1e-5)
    ref, got = tiny_train["ref"]["targets"], tiny_train["got"]["targets"]
    for k in TARGETS:
        r, g = ref[k], got[k]
        if k == "sa_ins_labels":
            assert [x is None for x in g] == [x is None for x in r]
            for x, y in zip(g, r):
                if y is not None:
                    np.testing.assert_array_equal(x, y)
        elif k == "center_box_labels":
            np.testing.assert_allclose(g, r, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(g, r, err_msg=k)
    assert (ref["center_cls_labels"] > 0).sum() >= 4


def test_train_step_losses_gradients_and_statistics(tiny_train):
    tpt.check_metrics(tiny_train)
    assert {"center_origin_loss_reg", "sa_loss_ins", "iou3d_loss_reg",
            "corner_loss_reg", "grad_norm"} <= set(
                tiny_train["ref"]["metrics"])
    tpt.check_gradients(tiny_train)
    tpt.check_batch_stats(tiny_train)


def test_train_step_params_after_three_steps(tiny_train):
    tpt.check_three_steps(tiny_train)


# ---------------------------------------------------------------------
# the full-width reference for the card (which has no JAX)
# ---------------------------------------------------------------------

TRAIN_FIXTURE = ROOT / "de6d_tpu_torch/testdata/iassd_train_jax_ref.npz"
BATCH_KEYS = ("points", "points_mask", "gt_boxes")


def jax_kitti_batch(batch_size=2):
    """The JAX loader's first train batch of epoch 0 on ``data/kitti``
    (``IA-SSD.yaml``'s data config, augmentation on, one worker)."""
    import os

    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg
    from de6d_tpu.datasets import build_dataloader

    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        cfg = jax_cfg(str(IASSD_CFG))
        _, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                     batch_size, root_path=str(
                                         ROOT / "data/kitti"),
                                     training=True, seed=0, workers=1)
    finally:
        os.chdir(cwd)
    loader.set_epoch(0)
    batch = next(iter(loader))
    return {k: np.asarray(batch[k]) for k in BATCH_KEYS}


def train_fixture_content():
    """The JAX fp32 IA-SSD step from flax's initialisers
    (``chip_smoke.point_train_model``) on :func:`jax_kitti_batch`: every
    sampling call's picks and scores, the vote centres (which
    ``chip_smoke.forced_votes`` replays), targets, loss terms, gradient norm,
    gradients and BatchNorm statistics after it in the port's layout; and
    the loader's first batch of 8 (``train8_*``, the card's train
    phase's)."""
    from chip_smoke import IASSD_TRAIN, point_train_model
    from test_torch_det6d_dr import point_fixture
    from test_torch_pointpillar_train import store_leaves

    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg

    tmodel = point_train_model("cpu", IASSD_TRAIN)
    flat = weights.torch_to_flax(tmodel)
    cfg = jax_cfg(str(IASSD_CFG))
    jmodel = jax_build(copy.deepcopy(dict(cfg.MODEL)), num_class=1,
                       dataset=JaxSpec(
                           class_names=tuple(cfg.CLASS_NAMES),
                           point_feature_dim=4, point_cloud_range=tuple(
                               cfg.DATA_CONFIG.POINT_CLOUD_RANGE)))
    batch = jax_kitti_batch()
    ref = tpt.jax_step_reference(jmodel, unflatten(flat), batch,
                                 IASSD_TRAIN.targets + ("centers",))
    centres = ref["targets"].pop("centers")
    out = point_fixture(batch, ref, flat, tmodel, store_leaves)
    out["centers"] = centres
    for k, v in jax_kitti_batch(8).items():
        out[f"train8_{k}"] = v
    return out


def write_train_fixture():
    """Rewrite ``testdata/iassd_train_jax_ref.npz`` with ``python -c
    "import sys; sys.path.insert(0, 'tests'); import jax;
    jax.config.update('jax_platforms', 'cpu'); import
    test_torch_iassd_train as t; t.write_train_fixture()"`` (~1 min)."""
    np.savez_compressed(TRAIN_FIXTURE, **train_fixture_content())


def test_train_fixture_holds_what_the_card_reads():
    with np.load(TRAIN_FIXTURE) as ref:
        assert ref["points"].shape == (2, 16384, 4)
        assert ref["train8_points"].shape == (8, 16384, 4)
        assert [ref[f"picks_{k}"].shape[1] for k in range(4)] == [
            4096, 1024, 512, 256]
        assert (ref["target/center_cls_labels"] > 0).sum() > 0
        assert "metric/center_origin_loss_reg" in ref.files
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
    """The ``parity / train_ia_ssd`` phase of chip_smoke.py on the CPU."""
    from chip_smoke import IASSD_TRAIN, check_point_train_parity

    r = check_point_train_parity("cpu", IASSD_TRAIN, measure_f64=False)
    assert r["positives"] > 0


@pytest.mark.slow
def test_full_width_train_step_against_float64(capsys):
    """What ``chip_smoke.IASSD_TRAIN.f64`` holds (see
    ``test_torch_det6d_dr.print_f64_distances``)."""
    from chip_smoke import IASSD_TRAIN
    from test_torch_det6d_dr import print_f64_distances

    print_f64_distances(IASSD_TRAIN, capsys)
