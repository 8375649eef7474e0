"""PointRCNN inference: the PyTorch port against the JAX package on the
same inputs and the same weights (drawn from a numpy seed by
``de6d_tpu_torch.weights.seeded_flax`` and unflattened into the JAX
model's variables), fp32 on the CPU.

3-NN indices, containment masks, pooled point sets, FPS picks and NMS
selections are compared exactly. Floats: dense sums run in another order
in XLA and PyTorch, and cos/sin/exp/atan2 round differently, so fp32
values differ by a few ulps; the ops and layers are held to 1e-5 and the
tiny model's RoIs, ``rcnn_cls`` and detections to 1e-4, the tolerances
of the other two parity tests. Counts and labels must be equal.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from de6d_tpu.models import build_network as jax_build
from de6d_tpu.models.backbones_3d.pointnet2_modules import (
    PointnetFPModule as JaxFP,
)
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.models.detectors.detector3d_template import (
    post_processing as jax_post_processing,
)
from de6d_tpu.models.roi_heads import pointrcnn_head as jax_head
from de6d_tpu.models.roi_heads import roi_head_utils as jax_roi_utils
from de6d_tpu.ops import ball_query as jax_bq
from de6d_tpu.ops import geometry as jax_geo
from de6d_tpu.utils import box_coder_utils as jax_coders
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config, cfg_from_yaml_file
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.backbones_3d.pointnet2_modules import (
    PointnetFPModule,
)
from de6d_tpu_torch.models.detectors.detector3d_template import (
    DatasetSpec, post_processing,
)
from de6d_tpu_torch.models.roi_heads import pointrcnn_head, roi_head_utils
from de6d_tpu_torch.ops import ball_query as bq
from de6d_tpu_torch.ops import geometry
from de6d_tpu_torch.utils.box_coder_utils import PointResidualCoder
from test_pointrcnn_e2e import tiny_pointrcnn_cfg
from test_torch_det6d import record_jax_picks, scene
from torch_fixtures import flatten_variables, perturb, unflatten

ROOT = Path(__file__).resolve().parents[1]
FULL = ROOT / "configs/kitti_models/pointrcnn.yaml"
FIXTURE = ROOT / "de6d_tpu_torch/testdata/pointrcnn_jax_ref.npz"
OUT_KEYS = ("pred_boxes", "pred_scores", "pred_labels", "pred_count")
TINY_RANGE = (0.0, -16.0, -3.0, 32.0, 16.0, 1.0)
TINY_SEED = 3
TOL = 1e-4
OP_TOL = 1e-5
N_TOP_BOXES = 1000  # stage-1 boxes the reference stores per scan


def _roi_boxes(rng, b, r):
    """Boxes around scene points: centres in TINY_RANGE, KITTI-like sizes."""
    boxes = np.zeros((b, r, 7), np.float32)
    for d in range(3):
        boxes[..., d] = rng.uniform(TINY_RANGE[d], TINY_RANGE[d + 3], (b, r))
    boxes[..., 3:6] = rng.uniform(1.0, 8.0, (b, r, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, r))
    return boxes


# ---------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------

def test_three_nn_and_interpolation_equal_jax():
    """Indices exact (coincident queries and duplicated known points make
    ties; first index wins), distances, weights and features to 1e-5."""
    rng = np.random.RandomState(0)
    b, m, n = 2, 700, 300
    known = rng.uniform(-40, 70, (b, n, 3)).astype(np.float32)
    unknown = np.concatenate([
        known[:, :200] + rng.normal(0, 0.3, (b, 200, 3)).astype(np.float32),
        rng.uniform(-40, 70, (b, m - 200, 3)).astype(np.float32)], axis=1)
    unknown[:, :50] = known[:, :50]
    known[:, 100:110] = known[:, 90:100]
    valid = np.ones((b, n), bool)
    valid[1, 250:] = False
    feats = rng.normal(0, 1, (b, n, 16)).astype(np.float32)
    ref_d, ref_i = jax_bq.three_nn(jnp.asarray(unknown), jnp.asarray(known),
                                   jnp.asarray(valid))
    d, i = bq.three_nn(torch.from_numpy(unknown), torch.from_numpy(known),
                       torch.from_numpy(valid))
    assert i.dtype == torch.int32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ref_i))
    np.testing.assert_allclose(d.numpy(), np.asarray(ref_d), rtol=OP_TOL,
                               atol=OP_TOL)
    assert int((i[1] >= 250).sum()) == 0 and float(d[:, :50, 0].max()) == 0
    w = bq.three_nn_interpolate_weights(d)
    ref_w = jax_bq.three_nn_interpolate_weights(ref_d)
    np.testing.assert_allclose(w.numpy(), np.asarray(ref_w), rtol=OP_TOL,
                               atol=OP_TOL)
    got = bq.three_interpolate(torch.from_numpy(feats), i, w)
    ref = jax_bq.three_interpolate(jnp.asarray(feats), ref_i, ref_w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=OP_TOL,
                               atol=OP_TOL)
    no_mask = bq.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    ref_no = jax_bq.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    np.testing.assert_array_equal(no_mask[1].numpy(), np.asarray(ref_no[1]))


def test_points_in_boxes_mask_equals_jax():
    """Exact, with points put on box faces (inside by the +1e-6 margin)
    and just outside them."""
    rng = np.random.RandomState(1)
    pts, _ = scene(1, 1, 2000, TINY_RANGE)
    xyz = pts[0, :, :3].copy()
    boxes = _roi_boxes(rng, 1, 40)[0]
    boxes[:4, 6] = 0.0
    for k in range(4):  # on the +x face of an axis-aligned box, and past it
        xyz[2 * k] = boxes[k, :3] + [boxes[k, 3] / 2, 0.1, 0.1]
        xyz[2 * k + 1] = boxes[k, :3] + [boxes[k, 3] / 2 + 1e-3, 0.1, 0.1]
    ref = np.asarray(jax_geo.points_in_boxes_mask(jnp.asarray(xyz),
                                                  jnp.asarray(boxes)))
    got = geometry.points_in_boxes_mask(torch.from_numpy(xyz),
                                        torch.from_numpy(boxes)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() > 500 and all(got[k, 2 * k] for k in range(4))
    assert not any(got[k, 2 * k + 1] for k in range(4))
    big = geometry.enlarge_box3d(torch.from_numpy(boxes), (0.2, 0.3, 0.4))
    ref_big = jax_geo.enlarge_box3d(jnp.asarray(boxes), (0.2, 0.3, 0.4))
    np.testing.assert_array_equal(big.numpy(), np.asarray(ref_big))
    # 9-DoF boxes (ported with Det6D training) with zero pitch and roll
    # contain what their 7-DoF boxes contain
    nine = np.concatenate([boxes, np.zeros((len(boxes), 2), np.float32)], 1)
    np.testing.assert_array_equal(geometry.points_in_boxes_mask(
        torch.from_numpy(xyz), torch.from_numpy(nine)).numpy(), ref)


def test_rotate_points_along_z_rounds_like_xla():
    rng = np.random.RandomState(2)
    pts = rng.uniform(-5, 5, (50, 300, 4)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, 50).astype(np.float32)
    ref = np.asarray(jax.jit(jax_geo.rotate_points_along_z)(
        jnp.asarray(pts), jnp.asarray(ang)))
    got = geometry.rotate_points_along_z(torch.from_numpy(pts),
                                         torch.from_numpy(ang)).numpy()
    # cos and sin differ by an ulp between the two libraries for a few
    # angles; where they agree the rotation is bit-equal
    same = (np.cos(ang) == np.asarray(jnp.cos(jnp.asarray(ang)))) & (
        np.sin(ang) == np.asarray(jnp.sin(jnp.asarray(ang))))
    tc, ts = torch.cos(torch.from_numpy(ang)), torch.sin(torch.from_numpy(ang))
    same &= (tc.numpy() == np.cos(ang)) & (ts.numpy() == np.sin(ang))
    assert same.sum() > 25
    np.testing.assert_array_equal(got[same], ref[same])
    np.testing.assert_allclose(got, ref, rtol=OP_TOL, atol=OP_TOL)


@pytest.mark.parametrize("num_sampled", [16, 64])
def test_roipoint_pool3d_equals_jax(num_sampled):
    """Pooled sets (first hits in point order, padded with the first),
    empty flags exact; local coordinates and features to 1e-5."""
    rng = np.random.RandomState(3)
    pts, valid = scene(3, 2, 1500, TINY_RANGE, n_valid=(1500, 1100))
    xyz = np.ascontiguousarray(pts[..., :3])
    feats = rng.normal(0, 1, (2, 1500, 5)).astype(np.float32)
    rois = _roi_boxes(rng, 2, 30)
    rois[:, :3, 3:6] = 0.01  # RoIs without points
    ref = jax_head.roipoint_pool3d(
        jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(valid),
        jnp.asarray(rois), num_sampled)
    got = pointrcnn_head.roipoint_pool3d(
        torch.from_numpy(xyz), torch.from_numpy(feats),
        torch.from_numpy(valid), torch.from_numpy(rois), num_sampled)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    # features are gathered rows: equal sets give equal bits
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                               rtol=OP_TOL, atol=OP_TOL)
    empty = got[2].numpy()
    assert empty[:, :3].all() and not empty.all()
    assert not got[0][got[2]].any() and not got[1][got[2]].any()


@pytest.mark.parametrize("mean", [True, False], ids=["mean_size", "no_mean"])
def test_point_residual_coder_decode_equals_jax(mean):
    cfg = dict(use_mean_size=mean,
               mean_size=[[3.9, 1.6, 1.56], [0.8, 0.6, 1.73],
                          [1.76, 0.6, 1.73]])
    rng = np.random.RandomState(4)
    enc = rng.normal(0, 1, (2, 64, 8)).astype(np.float32)
    pts = rng.uniform(-20, 20, (2, 64, 3)).astype(np.float32)
    cls = rng.randint(1, 4, (2, 64))
    ref = np.asarray(jax_coders.PointResidualCoder(**cfg).decode(
        jnp.asarray(enc), jnp.asarray(pts), jnp.asarray(cls)))
    coder = PointResidualCoder(**cfg)
    got = coder.decode(torch.from_numpy(enc), torch.from_numpy(pts),
                       torch.from_numpy(cls)).numpy()
    assert got.shape == (2, 64, 7) and coder.code_size == 8
    np.testing.assert_allclose(got, ref, rtol=OP_TOL, atol=OP_TOL)


def test_rcnn_box_decode_equals_jax():
    rng = np.random.RandomState(5)
    rois = _roi_boxes(rng, 2, 30)
    reg = rng.normal(0, 0.5, (2, 30, 7)).astype(np.float32)
    ref = np.asarray(jax_roi_utils.rcnn_box_decode(jnp.asarray(rois),
                                                   jnp.asarray(reg)))
    got = roi_head_utils.rcnn_box_decode(torch.from_numpy(rois),
                                         torch.from_numpy(reg)).numpy()
    assert got.shape == (2, 30, 7)
    np.testing.assert_allclose(got, ref, rtol=OP_TOL, atol=OP_TOL)


@pytest.mark.parametrize("skip", [True, False], ids=["skip", "no_skip"])
def test_fp_module_equals_jax(skip):
    rng = np.random.RandomState(6)
    pts, valid = scene(6, 2, 400, TINY_RANGE, n_valid=(400, 300))
    unknown, known = pts[..., :3], pts[:, ::4, :3].copy()
    kvalid = valid[:, ::4].copy()
    ufeat = rng.normal(0, 1, (2, 400, 5)).astype(np.float32) if skip else None
    kfeat = rng.normal(0, 1, (2, 100, 12)).astype(np.float32)
    jmod = JaxFP(mlp=(16, 24))
    args = [None if a is None else jnp.asarray(a)
            for a in (unknown, known, ufeat, kfeat, kvalid)]
    flat = perturb(flatten_variables(
        jmod.init(jax.random.PRNGKey(0), *args)), 6)
    ref = np.asarray(jmod.apply(unflatten(flat), *args))
    tmod = PointnetFPModule(12 + (5 if skip else 0), (16, 24))
    weights.load_into(tmod, flat).eval()
    with torch.no_grad():
        got = tmod(*(None if a is None else torch.from_numpy(a)
                     for a in (unknown, known, ufeat, kfeat, kvalid)))
    assert got.shape == (2, 400, 24) and float(np.abs(ref).max()) > 0.1
    np.testing.assert_allclose(got.numpy(), ref, rtol=OP_TOL, atol=OP_TOL)


# ---------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------

def run_jax(jmodel, variables, model_cfg, num_class, pts, mask):
    """The JAX model's detections and what locates a parting: backbone
    picks, stage-1 scores, candidate order and first boxes, RoIs with the
    point each came from, ``rcnn_cls`` / ``rcnn_reg``."""
    pre = min(int(model_cfg["ROI_HEAD"]["NMS_CONFIG"]["TEST"]
                  ["NMS_PRE_MAXSIZE"]), pts.shape[1])
    with record_jax_picks() as rec:
        @jax.jit
        def infer(v, p, m):
            rec.clear()
            out = jmodel.apply(v, {"points": p, "points_mask": m},
                               train=False)
            post = jax_post_processing(out, model_cfg["POST_PROCESSING"],
                                       num_class)
            scores = jnp.max(jax.nn.sigmoid(out["point_cls_preds"]), axis=-1)
            order = jax.lax.top_k(scores, pre)[1]
            n_top = min(N_TOP_BOXES, pre)
            keep = {k: out[k] for k in ("rois", "roi_scores", "roi_valid",
                                        "rcnn_cls", "rcnn_reg")}
            keep.update(
                stage1_scores=scores, stage1_order=order.astype(jnp.int32),
                stage1_boxes_top=jnp.take_along_axis(
                    out["point_box_preds"], order[:, :n_top, None], axis=1),
                stage1_boxes=out["point_box_preds"])
            return {k: post[k] for k in OUT_KEYS}, list(rec)[:4], keep

        post, picks, keep = infer(variables, jnp.asarray(pts),
                                  jnp.asarray(mask))
    out = {k: np.asarray(v) for k, v in {**post, **keep}.items()}
    for i, p in enumerate(picks):
        out[f"picks_{i}"] = np.asarray(p)
    boxes = out.pop("stage1_boxes")
    valid = out.pop("roi_valid")
    out["roi_count"] = valid.sum(-1).astype(np.int32)
    # the point each RoI came from: its row among the stage-1 boxes
    same = (boxes[:, None] == out["rois"][:, :, None]).all(-1)  # (B, R, N)
    assert (same.sum(-1)[valid] == 1).all(), "RoI boxes must be unique rows"
    out["roi_idx"] = np.where(valid, same.argmax(-1), 0).astype(np.int32)
    out["roi_empty"] = out["rcnn_cls"] == np.float32(-1e4)
    return out


def run_torch(tmodel, post_cfg, num_class, pts, mask):
    """→ (the port's batch dict, its post-processed detections)."""
    with torch.no_grad():
        out = tmodel({"points": torch.from_numpy(pts),
                      "points_mask": torch.from_numpy(mask)})
        return out, post_processing(out, post_cfg, num_class)


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_pointrcnn_cfg()
    tcfg = Config(copy.deepcopy(dict(jcfg)))
    spec_kw = dict(class_names=("Car",), point_feature_dim=4,
                   point_cloud_range=TINY_RANGE)
    jmodel = jax_build(jcfg, num_class=1, dataset=JaxSpec(**spec_kw))
    tmodel = build_network(tcfg, 1, DatasetSpec(**spec_kw), device="cpu")
    # the size of tests/test_pointrcnn_e2e.py: B = 2, N = 256
    pts, mask = scene(4, 2, 256, (0.0, -16.0, -2.0, 32.0, 16.0, 1.0),
                      n_valid=(256, 200), clusters=4)
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0),
        {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)},
    )
    flat = weights.seeded_flax(tmodel, TINY_SEED)
    weights.load_into(tmodel, flat)
    ref = run_jax(jmodel, unflatten(flat), jcfg, 1, pts, mask)
    got = run_torch(tmodel, tcfg["POST_PROCESSING"], 1, pts, mask)
    return ref, got, flatten_variables(init), flat, tmodel


def test_seeded_flax_fills_both_models(tiny):
    """The seeded dict has exactly the JAX model's tree and shapes, loads
    into the port's whole state dict, and is a function of the seed."""
    _, _, init, flat, tmodel = tiny
    assert sorted(flat) == sorted(init)
    for k, v in flat.items():
        assert v.shape == init[k].shape and v.dtype == np.float32, k
    state = weights.flax_to_torch(flat, tmodel)
    assert sorted(state) == sorted(tmodel.state_dict())
    again = weights.seeded_flax(tmodel, TINY_SEED)
    other = weights.seeded_flax(tmodel, TINY_SEED + 1)
    assert all(np.array_equal(flat[k], again[k]) for k in flat)
    assert not any(np.array_equal(flat[k], other[k]) for k in flat)
    var = [v for k, v in flat.items() if k.endswith("/var")]
    assert var and all((v >= 0.5).all() and (v <= 1.5).all() for v in var)


def test_tiny_pointrcnn_matches_jax(tiny):
    """chip_smoke's parity check, held strict: no candidate swapped, no
    RoI list parted, RoIs / rcnn_cls / detections within 1e-4."""
    from chip_smoke import check_pointrcnn_parity

    ref, (out, post) = tiny[:2]
    assert ref["roi_count"].tolist() == [16, 16] and ref["pred_count"].min() > 0
    assert [ref[f"picks_{i}"].shape[1] for i in range(2)] == [128, 64]
    assert tuple(out["batch_box_preds"].shape) == (2, 16, 7)
    assert tuple(out["batch_cls_preds"].shape) == (2, 16, 1)
    res = check_pointrcnn_parity(out, post, ref, tol=TOL)
    assert res["partings"] == [] and res["candidates_swapped"] == 0
    assert res["detections_not_compared"] == []
    assert res["counts"] == ref["pred_count"].tolist()


@pytest.mark.parametrize("fault", ["pick", "score", "order", "roi", "cls",
                                   "count"])
def test_parity_check_refuses_faults(tiny, fault):
    """``chip_smoke.check_pointrcnn_parity`` refuses a changed backbone
    pick, a moved score, a candidate swap or RoI change that is no
    near-tie, a moved ``rcnn_cls`` and a changed count."""
    from chip_smoke import check_pointrcnn_parity

    ref, (out, post) = tiny[:2]
    ref = {k: v.copy() for k, v in ref.items()}
    if fault == "pick":
        ref["picks_1"][1, 10] = ref["picks_1"][1, 11]
    elif fault == "score":
        ref["stage1_scores"][0, 5] += 0.01
    elif fault == "order":
        ref["stage1_order"][0, [0, 100]] = ref["stage1_order"][0, [100, 0]]
    elif fault == "roi":
        ref["roi_idx"][1, 3] = ref["stage1_order"][1, -1]
    elif fault == "cls":
        ref["rcnn_cls"][0, int(np.argmin(ref["roi_empty"][0]))] += 0.01
    elif fault == "count":
        ref["pred_count"][0] += 1
    with pytest.raises(RuntimeError):
        check_pointrcnn_parity(out, post, ref, tol=TOL)


def test_default_device_is_the_card():
    """With no device argument the entry points use the card and raise
    where there is none."""
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a card")
    cfg = Config(copy.deepcopy(dict(tiny_pointrcnn_cfg())))
    spec = DatasetSpec(class_names=("Car",), point_feature_dim=4,
                       point_cloud_range=TINY_RANGE)
    with pytest.raises(RuntimeError):
        build_network(cfg, 1, spec)


# ---------------------------------------------------------------------
# full-width reference for the card (which has no JAX)
# ---------------------------------------------------------------------

def full_inputs(n_scans=2):
    """The first ``n_scans`` scans prepared as bench.py does: real rows
    clipped into the range ± 0.01, zero padding masked off."""
    from chip_smoke import load_rcnn_scans

    pts, mask = load_rcnn_scans()
    return pts[:n_scans], mask[:n_scans]


def full_models(with_jax=True):
    """(JAX model or None, port model on the CPU with chip_smoke's seeded
    weights, the flat weights, model cfg, num_class), fp32."""
    from chip_smoke import RCNN_SEED, spec_from_cfg

    cfg = cfg_from_yaml_file(FULL)
    mc = copy.deepcopy(cfg.MODEL)
    mc["COMPUTE_DTYPE"] = "float32"
    nc = len(cfg.CLASS_NAMES)
    spec = spec_from_cfg(cfg)
    tmodel = build_network(mc, nc, spec, device="cpu")
    flat = weights.seeded_flax(tmodel, RCNN_SEED)
    weights.load_into(tmodel, flat)
    jmodel = None
    if with_jax:
        jcfg = jax_cfg_from_yaml(str(FULL))
        jmc = copy.deepcopy(dict(jcfg.MODEL))
        jmc["COMPUTE_DTYPE"] = "float32"
        jmodel = jax_build(jmc, num_class=nc, dataset=JaxSpec(
            class_names=spec.class_names, point_feature_dim=4,
            point_cloud_range=spec.point_cloud_range))
    return jmodel, tmodel, flat, mc, nc


def jax_reference(n_scans=2):
    """The JAX model in fp32 with the seeded weights on the first
    ``n_scans`` scans. Rewrite the stored fixture (a few minutes on the
    CPU) with ``python -c "import sys; sys.path.insert(0, 'tests');
    import test_torch_pointrcnn as t; t.write_fixture()"``."""
    jmodel, _, flat, mc, nc = full_models()
    pts, mask = full_inputs(n_scans)
    shapes = jax.eval_shape(
        lambda r, b: jmodel.init(r, b, train=False), jax.random.PRNGKey(0),
        {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)})
    init = {"/".join(k): v.shape for k, v in
            __import__("flax").traverse_util.flatten_dict(shapes).items()}
    assert init == {k: v.shape for k, v in flat.items()}, \
        "seeded weights do not fill the JAX model's tree"
    return run_jax(jmodel, unflatten(flat), mc, nc, pts, mask)


def write_fixture():
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **jax_reference())


@pytest.mark.slow
def test_pointrcnn_fixture_equals_fresh_jax_run():
    ref = jax_reference()
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_pointrcnn_matches_fixture_on_cpu():
    """The PointRCNN parity phase of chip_smoke.py, here on the CPU."""
    from chip_smoke import PARITY_TOL, check_pointrcnn_parity

    _, tmodel, _, mc, nc = full_models(with_jax=False)
    pts, mask = full_inputs()
    out, post = run_torch(tmodel, mc["POST_PROCESSING"], nc, pts, mask)
    with np.load(FIXTURE) as stored:
        res = check_pointrcnn_parity(out, post, dict(stored), tol=PARITY_TOL)
    print(res)
    assert res["roi_counts"] == [100, 100]
