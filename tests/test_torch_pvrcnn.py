"""PV-RCNN inference: the PyTorch port against the JAX package on the same
inputs and the same weights (drawn from a numpy seed by
``de6d_tpu_torch.weights.seeded_flax``, or the JAX modules' own init
perturbed, and carried across as flax variables), fp32 on the CPU.

Keypoint picks, voxel centres (to the bit: they decide the ball query's
membership), RoI counts and labels are compared exactly. Floats: dense
sums run in another order in XLA and PyTorch and cos/sin round
differently, so fp32 values differ by a few ulps; the ops and modules are
held to 1e-5 (``roi_grid_points`` to 1e-6), the tiny model's RoIs,
``rcnn_cls`` and detections to 1e-4, the tolerances of the other parity
tests.
"""

import contextlib
import copy
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    PARITY_TOL, PVRCNN_CFG, PVRCNN_REF, PVRCNN_SEED, check_pvrcnn_parity,
    load_pvrcnn_scans, spec_from_cfg,
)
from de6d_tpu.config import Config as JaxConfig
from de6d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from de6d_tpu.models import build_network as jax_build
from de6d_tpu.models.backbones_3d.pfe import voxel_set_abstraction as jax_vsa
from de6d_tpu.models.backbones_3d.pointnet2_modules import (
    PointnetSAModuleFSMSG as JaxSA,
)
from de6d_tpu.models.dense_heads.anchor_head import (
    AnchorHeadSingle as JaxAnchorHead,
)
from de6d_tpu.models.dense_heads.point_head_box import (
    PointHeadSimple as JaxPointHeadSimple,
)
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.models.detectors.detector3d_template import (
    post_processing as jax_post_processing,
)
from de6d_tpu.models.roi_heads import pvrcnn_head as jax_pvrcnn
from de6d_tpu.models.roi_heads import roi_head_utils as jax_roi_utils
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config, cfg_from_yaml_file
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.backbones_3d.pfe import voxel_set_abstraction
from de6d_tpu_torch.models.dense_heads.anchor_head import AnchorHeadSingle
from de6d_tpu_torch.models.dense_heads.point_head_box import PointHeadSimple
from de6d_tpu_torch.models.detectors.detector3d_template import (
    DatasetSpec, post_processing,
)
from de6d_tpu_torch.models.roi_heads import pvrcnn_head
from de6d_tpu_torch.ops import sparse
from test_torch_det6d import record_jax_picks
from test_torch_second import TINY_SPEC, scene, tiny_second_cfg
from torch_fixtures import flatten_variables, perturb, unflatten

OUT_KEYS = ("pred_boxes", "pred_scores", "pred_labels", "pred_count")
TOL = 1e-4
OP_TOL = 1e-5
TINY_SEED = 5
FULL = cfg_from_yaml_file(PVRCNN_CFG)
PC = tuple(float(x) for x in FULL.DATA_CONFIG.POINT_CLOUD_RANGE)
VS = (0.05, 0.05, 0.1)
# the sparse backbone's stage grids (zyx) at the full config's range
GRIDS = {"x_conv1": (41, 1600, 1408), "x_conv2": (21, 800, 704),
         "x_conv3": (11, 400, 352), "x_conv4": (5, 200, 176)}
STRIDES = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


@contextlib.contextmanager
def record_jax_sa_inputs():
    """Within the block every call of the JAX package's
    ``PointnetSAModuleFSMSG`` records its (xyz, valid) inputs, in call
    order."""
    rec = []

    def intercept(next_fun, args, kwargs, context):
        if (isinstance(context.module, JaxSA)
                and context.method_name == "__call__"):
            rec.append((args[0], args[2]))
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(intercept):
        yield rec


@contextlib.contextmanager
def record_jax_proposals():
    """Record the anchor head's ``batch_cls_preds`` / ``batch_box_preds``
    as the JAX proposal layer receives them (the RoI head overwrites
    them in the batch dict)."""
    rec = {}
    orig = jax_roi_utils.proposal_layer

    def run(batch_dict, nms_cfg, num_rois):
        rec["cls"] = batch_dict["batch_cls_preds"]
        rec["boxes"] = batch_dict["batch_box_preds"]
        return orig(batch_dict, nms_cfg, num_rois)

    jax_roi_utils.proposal_layer = run
    try:
        yield rec
    finally:
        jax_roi_utils.proposal_layer = orig


# ---------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------

def test_bilinear_interpolate_bev_equals_jitted_jax():
    """Keypoints on the 0.4 m cell boundaries (stride 8 x 0.05 m), inside
    cells, and past every edge of the map (clamped)."""
    rng = np.random.RandomState(0)
    bev = rng.normal(0, 1, (2, 200, 176, 8)).astype(np.float32)
    xy = np.stack([rng.uniform(PC[0], PC[3], (2, 800)),
                   rng.uniform(PC[1], PC[4], (2, 800))], -1).astype(np.float32)
    kx, ky = np.meshgrid(np.arange(0, 176, 7), np.arange(0, 200, 9))
    on = np.stack([kx.ravel() * np.float32(0.4),
                   ky.ravel() * np.float32(0.4) + np.float32(PC[1])],
                  -1).astype(np.float32)
    xy[:, :len(on)] = on
    xy[:, -6:] = [[-0.3, 0.0], [70.5, 1.0], [3.0, -40.2], [3.0, 40.3],
                  [70.39, 39.99], [0.0, -40.0]]
    ref = jax.jit(jax.vmap(lambda bv, p: jax_vsa.bilinear_interpolate_bev(
        bv, p, PC, VS, 8)))(jnp.asarray(bev), jnp.asarray(xy))
    got = voxel_set_abstraction.bilinear_interpolate_bev(
        _t(bev), _t(xy), PC, VS, 8)
    assert got.shape == (2, 800, 8) and len(on) > 500
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=OP_TOL,
                               atol=OP_TOL)


def test_roi_grid_points_equal_jax():
    """Grid-major (z, y, x) offsets, rotated as XLA rounds on the CPU; the
    centres lie within 4 m so that a cos or sin rounded otherwise moves a
    point by less than 1e-6."""
    rng = np.random.RandomState(1)
    rois = np.concatenate([rng.uniform(-4, 4, (2, 30, 3)),
                           rng.uniform(0.5, 8, (2, 30, 3)),
                           rng.uniform(-np.pi, np.pi, (2, 30, 1))],
                          -1).astype(np.float32)
    ref = np.asarray(jax.jit(lambda r: jax_pvrcnn.roi_grid_points(r, 6))(
        jnp.asarray(rois)))
    got = pvrcnn_head.roi_grid_points(_t(rois), 6).numpy()
    assert got.shape == (2, 30, 216, 3)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("before_fusion", [True, False],
                         ids=["before_fusion", "point_features"])
def test_point_head_simple_equals_jax(before_fusion):
    rng = np.random.RandomState(2)
    cfg = {"CLS_FC": [32, 16], "USE_POINT_FEATURES_BEFORE_FUSION": True}
    feats = rng.normal(0, 1, (2, 200, 24)).astype(np.float32)
    key = ("point_features_before_fusion" if before_fusion
           else "point_features")
    bd = {key: feats}
    if before_fusion:  # the head must not read these
        bd["point_features"] = rng.normal(0, 1, (2, 200, 5)).astype(
            np.float32)
    jmod = JaxPointHeadSimple(model_cfg=cfg, num_class=1)
    jbd = {k: jnp.asarray(v) for k, v in bd.items()}
    flat = perturb(flatten_variables(jmod.init(jax.random.PRNGKey(0),
                                               dict(jbd))), 2)
    ref = jmod.apply(unflatten(flat), dict(jbd))
    tmod = PointHeadSimple(cfg, 24, 1)
    weights.load_into(tmod, flat).eval()
    with torch.no_grad():
        got = tmod({k: _t(v) for k, v in bd.items()})
    for k in ("point_cls_preds", "point_cls_scores"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=OP_TOL, atol=OP_TOL, err_msg=k)
    assert tuple(got["point_cls_scores"].shape) == (2, 200)


def test_anchor_head_decodes_every_anchor_before_a_roi_head():
    """With ``predict_boxes_when_training`` the head writes the full
    (B, A, 7) decode, as the JAX head does, and no lazy dict; without it
    only the lazy dict."""
    rng = np.random.RandomState(3)
    cfg = copy.deepcopy(dict(tiny_second_cfg()["DENSE_HEAD"]))
    grid, pc = (128, 128, 40), TINY_SPEC["point_cloud_range"]
    x = rng.normal(0, 1, (2, 16, 16, 32)).astype(np.float32)
    jmod = JaxAnchorHead(model_cfg=cfg, num_class=1, class_names=("Car",),
                         grid_size=grid, point_cloud_range=pc,
                         predict_boxes_when_training=True)
    bd = {"spatial_features_2d": jnp.asarray(x)}
    flat = perturb(flatten_variables(jmod.init(jax.random.PRNGKey(0),
                                               dict(bd))), 3)
    ref = jmod.apply(unflatten(flat), dict(bd))
    assert "lazy_box_decode" not in ref
    for full in (True, False):
        tmod = AnchorHeadSingle(cfg, 32, 1, ("Car",), grid, pc,
                                predict_boxes_when_training=full)
        weights.load_into(tmod, flat).eval()
        with torch.no_grad():
            got = tmod({"spatial_features_2d": _t(x)})
        assert ("lazy_box_decode" in got) != full
        assert ("batch_box_preds" in got) == full
    np.testing.assert_allclose(got["batch_cls_preds"].numpy(),
                               np.asarray(ref["batch_cls_preds"]),
                               rtol=OP_TOL, atol=OP_TOL)
    tmod = AnchorHeadSingle(cfg, 32, 1, ("Car",), grid, pc,
                            predict_boxes_when_training=True)
    weights.load_into(tmod, flat).eval()
    with torch.no_grad():
        boxes = tmod({"spatial_features_2d": _t(x)})["batch_box_preds"]
    assert tuple(boxes.shape) == (2, 16 * 16 * 2, 7)
    np.testing.assert_allclose(boxes.numpy(),
                               np.asarray(ref["batch_box_preds"]),
                               rtol=OP_TOL, atol=OP_TOL)


# ---------------------------------------------------------------------
# VoxelSetAbstraction at the full config's geometry, small widths
# ---------------------------------------------------------------------

def vsa_inputs(seed):
    """Raw points in a 16 x 12 x 3 m patch of the full range (some on
    voxel faces), each stage's sorted site keys of those points (one
    stage over-full, with INVALID padding), random features, a BEV map."""
    rng = np.random.RandomState(seed)
    b, n = 2, 2048
    pts = np.zeros((b, n, 4), np.float32)
    pts[..., 0] = rng.uniform(20, 36, (b, n))
    pts[..., 1] = rng.uniform(-6, 6, (b, n))
    pts[..., 2] = rng.uniform(-2.5, 0.5, (b, n))
    pts[:, :64, :2] = np.round(pts[:, :64, :2] / 0.05) * 0.05  # on faces
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    mask = np.ones((b, n), bool)
    mask[1, 1800:] = False
    pts[1, 1800:] = 0.0
    ms = {}
    for name, grid in GRIDS.items():
        s = STRIDES[name]
        v = 2400 if name == "x_conv1" else 1600 // s
        keys = np.full((b, v), sparse.INVALID, np.int32)
        for i in range(b):
            c = np.floor((pts[i, mask[i], :3] - np.float32(PC[:3]))
                         / (np.float32(VS) * s)).astype(np.int64)
            k = np.unique((c[:, 2] * grid[1] + c[:, 1]) * grid[2] + c[:, 0])
            keys[i, :min(v, len(k))] = k[:v]
        cin = {"x_conv1": 16, "x_conv2": 32, "x_conv3": 64, "x_conv4": 64}
        feats = rng.normal(0, 1, (b, v, cin[name])).astype(np.float32)
        feats[keys == sparse.INVALID] = 0.0
        ms[name] = (feats, keys, grid)
    bev = rng.normal(0, 1, (b, 200, 176, 16)).astype(np.float32)
    return pts, mask, ms, bev


def vsa_cfg():
    cfg = copy.deepcopy(dict(FULL.MODEL.PFE))
    cfg["NUM_KEYPOINTS"] = 96
    cfg["NUM_OUTPUT_FEATURES"] = 16
    for src in cfg["SA_LAYER"].values():
        src["MLPS"] = [[4, 6], [4, 8]]
    return cfg


@pytest.fixture(scope="module")
def vsa():
    """Both packages' VoxelSetAbstraction on ``vsa_inputs``, with the JAX
    module's SA inputs recorded."""
    cfg = vsa_cfg()
    pts, mask, ms, bev = vsa_inputs(7)
    bd = {"points": pts, "points_mask": mask, "spatial_features": bev,
          "spatial_features_stride": 8,
          "multi_scale_3d_strides": dict(STRIDES)}
    jmod = jax_vsa.VoxelSetAbstraction(model_cfg=cfg, voxel_size=VS,
                                       point_cloud_range=PC)

    arrays = {k: jnp.asarray(v) for k, v in bd.items()
              if isinstance(v, np.ndarray)}
    arrays["ms"] = {k: (jnp.asarray(f), jnp.asarray(kk))
                    for k, (f, kk, _) in ms.items()}

    def jbd(a):  # arrays as arguments: XLA must not fold the centres
        d = dict(bd, **{k: v for k, v in a.items() if k != "ms"})
        d["multi_scale_3d_features"] = {
            k: (f, kk, ms[k][2]) for k, (f, kk) in a["ms"].items()}
        return d

    flat = perturb(flatten_variables(jax.jit(
        lambda r, a: jmod.init(r, jbd(a)))(jax.random.PRNGKey(0), arrays)), 7)

    @jax.jit
    def run(v, a):
        with record_jax_sa_inputs() as rec:
            out = jmod.apply(v, jbd(a))
        keep = ("point_features_before_fusion", "point_features",
                "point_coords", "point_valid")
        return {k: out[k] for k in keep}, list(rec)

    ref, rec = run(unflatten(flat), arrays)
    tmod = voxel_set_abstraction.VoxelSetAbstraction(
        cfg, VS, PC, num_bev_features=16, num_rawpoint_features=1,
        multi_scale_channels={k: f.shape[-1] for k, (f, _, _) in ms.items()})
    weights.load_into(tmod, flat).eval()
    tbd = {k: _t(v) if isinstance(v, np.ndarray) else v
           for k, v in bd.items()}
    tbd["multi_scale_3d_features"] = {
        k: (_t(f), _t(kk), g) for k, (f, kk, g) in ms.items()}
    with torch.no_grad():
        got = tmod(tbd)
    return got, ref, rec, ms, flat


def test_vsa_seeded_tree_and_feature_order(vsa):
    """The SA layers in the JAX module's order: raw points first, then
    the voxel sources in list order; a 16 + 5 x 14 = 86 wide fusion."""
    got, _, rec, _, flat = vsa
    assert len(rec) == 5
    widths = {k: v.shape for k, v in flat.items()
              if k.endswith("SharedMLP_0/Dense_0/kernel")}
    assert widths["params/PointnetSAModuleFSMSG_0/SharedMLP_0/Dense_0/"
                  "kernel"] == (4, 4)  # intensity + xyz
    for i, cin in enumerate((16, 32, 64, 64), start=1):
        assert widths[f"params/PointnetSAModuleFSMSG_{i}/SharedMLP_0/"
                      "Dense_0/kernel"] == (cin + 3, 4)
    assert widths["params/SharedMLP_0/Dense_0/kernel"] == (86, 16)
    assert tuple(got["point_features_before_fusion"].shape) == (2, 96, 86)


@pytest.mark.parametrize("source", list(GRIDS))
def test_voxel_centres_bit_equal_jitted_jax(vsa, source):
    """Each stage's voxel centres, as the JAX module hands them to its SA
    layer under jit: the same bits (and the same validity)."""
    _, _, rec, ms, _ = vsa
    i = list(GRIDS).index(source) + 1
    _, keys, grid = ms[source]
    xyz, valid = voxel_set_abstraction.voxel_centres(
        _t(keys), grid, VS, PC, STRIDES[source])
    ref_xyz, ref_valid = (np.asarray(a) for a in rec[i])
    np.testing.assert_array_equal(valid.numpy(), ref_valid)
    assert valid.numpy().sum() > 100
    np.testing.assert_array_equal(xyz.numpy()[ref_valid],
                                  ref_xyz[ref_valid])


def test_vsa_equals_jax(vsa):
    """Keypoint picks and validity exact; the BEV and SA features and the
    fused output to 1e-5."""
    got, ref, _, _, _ = vsa
    np.testing.assert_array_equal(got["point_coords"].numpy(),
                                  np.asarray(ref["point_coords"]))
    np.testing.assert_array_equal(got["point_valid"].numpy(),
                                  np.asarray(ref["point_valid"]))
    for k in ("point_features_before_fusion", "point_features"):
        want = np.asarray(ref[k])
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(got[k].numpy(), want, rtol=OP_TOL,
                                   atol=OP_TOL, err_msg=k)


@pytest.mark.parametrize("option", ["sectorized-fps", "vectorpool"])
def test_vsa_refuses_what_is_not_ported(option):
    cfg = vsa_cfg()
    if option == "sectorized-fps":
        cfg["SAMPLE_METHOD"] = "sectorized-fps"
    else:
        cfg["SA_LAYER"]["x_conv3"]["NAME"] = "VectorPoolAggregationModuleMSG"
    with pytest.raises(NotImplementedError, match=option[:6] if
                       option == "sectorized-fps" else "VectorPool"):
        voxel_set_abstraction.VoxelSetAbstraction(
            cfg, VS, PC, 16, 1, {k: 16 for k in GRIDS})


# ---------------------------------------------------------------------
# PVRCNNHead
# ---------------------------------------------------------------------

@pytest.mark.parametrize("use_bn", [False, True], ids=["no_bn", "bn"])
def test_pvrcnn_head_equals_jax(use_bn):
    """Proposals from 256 scored boxes (16 RoIs; sample 1 keeps fewer), RoI-grid pooling over 256 keypoints scaled by their scores,
    the zero RoIs past the count pooled and scored as in JAX."""
    rng = np.random.RandomState(4 + use_bn)
    b, a, k = 2, 256, 256
    kp = np.concatenate([rng.uniform(0, 12, (b, k, 2)),
                         rng.uniform(-2, 0, (b, k, 1))], -1).astype(np.float32)
    boxes = np.concatenate([rng.uniform(1, 11, (b, a, 2)),
                            rng.uniform(-1.5, -0.5, (b, a, 1)),
                            rng.uniform(1, 4, (b, a, 3)),
                            rng.uniform(-np.pi, np.pi, (b, a, 1))],
                           -1).astype(np.float32)
    boxes[1, 10:] = boxes[1, :1]  # copies of one box: at most 10 RoIs
    bd = {"batch_cls_preds": rng.normal(0, 1, (b, a, 1)).astype(np.float32),
          "batch_box_preds": boxes, "point_coords": kp,
          "point_features": rng.normal(0, 1, (b, k, 12)).astype(np.float32),
          "point_valid": np.arange(k)[None] < np.array([[k], [200]]),
          "point_cls_scores": rng.uniform(0, 1, (b, k)).astype(np.float32)}
    cfg = {"USE_BN": use_bn, "SHARED_FC": [32, 16], "CLS_FC": [16],
           "REG_FC": [16],
           "ROI_GRID_POOL": {"GRID_SIZE": 3, "MLPS": [[8, 8], [8, 16]],
                             "POOL_RADIUS": [0.8, 1.6], "NSAMPLE": [8, 16]},
           "NMS_CONFIG": {"TEST": {"NMS_THRESH": 0.7, "NMS_PRE_MAXSIZE": 128,
                                   "NMS_POST_MAXSIZE": 16}},
           "TARGET_CONFIG": {"ROI_PER_IMAGE": 16}}
    jmod = jax_pvrcnn.PVRCNNHead(model_cfg=cfg, num_class=1)
    jbd = {kk: jnp.asarray(v) for kk, v in bd.items()}
    flat = perturb(flatten_variables(jax.jit(jmod.init)(
        jax.random.PRNGKey(0), dict(jbd))), 4)
    ref = jax.jit(lambda v, d: jmod.apply(v, d))(unflatten(flat), dict(jbd))
    tmod = pvrcnn_head.PVRCNNHead(cfg, 12, 1)
    weights.load_into(tmod, flat).eval()
    with torch.no_grad():
        got = tmod({kk: _t(v) for kk, v in bd.items()})
    counts = np.asarray(ref["roi_valid"]).sum(-1)
    assert counts[0] == 16 and 0 < counts[1] < 16
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  np.asarray(ref["roi_valid"]))
    for kk in ("rois", "rcnn_cls", "rcnn_reg", "batch_box_preds",
               "batch_cls_preds"):
        np.testing.assert_allclose(got[kk].numpy(), np.asarray(ref[kk]),
                                   rtol=OP_TOL, atol=OP_TOL, err_msg=kk)
    np.testing.assert_array_equal(got["rpn_box_preds"].numpy(), boxes)


# ---------------------------------------------------------------------
# tiny PV-RCNN end to end
# ---------------------------------------------------------------------

def tiny_pvrcnn_cfg(variant="all_sources"):
    """tests/test_pvrcnn_e2e.py's tiny PV-RCNN (12.8 x 12.8 x 4 m at
    0.1 m, 128 keypoints, 16 RoIs): as it is there (``"e2e"``: BEV, raw
    points and x_conv3, RoI head with BatchNorm), or with every feature
    source of the full config in its order (raw points listed last) and
    its bias-only RoI head (``"all_sources"``)."""
    cfg = tiny_second_cfg()
    cfg["NAME"] = "PVRCNN"
    sa = {"raw_points": ([[8, 8], [8, 8]], [0.4, 0.8], [8, 8]),
          "x_conv1": ([[8, 8], [8, 8]], [0.4, 0.8], [8, 8]),
          "x_conv2": ([[8, 8], [8, 8]], [0.8, 1.2], [8, 16]),
          "x_conv3": ([[16, 16], [16, 16]], [1.2, 2.4], [8, 16]),
          "x_conv4": ([[16, 16], [16, 16]], [2.4, 4.8], [8, 16])}
    sources = ["bev", "x_conv1", "x_conv2", "x_conv3", "x_conv4",
               "raw_points"]
    if variant == "e2e":
        sources = ["bev", "raw_points", "x_conv3"]
        sa["x_conv3"] = ([[16, 16], [16, 16]], [1.2, 2.4], [8, 8])
    cfg["PFE"] = {
        "NAME": "VoxelSetAbstraction", "NUM_KEYPOINTS": 128,
        "NUM_OUTPUT_FEATURES": 32, "SAMPLE_METHOD": "FPS",
        "FEATURES_SOURCE": sources,
        "SA_LAYER": {k: {"MLPS": m, "POOL_RADIUS": r, "NSAMPLE": n}
                     for k, (m, r, n) in sa.items() if k in sources},
    }
    cfg["POINT_HEAD"] = {"NAME": "PointHeadSimple", "CLS_FC": [32],
                         "CLASS_AGNOSTIC": True,
                         "USE_POINT_FEATURES_BEFORE_FUSION": True}
    cfg["ROI_HEAD"] = {
        "NAME": "PVRCNNHead", "CLASS_AGNOSTIC": True,
        "USE_BN": variant == "e2e",
        "SHARED_FC": [32], "CLS_FC": [16], "REG_FC": [16],
        "ROI_GRID_POOL": {"GRID_SIZE": 4, "MLPS": [[8, 8], [8, 8]],
                          "POOL_RADIUS": [0.8, 1.6], "NSAMPLE": [8, 8]},
        "NMS_CONFIG": {"TEST": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.7,
                                "NMS_PRE_MAXSIZE": 128,
                                "NMS_POST_MAXSIZE": 16}},
        "TARGET_CONFIG": {"ROI_PER_IMAGE": 16},
    }
    return cfg


def run_jax(jmodel, variables, model_cfg, num_class, pts, mask, window):
    """The JAX PV-RCNN's detections and what ``chip_smoke.
    check_pvrcnn_parity`` reads: the keypoint picks and scores, the best
    ``window`` anchors by score with their scores (``prop_order``,
    ``prop_scores``; the proposal layer's top ``NMS_PRE_MAXSIZE`` are the
    first), the decoded boxes of those candidates, the RoIs with the
    anchor each came from and their count, ``rcnn_cls``, ``rcnn_reg``."""
    roi_cfg = model_cfg["ROI_HEAD"]["NMS_CONFIG"]["TEST"]
    with record_jax_picks() as picks, record_jax_proposals() as props:
        @jax.jit
        def infer(v, p, m):
            picks.clear()
            out = jmodel.apply(v, {"points": p, "points_mask": m},
                               train=False)
            post = jax_post_processing(out, model_cfg["POST_PROCESSING"],
                                       num_class)
            scores = jnp.max(jax.nn.sigmoid(props["cls"]), axis=-1)
            top, order = jax.lax.top_k(scores, window)
            pre = min(int(roi_cfg["NMS_PRE_MAXSIZE"]), scores.shape[1])
            keep = {k: out[k] for k in ("rois", "roi_valid", "rcnn_cls",
                                        "rcnn_reg", "point_cls_scores")}
            keep.update(
                keypoint_idx=list(picks)[0], prop_order=order,
                prop_scores=top, prop_boxes=jnp.take_along_axis(
                    props["boxes"], order[:, :pre, None], axis=1))
            return {k: post[k] for k in OUT_KEYS}, keep

        post, keep = infer(variables, jnp.asarray(pts), jnp.asarray(mask))
    out = {k: np.asarray(v) for k, v in {**post, **keep}.items()}
    for k in ("keypoint_idx", "prop_order"):
        out[k] = out[k].astype(np.int32)
    valid = out.pop("roi_valid")
    out["roi_count"] = valid.sum(-1).astype(np.int32)
    # the anchor each RoI came from: its row among the candidates' boxes
    same = (out["prop_boxes"][:, None] == out["rois"][:, :, None]).all(-1)
    assert (same.sum(-1)[valid] == 1).all(), "RoI boxes must be unique rows"
    rows = np.take_along_axis(out["prop_order"], same.argmax(-1), axis=1)
    out["roi_idx"] = np.where(valid, rows, 0).astype(np.int32)
    return out


def run_torch(tmodel, post_cfg, num_class, pts, mask):
    with torch.no_grad():
        out = tmodel({"points": _t(pts), "points_mask": _t(mask)})
        return out, post_processing(out, post_cfg, num_class)


@functools.lru_cache(maxsize=None)
def tiny_run(variant):
    cfg = tiny_pvrcnn_cfg(variant)
    jmodel = jax_build(JaxConfig(copy.deepcopy(cfg)), num_class=1,
                       dataset=JaxSpec(**TINY_SPEC))
    tmodel = build_network(Config(copy.deepcopy(cfg)), 1,
                           DatasetSpec(**TINY_SPEC), device="cpu")
    flat = weights.seeded_flax(tmodel, TINY_SEED)
    weights.load_into(tmodel, flat)
    pts, mask = scene(0)
    ref = run_jax(jmodel, unflatten(flat), cfg, 1, pts, mask, window=256)
    out, post = run_torch(tmodel, cfg["POST_PROCESSING"], 1, pts, mask)
    return ref, out, post, cfg


@pytest.fixture
def tiny():
    return tiny_run("all_sources")


# the fused keypoint width: BEV 32, then 16 for the raw points, x_conv1
# and x_conv2, 32 for x_conv3 and x_conv4
@pytest.mark.parametrize("variant,width", [("e2e", 80),
                                           ("all_sources", 144)])
def test_tiny_pvrcnn_matches_jax(variant, width):
    """chip_smoke's parity check, held strict: no candidate swapped, no
    RoI list parted, keypoints / RoIs / rcnn_cls / detections within
    1e-4."""
    ref, out, post, cfg = tiny_run(variant)
    assert ref["roi_count"].min() > 0 and ref["pred_count"].min() > 0
    assert tuple(out["point_features_before_fusion"].shape) == (2, 128,
                                                                width)
    assert tuple(out["batch_box_preds"].shape) == (2, 16, 7)
    assert tuple(out["rpn_box_preds"].shape) == (2, 512, 7)
    res = check_pvrcnn_parity(out, post, ref, cfg, tol=TOL)
    assert res["partings"] == [] and res["candidates_swapped"] == 0
    assert res["detections_not_compared"] == []
    assert res["counts"] == ref["pred_count"].tolist()
    np.testing.assert_array_equal(post["pred_labels"].numpy(),
                                  ref["pred_labels"])


@pytest.mark.parametrize("fault", ["pick", "score", "order", "roi", "cls",
                                   "count"])
def test_parity_check_refuses_faults(tiny, fault):
    """``chip_smoke.check_pvrcnn_parity`` refuses a changed keypoint pick,
    a moved anchor score, a candidate swap or RoI change that is no
    near-tie, a moved ``rcnn_cls`` and a changed count."""
    ref, out, post, cfg = tiny
    ref = {k: v.copy() for k, v in ref.items()}
    if fault == "pick":
        ref["keypoint_idx"][1, 10] = ref["keypoint_idx"][1, 11]
    elif fault == "score":
        ref["prop_scores"][0, 5] += 0.01
    elif fault == "order":
        ref["prop_order"][0, [0, 100]] = ref["prop_order"][0, [100, 0]]
    elif fault == "roi":
        ref["roi_idx"][1, 3] = ref["prop_order"][1, 127]
    elif fault == "cls":
        ref["rcnn_cls"][0] += 0.01
    elif fault == "count":
        ref["pred_count"][0] += 1
    with pytest.raises(RuntimeError):
        check_pvrcnn_parity(out, post, ref, cfg, tol=TOL)


def test_match_detections_pairs_tied_detections_only():
    """Two detections of equal score that trade places are matched; a
    moved box, score or label is not."""
    from chip_smoke import match_detections

    rng = np.random.RandomState(6)
    ref = {"pred_boxes": rng.uniform(-10, 10, (6, 7)).astype(np.float32),
           "pred_scores": np.array([0.9, 0.8, 0.8, 0.5, 0.4, 0.2],
                                   np.float32),
           "pred_labels": np.ones(6, np.int32)}
    order = np.array([0, 2, 1, 3, 4, 5])
    got = {k: v[order].copy() for k, v in ref.items()}
    np.testing.assert_array_equal(match_detections("t", got, ref, TOL),
                                  order)
    for k, delta in (("pred_boxes", 0.01), ("pred_scores", 0.01),
                     ("pred_labels", 1)):
        bad = {kk: v.copy() for kk, v in got.items()}
        bad[k][1] += delta
        with pytest.raises(RuntimeError):
            match_detections("t", bad, ref, TOL)


# ---------------------------------------------------------------------
# the full config: weights, reference
# ---------------------------------------------------------------------

def full_models(with_jax=True):
    """(JAX model or None, port model on the CPU with chip_smoke's seeded
    weights, the flat weights, model cfg, num_class), fp32."""
    cfg = cfg_from_yaml_file(PVRCNN_CFG)
    mc = copy.deepcopy(cfg.MODEL)
    mc["COMPUTE_DTYPE"] = "float32"
    nc = len(cfg.CLASS_NAMES)
    spec = spec_from_cfg(cfg)
    tmodel = build_network(mc, nc, spec, device="cpu")
    flat = weights.seeded_flax(tmodel, PVRCNN_SEED)
    weights.load_into(tmodel, flat)
    jmodel = None
    if with_jax:
        jmc = copy.deepcopy(dict(jax_cfg_from_yaml(str(PVRCNN_CFG)).MODEL))
        jmc["COMPUTE_DTYPE"] = "float32"
        jmodel = jax_build(jmc, num_class=nc, dataset=JaxSpec(**{
            f: getattr(spec, f) for f in (
                "class_names", "point_feature_dim", "point_cloud_range",
                "voxel_size", "max_voxels", "max_points_per_voxel")}))
    return jmodel, tmodel, flat, mc, nc


@pytest.mark.parametrize("fault", ["none", "transposed_kernel",
                                   "missing_bn_var", "extra_key"])
def test_converter_consumes_all_277_pvrcnn_arrays(fault):
    """The full config's seeded flax tree (277 arrays, the layout the JAX
    model's variables have) lands in the port's PV-RCNN, every shape
    checked."""
    _, tmodel, flat, _, _ = full_models(with_jax=False)
    assert len(flat) == 277
    key = "params/roi_head/shared_fc/Dense_0/kernel"
    assert flat[key].shape == (27648, 256)  # 6³ grid points x 128
    assert flat["params/pfe/SharedMLP_0/Dense_0/kernel"].shape == (640, 128)
    assert flat["params/point_head/FCStack_0/Dense_0/kernel"].shape == (
        640, 256)
    assert flat["params/roi_head/pool_sa/SharedMLP_0/Dense_0/kernel"].shape \
        == (131, 64)
    if fault == "transposed_kernel":
        k = "params/pfe/PointnetSAModuleFSMSG_2/SharedMLP_1/Dense_0/kernel"
        flat[k] = flat[k].T.copy()  # (35, 32) as (32, 35)
    elif fault == "missing_bn_var":
        del flat["batch_stats/pfe/SharedMLP_0/BatchNorm_0/var"]
    elif fault == "extra_key":
        flat["params/roi_head/shared_fc/Dense_2/kernel"] = \
            flat[key]
    if fault != "none":
        with pytest.raises(ValueError):
            weights.flax_to_torch(flat, tmodel)
        return
    sd = weights.flax_to_torch(flat, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    np.testing.assert_array_equal(
        sd["roi_head.shared_fc.Dense_0.weight"].numpy(), flat[key].T)


def jax_reference(n_scans=2):
    """The JAX PV-RCNN in fp32 with the seeded weights on the first
    ``n_scans`` scans clipped to its range. Rewrite the stored fixture
    (about a minute on the CPU) with ``python -c "import sys;
    sys.path.insert(0, 'tests'); import test_torch_pvrcnn as t;
    t.write_fixture()"``."""
    jmodel, _, flat, mc, nc = full_models()
    pts, mask = load_pvrcnn_scans()
    pts, mask = pts[:n_scans], mask[:n_scans]
    shapes = jax.eval_shape(
        lambda r, b: jmodel.init(r, b, train=False), jax.random.PRNGKey(0),
        {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)})
    init = {"/".join(k): v.shape for k, v in
            __import__("flax").traverse_util.flatten_dict(shapes).items()}
    assert init == {k: v.shape for k, v in flat.items()}, \
        "seeded weights do not fill the JAX model's tree"
    return run_jax(jmodel, unflatten(flat), mc, nc, pts, mask, window=2048)


def write_fixture():
    PVRCNN_REF.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(PVRCNN_REF, **jax_reference())


@pytest.mark.slow
def test_pvrcnn_fixture_equals_fresh_jax_run():
    ref = jax_reference()
    with np.load(PVRCNN_REF) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_pvrcnn_matches_fixture_on_cpu():
    """The PV-RCNN parity phase of chip_smoke.py, here on the CPU."""
    _, tmodel, _, mc, nc = full_models(with_jax=False)
    pts, mask = load_pvrcnn_scans()
    out, post = run_torch(tmodel, mc["POST_PROCESSING"], nc, pts[:2],
                          mask[:2])
    with np.load(PVRCNN_REF) as stored:
        res = check_pvrcnn_parity(out, post, dict(stored), mc,
                                  tol=PARITY_TOL)
    print(res)
    assert res["roi_counts"] == [100, 100]
    assert res["detections_not_compared"] == []
