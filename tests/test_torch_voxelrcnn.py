"""Voxel-RCNN inference: the PyTorch port against the JAX package on the
same inputs and the same weights (drawn from a numpy seed by
``de6d_tpu_torch.weights.seeded_flax``, or the JAX modules' own init
perturbed, and carried across as flax variables), fp32 on the CPU.

The voxel query is compared bit for bit: the cell of a grid point, the
27 neighbour keys, which of them hit and the features gathered (zeros on
a miss). The reference is the jitted JAX function with the voxel size
and the range corner closed over as constants, as the model holds them:
XLA then compiles the division by the cell size into a product by its
fp32 reciprocal, which a true division (and eager JAX) parts from on
points near a cell face. RoI counts and labels are exact. Floats: dense
sums run in another order in XLA and PyTorch and cos/sin round
differently, so fp32 values differ by a few ulps; the head is held to
1e-5, the tiny model's RoIs, ``rcnn_cls`` and detections to 1e-4, the
tolerances of the other parity tests.
"""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    PARITY_TOL, VOXELRCNN_CFG, VOXELRCNN_REF, VOXELRCNN_SEED,
    check_voxelrcnn_parity, load_voxelrcnn_scans, spec_from_cfg,
)
from de6d_tpu.config import Config as JaxConfig
from de6d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from de6d_tpu.models import build_network as jax_build
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.models.detectors.detector3d_template import (
    post_processing as jax_post_processing,
)
from de6d_tpu.models.roi_heads import voxelrcnn_head as jax_vrcnn
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config, cfg_from_yaml_file
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.detectors.detector3d_template import (
    DatasetSpec, post_processing,
)
from de6d_tpu_torch.models.roi_heads import voxelrcnn_head
from de6d_tpu_torch.ops import sparse
from test_torch_pvrcnn import record_jax_proposals
from test_torch_second import TINY_SPEC, scene, tiny_second_cfg
from torch_fixtures import flatten_variables, perturb, unflatten

OUT_KEYS = ("pred_boxes", "pred_scores", "pred_labels", "pred_count")
TOL = 1e-4
OP_TOL = 1e-5
TINY_SEED = 6
VS = (0.05, 0.05, 0.1)
PC = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
# the pooled stages' grids (zyx) at the full config's range, by stride
GRIDS = {2: (21, 800, 704), 4: (11, 400, 352), 8: (5, 200, 176)}
STRIDES = {"x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8}


def _t(a):
    return torch.from_numpy(np.asarray(a))


def jitted_pool(grid, stride, vs=VS, pc=PC):
    """JAX's ``voxel_query_pool`` jitted with the voxel size and the range
    corner as constants, as the model closes over them."""
    vsj = jnp.asarray(vs, jnp.float32)
    pcj = jnp.asarray(pc[:3], jnp.float32)
    return jax.jit(lambda f, k, p: jax_vrcnn.voxel_query_pool(
        f, k, grid, p, vsj, pcj, stride))


# ---------------------------------------------------------------------
# voxel_query_pool at the full config's geometry
# ---------------------------------------------------------------------

def pool_inputs(stride, seed=0, b=2, q=3000, v=1500, c=8):
    """Query points in a 4 x 4 x 4.5 m block reaching past the range's
    bottom and top (centre cells outside the grid); a third of them on a
    cell face of one axis (the fp32 face of the reciprocal's cell size),
    a third one ulp above a face, a third one ulp below. The active sites
    are the points' cells jittered by one, fewer in sample 1 (an INVALID
    tail); features carry a column of ones, which marks the hits."""
    rng = np.random.RandomState(seed + stride)
    grid = GRIDS[stride]
    cell = np.float32(VS) * np.float32(stride)
    corner = np.float32(PC[:3])
    pts = np.stack([rng.uniform(10, 14, (b, q)), rng.uniform(-2, 2, (b, q)),
                    rng.uniform(-3.5, 1.3, (b, q))], -1).astype(np.float32)
    n = q // 3
    face = (np.floor((pts[:, :n] - corner) / cell) * cell
            + corner).astype(np.float32)
    axis = np.eye(3, dtype=bool)[rng.randint(0, 3, (b, n))]
    for j, side in enumerate((None, 1e9, -1e9)):
        at = face if side is None else np.nextafter(face, np.float32(side))
        rows = slice(j * n, (j + 1) * n)
        pts[:, rows] = np.where(axis, at, pts[:, rows])
    keys = np.full((b, v), sparse.INVALID, np.int32)
    for i in range(b):
        cc = (np.floor((pts[i] - corner) * (np.float32(1) / cell))
              .astype(np.int64) + rng.randint(-1, 2, (q, 3)))
        ok = ((cc >= 0).all(-1) & (cc[:, 0] < grid[2]) & (cc[:, 1] < grid[1])
              & (cc[:, 2] < grid[0]))
        k = np.unique((cc[ok, 2] * grid[1] + cc[ok, 1]) * grid[2] + cc[ok, 0])
        k = np.sort(rng.permutation(k)[:v - 200 * i])
        keys[i, :len(k)] = k
    feats = rng.normal(0, 1, (b, v, c)).astype(np.float32)
    feats[..., -1] = 1.0
    return feats, keys, grid, pts


@pytest.mark.parametrize("stride", [2, 4, 8])
def test_voxel_query_pool_equals_jitted_jax(stride):
    """Features bit-equal (zeros on a miss) and the hits equal, on points
    on cell faces and outside the grid; a true division would part from
    the reciprocal product's floor on some of them."""
    feats, keys, grid, pts = pool_inputs(stride)
    ref = np.asarray(jitted_pool(grid, stride)(feats, keys, pts))
    got, hit = voxelrcnn_head.voxel_query_pool(
        _t(feats), _t(keys), grid, _t(pts), VS, PC[:3], stride)
    assert tuple(got.shape) == (2, 3000, 27, 8)
    np.testing.assert_array_equal(hit.numpy(), ref[..., -1] == 1.0)
    np.testing.assert_array_equal(got.numpy(), ref)
    cell = np.float32(VS) * np.float32(stride)
    off = pts - np.float32(PC[:3])
    parts = (np.floor(off / cell)
             != np.floor(off * (np.float32(1) / cell))).any(-1)
    assert parts.sum() > 50
    # centres below the grid whose upper neighbours hit
    z = np.floor(off[..., 2] * (np.float32(1) / cell[2]))
    below = z < 0
    assert below.sum() > 0 and hit.numpy()[below][:, 18:].any()
    assert 0.02 < hit.numpy().mean() < 0.9


def test_voxel_query_pool_keys_each_offset_on_its_own():
    """A centre one cell below the grid (z = -1) finds its dz = +1
    neighbours, the out-of-grid offsets miss, and a centre inside finds
    all 27 where the 3³ block is active."""
    grid = (5, 8, 8)
    cz, cy, cx = np.meshgrid(np.arange(0, 2), np.arange(2, 5),
                             np.arange(2, 5), indexing="ij")
    keys = np.sort(((cz * 8 + cy) * 8 + cx).reshape(-1)).astype(np.int32)
    keys = np.concatenate([keys, np.full(5, sparse.INVALID, np.int32)])[None]
    feats = np.arange(keys.size, dtype=np.float32)[None, :, None] + 1.0
    vs, pc = (0.1, 0.1, 0.1), (0.0, 0.0, 0.0)
    pts = np.array([[[0.35, 0.35, -0.05], [0.35, 0.35, 0.05]]], np.float32)
    got, hit = voxelrcnn_head.voxel_query_pool(
        _t(feats), _t(keys), grid, _t(pts), vs, pc, 1)
    ref = np.asarray(jitted_pool(grid, 1, vs, pc)(feats, keys, pts))
    np.testing.assert_array_equal(got.numpy(), ref)
    h = hit.numpy()[0]
    assert h[0].tolist() == [False] * 18 + [True] * 9  # only dz = +1
    assert h[1].tolist() == [False] * 9 + [True] * 18  # z = -1 is outside


def test_head_runs_one_lookup_per_scale(monkeypatch):
    """The head looks up every query of a scale, all samples and the 27
    offsets, in one ``lookup`` call: one launch a scale on the card."""
    calls = []
    orig = sparse.lookup

    def counted(table, queries):
        calls.append(tuple(queries.shape))
        return orig(table, queries)

    monkeypatch.setattr(sparse, "lookup", counted)
    bd, cfg = head_inputs(0)
    head = voxelrcnn_head.VoxelRCNNHead(
        cfg, 0, 1, voxel_size=VS, point_cloud_range=PC,
        multi_scale_channels={k: v[0].shape[-1] for k, v in
                              bd["multi_scale_3d_features"].items()}).eval()
    with torch.no_grad():
        head(bd)
    assert calls == [(2, 16 * 27 * 27)] * 3


# ---------------------------------------------------------------------
# VoxelRCNNHead
# ---------------------------------------------------------------------

def head_inputs(seed, use_bn=False):
    """256 scored boxes in a 12 x 12 m patch (16 RoIs; sample 1 keeps
    fewer) and three stages of active sites around them with random
    features, at the full config's geometry; the head at small widths."""
    rng = np.random.RandomState(seed)
    b, a = 2, 256
    boxes = np.concatenate([rng.uniform([20, -6], [32, 6], (b, a, 2)),
                            rng.uniform(-1.5, -0.5, (b, a, 1)),
                            rng.uniform(1, 4, (b, a, 3)),
                            rng.uniform(-np.pi, np.pi, (b, a, 1))],
                           -1).astype(np.float32)
    boxes[1, 10:] = boxes[1, :1]  # copies of one box: at most 10 RoIs
    ms = {}
    for name, cin, v in (("x_conv2", 6, 4000), ("x_conv3", 8, 2000),
                         ("x_conv4", 8, 800)):
        s = STRIDES[name]
        grid = GRIDS[s]
        cell = np.float32(VS) * np.float32(s)
        keys = np.full((b, v), sparse.INVALID, np.int32)
        for i in range(b):
            p = np.stack([rng.uniform(18, 34, 6 * v),
                          rng.uniform(-8, 8, 6 * v),
                          rng.uniform(-3, 0.5, 6 * v)], -1).astype(np.float32)
            c = np.floor((p - np.float32(PC[:3])) / cell).astype(np.int64)
            k = np.unique((c[:, 2] * grid[1] + c[:, 1]) * grid[2] + c[:, 0])
            k = np.sort(rng.permutation(k)[:v - 100 * i])
            keys[i, :len(k)] = k
        feats = rng.normal(0, 1, (b, v, cin)).astype(np.float32)
        feats[keys == sparse.INVALID] = 0.0
        ms[name] = (_t(feats), _t(keys), grid)
    bd = {"batch_cls_preds": _t(rng.normal(0, 1, (b, a, 1)).astype(
              np.float32)),
          "batch_box_preds": _t(boxes),
          "multi_scale_3d_features": ms,
          "multi_scale_3d_strides": dict(STRIDES)}
    cfg = {"USE_BN": use_bn, "SHARED_FC": [32, 16], "CLS_FC": [16],
           "REG_FC": [16],
           "ROI_GRID_POOL": {"GRID_SIZE": 3,
                             "FEATURES_SOURCE": ["x_conv2", "x_conv3",
                                                 "x_conv4"],
                             "POOL_MLPS": {"x_conv2": [8, 8],
                                           "x_conv3": [8, 8],
                                           "x_conv4": [8]}},
           "NMS_CONFIG": {"TEST": {"NMS_THRESH": 0.7, "NMS_PRE_MAXSIZE": 128,
                                   "NMS_POST_MAXSIZE": 16}},
           "TARGET_CONFIG": {"ROI_PER_IMAGE": 16}}
    return bd, cfg


def jax_head_apply(jmod, bd):
    """The JAX head jitted on ``bd``'s arrays, the voxel size and range
    corner constants of the program (as the detector sets them)."""
    ms = bd["multi_scale_3d_features"]
    arrays = {"cls": bd["batch_cls_preds"].numpy(),
              "boxes": bd["batch_box_preds"].numpy(),
              "ms": {k: (f.numpy(), kk.numpy()) for k, (f, kk, _) in
                     ms.items()}}

    def jbd(a):
        return {"batch_cls_preds": a["cls"], "batch_box_preds": a["boxes"],
                "multi_scale_3d_features": {
                    k: (f, kk, ms[k][2]) for k, (f, kk) in a["ms"].items()},
                "multi_scale_3d_strides": dict(STRIDES),
                "voxel_size_xyz": jnp.asarray(VS, jnp.float32),
                "pc_range_min": jnp.asarray(PC[:3], jnp.float32)}

    return arrays, jbd


@pytest.mark.parametrize("use_bn", [False, True], ids=["no_bn", "bn"])
def test_voxelrcnn_head_equals_jax(use_bn):
    """Proposals, the pooled RoI grid over three scales (misses feed the
    MLP's bias into the max, as in JAX), the shared FCs and both
    branches, the RoIs past the count pooled and scored as in JAX."""
    bd, cfg = head_inputs(1 + use_bn, use_bn)
    jmod = jax_vrcnn.VoxelRCNNHead(model_cfg=cfg, num_class=1)
    arrays, jbd = jax_head_apply(jmod, bd)
    flat = perturb(flatten_variables(jax.jit(
        lambda r, a: jmod.init(r, jbd(a)))(jax.random.PRNGKey(0), arrays)),
        4 + use_bn)
    ref = jax.jit(lambda v, a: jmod.apply(v, jbd(a)))(unflatten(flat), arrays)
    tmod = voxelrcnn_head.VoxelRCNNHead(
        cfg, 0, 1, voxel_size=VS, point_cloud_range=PC,
        multi_scale_channels={"x_conv2": 6, "x_conv3": 8, "x_conv4": 8})
    weights.load_into(tmod, flat).eval()
    with torch.no_grad():
        got = tmod(dict(bd))
    counts = np.asarray(ref["roi_valid"]).sum(-1)
    assert counts[0] == 16 and 0 < counts[1] < 16
    np.testing.assert_array_equal(got["roi_valid"].numpy(),
                                  np.asarray(ref["roi_valid"]))
    for k in ("rois", "rcnn_cls", "rcnn_reg", "batch_box_preds",
              "batch_cls_preds"):
        want = np.asarray(ref[k])
        assert np.abs(want).max() > 0.01
        np.testing.assert_allclose(got[k].numpy(), want, rtol=OP_TOL,
                                   atol=OP_TOL, err_msg=k)
    assert {k.split("/")[1] for k in flat} == {
        "SharedMLP_0", "SharedMLP_1", "SharedMLP_2", "SharedMLP_3",
        "FCStack_0", "FCStack_1"}


# ---------------------------------------------------------------------
# tiny Voxel-RCNN end to end
# ---------------------------------------------------------------------

def tiny_voxelrcnn_cfg():
    """``tests/test_model_zoo.py``'s tiny Voxel-RCNN (12.8 x 12.8 x 4 m at
    0.1 m, a 4³ RoI grid) on ``test_torch_second``'s tiny SECOND, with the
    full config's three pooled scales and its bias-only RoI head; 16 RoIs
    of 128 candidates."""
    cfg = tiny_second_cfg()
    cfg["NAME"] = "VoxelRCNN"
    cfg["ROI_HEAD"] = {
        "NAME": "VoxelRCNNHead", "CLASS_AGNOSTIC": True, "USE_BN": False,
        "SHARED_FC": [32], "CLS_FC": [16], "REG_FC": [16],
        "ROI_GRID_POOL": {
            "GRID_SIZE": 4,
            "FEATURES_SOURCE": ["x_conv2", "x_conv3", "x_conv4"],
            "POOL_MLPS": {"x_conv2": [8, 8], "x_conv3": [8, 8],
                          "x_conv4": [8, 8]}},
        "NMS_CONFIG": {"TEST": {"NMS_TYPE": "nms_gpu", "NMS_THRESH": 0.7,
                                "NMS_PRE_MAXSIZE": 128,
                                "NMS_POST_MAXSIZE": 16}},
        "TARGET_CONFIG": {"ROI_PER_IMAGE": 16},
    }
    return cfg


def run_jax(jmodel, variables, model_cfg, num_class, pts, mask, window):
    """The JAX Voxel-RCNN's detections and what ``chip_smoke.
    check_voxelrcnn_parity`` reads: the best ``window`` anchors by score
    with their scores (``prop_order``, ``prop_scores``; the proposal
    layer's top ``NMS_PRE_MAXSIZE`` are the first), the decoded boxes of
    those candidates, the RoIs with the anchor each came from and their
    count, ``rcnn_cls``, ``rcnn_reg``."""
    roi_cfg = model_cfg["ROI_HEAD"]["NMS_CONFIG"]["TEST"]
    with record_jax_proposals() as props:
        @jax.jit
        def infer(v, p, m):
            out = jmodel.apply(v, {"points": p, "points_mask": m},
                               train=False)
            post = jax_post_processing(out, model_cfg["POST_PROCESSING"],
                                       num_class)
            scores = jnp.max(jax.nn.sigmoid(props["cls"]), axis=-1)
            top, order = jax.lax.top_k(scores, window)
            pre = min(int(roi_cfg["NMS_PRE_MAXSIZE"]), scores.shape[1])
            keep = {k: out[k] for k in ("rois", "roi_valid", "rcnn_cls",
                                        "rcnn_reg")}
            keep.update(
                prop_order=order, prop_scores=top,
                prop_boxes=jnp.take_along_axis(
                    props["boxes"], order[:, :pre, None], axis=1))
            return {k: post[k] for k in OUT_KEYS}, keep

        post, keep = infer(variables, jnp.asarray(pts), jnp.asarray(mask))
    out = {k: np.asarray(v) for k, v in {**post, **keep}.items()}
    out["prop_order"] = out["prop_order"].astype(np.int32)
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
def tiny_run():
    cfg = tiny_voxelrcnn_cfg()
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
    return tiny_run()


def test_tiny_voxelrcnn_matches_jax(tiny):
    """chip_smoke's parity check, held strict: no candidate swapped, no
    RoI list parted, RoIs / rcnn_cls / rcnn_reg / detections within
    1e-4."""
    ref, out, post, cfg = tiny
    assert ref["roi_count"].min() > 0 and ref["pred_count"].min() > 0
    assert tuple(out["batch_box_preds"].shape) == (2, 16, 7)
    assert tuple(out["rpn_box_preds"].shape) == (2, 512, 7)
    res = check_voxelrcnn_parity(out, post, ref, cfg,
                                 DatasetSpec(**TINY_SPEC), tol=TOL)
    assert res["partings"] == [] and res["candidates_swapped"] == 0
    assert res["detections_not_compared"] == []
    assert res["counts"] == ref["pred_count"].tolist()
    np.testing.assert_array_equal(post["pred_labels"].numpy(),
                                  ref["pred_labels"])


@pytest.mark.parametrize("fault", ["score", "order", "roi", "cls", "reg",
                                   "count"])
def test_parity_check_refuses_faults(tiny, fault):
    """``chip_smoke.check_voxelrcnn_parity`` refuses a moved anchor score,
    a candidate swap or RoI change that is no near-tie, a moved
    ``rcnn_cls`` or ``rcnn_reg`` and a changed count."""
    ref, out, post, cfg = tiny
    ref = {k: v.copy() for k, v in ref.items()}
    if fault == "score":
        ref["prop_scores"][0, 5] += 0.01
    elif fault == "order":
        ref["prop_order"][0, [0, 100]] = ref["prop_order"][0, [100, 0]]
    elif fault == "roi":
        ref["roi_idx"][1, 3] = ref["prop_order"][1, 127]
    elif fault == "cls":
        ref["rcnn_cls"][0] += 0.01
    elif fault == "reg":
        ref["rcnn_reg"][1] += 0.01
    elif fault == "count":
        ref["pred_count"][0] += 1
    with pytest.raises(RuntimeError):
        check_voxelrcnn_parity(out, post, ref, cfg, DatasetSpec(**TINY_SPEC),
                               tol=TOL)


def test_grid_face_rois_marks_rois_whose_cells_can_part():
    """A RoI moved by less than a grid point's distance to every cell face
    is not marked; one whose grid point sits on a face is; a RoI moved
    by a cell is."""
    from chip_smoke import grid_face_rois

    vs, pc = (0.1, 0.1, 0.1), (0.0, 0.0, 0.0)
    # grid points at centre + (-1/3, 0, 1/3) x size: cell centres for a
    # 0.6 m box centred on a cell centre
    rois = torch.tensor([[1.05, 1.05, 1.05, 0.6, 0.6, 0.6, 0.0],
                         [1.00, 1.05, 1.05, 0.6, 0.6, 0.6, 0.0],
                         [1.05, 1.05, 1.05, 0.6, 0.6, 0.6, 0.0]])
    ref = rois.clone()
    ref[0, 0] += 1e-5
    ref[2, 0] += 0.1
    on = grid_face_rois(rois, ref, 3, vs, pc, [1])
    assert on.tolist() == [False, True, True]


# ---------------------------------------------------------------------
# the full config: weights, reference
# ---------------------------------------------------------------------

def full_models(with_jax=True):
    """(JAX model or None, port model on the CPU with chip_smoke's seeded
    weights, the flat weights, model cfg, num_class, spec), fp32."""
    cfg = cfg_from_yaml_file(VOXELRCNN_CFG)
    mc = copy.deepcopy(cfg.MODEL)
    mc["COMPUTE_DTYPE"] = "float32"
    nc = len(cfg.CLASS_NAMES)
    spec = spec_from_cfg(cfg)
    tmodel = build_network(mc, nc, spec, device="cpu")
    flat = weights.seeded_flax(tmodel, VOXELRCNN_SEED)
    weights.load_into(tmodel, flat)
    jmodel = None
    if with_jax:
        jmc = copy.deepcopy(dict(jax_cfg_from_yaml(str(VOXELRCNN_CFG))
                                 .MODEL))
        jmc["COMPUTE_DTYPE"] = "float32"
        jmodel = jax_build(jmc, num_class=nc, dataset=JaxSpec(**{
            f: getattr(spec, f) for f in (
                "class_names", "point_feature_dim", "point_cloud_range",
                "voxel_size", "max_voxels", "max_points_per_voxel")}))
    return jmodel, tmodel, flat, mc, nc, spec


@pytest.mark.parametrize("fault", ["none", "transposed_kernel",
                                   "missing_bias", "extra_key"])
def test_converter_consumes_all_164_voxelrcnn_arrays(fault):
    """The full config's seeded flax tree (164 arrays, 10.95 M parameters,
    the layout the JAX model's variables have) lands in the port's
    Voxel-RCNN, every shape checked."""
    _, tmodel, flat, _, _, _ = full_models(with_jax=False)
    assert len(flat) == 164
    assert sum(v.size for v in flat.values()) == 10953884
    key = "params/roi_head/SharedMLP_3/Dense_0/kernel"
    assert flat[key].shape == (20736, 256)  # 6³ grid points x 3 x 32
    for i, cin in enumerate((32, 64, 64)):
        assert flat[f"params/roi_head/SharedMLP_{i}/Dense_0/kernel"].shape \
            == (cin, 32)
    assert flat["params/roi_head/FCStack_0/Dense_2/kernel"].shape == (256, 1)
    assert flat["params/roi_head/FCStack_1/Dense_2/kernel"].shape == (256, 7)
    if fault == "transposed_kernel":
        k = "params/roi_head/SharedMLP_1/Dense_0/kernel"
        flat[k] = flat[k].T.copy()  # (64, 32) as (32, 64)
    elif fault == "missing_bias":
        del flat["params/roi_head/SharedMLP_2/Dense_1/bias"]
    elif fault == "extra_key":
        flat["params/roi_head/SharedMLP_4/Dense_0/kernel"] = flat[key]
    if fault != "none":
        with pytest.raises(ValueError):
            weights.flax_to_torch(flat, tmodel)
        return
    sd = weights.flax_to_torch(flat, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    np.testing.assert_array_equal(
        sd["roi_head.SharedMLP_3.Dense_0.weight"].numpy(), flat[key].T)


def jax_reference(n_scans=2):
    """The JAX Voxel-RCNN in fp32 with the seeded weights on the first
    ``n_scans`` scans clipped to its range. Rewrite the stored fixture
    (about 4 minutes on the CPU) with ``python -c "import sys;
    sys.path.insert(0, 'tests'); import jax;
    jax.config.update('jax_platforms', 'cpu'); import test_torch_voxelrcnn
    as t; t.write_fixture()"``."""
    jmodel, _, flat, mc, nc, _ = full_models()
    pts, mask = load_voxelrcnn_scans()
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
    VOXELRCNN_REF.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(VOXELRCNN_REF, **jax_reference())


def test_fixture_holds_what_the_card_reads():
    """The card's parity phase reads these keys: 2 scans, 100 RoIs each."""
    with np.load(VOXELRCNN_REF) as ref:
        assert set(ref.files) == {
            *OUT_KEYS, "rois", "rcnn_cls", "rcnn_reg", "prop_order",
            "prop_scores", "prop_boxes", "roi_count", "roi_idx"}
        assert ref["rois"].shape == (2, 100, 7)
        assert ref["roi_count"].tolist() == [100, 100]
        assert ref["prop_boxes"].shape == (2, 1024, 7)
        assert ref["pred_count"].min() > 0
    assert VOXELRCNN_REF.stat().st_size < 3 * 2 ** 20


@pytest.mark.slow
def test_voxelrcnn_fixture_equals_fresh_jax_run():
    ref = jax_reference()
    with np.load(VOXELRCNN_REF) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_voxelrcnn_matches_fixture_on_cpu():
    """The Voxel-RCNN parity phase of chip_smoke.py, here on the CPU."""
    _, tmodel, _, mc, nc, spec = full_models(with_jax=False)
    pts, mask = load_voxelrcnn_scans()
    out, post = run_torch(tmodel, mc["POST_PROCESSING"], nc, pts[:2],
                          mask[:2])
    with np.load(VOXELRCNN_REF) as stored:
        res = check_voxelrcnn_parity(out, post, dict(stored), mc, spec,
                                     tol=PARITY_TOL)
    print(res)
    assert res["roi_counts"] == [100, 100]
    assert res["detections_not_compared"] == []
