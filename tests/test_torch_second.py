"""SECOND inference (MeanVFE, VoxelBackBone8x / VoxelResBackBone8x,
HeightCompression, BaseBEVBackbone, AnchorHeadSingle): the PyTorch port
against the JAX package on the same points and the same weights, fp32 on
the CPU.

The voxel buffer is copied points and must be identical; site keys are
integers and must be identical at every stage. Features, predictions
and detections are held to rtol 1e-4 / atol 1e-4 (sparse and dense conv
sums in another order); counts and labels to equality. The full-width
comparison with the stored JAX fixture (``chip_smoke.
check_second_parity``, the card's parity phase) is in the slow tier.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    PARITY_TOL, SECOND_CFG, SECOND_PARAMS, SECOND_REF, check_second_parity,
    load_second_scans, second_stage_keys, spec_from_cfg,
)
from de6d_tpu.config import Config as JaxConfig
from de6d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from de6d_tpu.models import build_network as jax_build
from de6d_tpu.models.backbones_3d import spconv_backbone as jax_spconv
from de6d_tpu.models.backbones_3d.vfe.mean_vfe import MeanVFE as JaxMeanVFE
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.models.detectors.detector3d_template import (
    post_processing as jax_post_processing,
)
from de6d_tpu.ops import sparse as jsp
from de6d_tpu.ops import voxelize as jax_voxelize
from de6d_tpu.ops.nms import NEG_INF
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config, cfg_from_yaml_file
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.backbones_3d import spconv_backbone
from de6d_tpu_torch.models.backbones_3d.vfe.mean_vfe import MeanVFE
from de6d_tpu_torch.models.detectors.detector3d_template import (
    DatasetSpec, post_processing,
)
from de6d_tpu_torch.ops import sparse, voxelize
from torch_fixtures import unflatten

RTOL = ATOL = 1e-4
OUT_KEYS = ("pred_boxes", "pred_scores", "pred_labels", "pred_count")
TINY_SPEC = dict(
    class_names=("Car",), point_feature_dim=4,
    point_cloud_range=(0.0, -6.4, -3.0, 12.8, 6.4, 1.0),
    voxel_size=(0.1, 0.1, 0.1), max_voxels=2000, max_points_per_voxel=5,
)
TINY_GRID = (128, 128, 40)  # (nx, ny, nz)
TINY_BACKBONE = {"NUM_FILTERS": [8, 8, 16, 16, 16], "OUT_CHANNELS": 16}
TINY_SEED = 11


def scene(seed, b=2, n=2048, n_valid=1900, pc=TINY_SPEC["point_cloud_range"]):
    """A ground patch and a few box-shaped objects (enough neighbouring
    voxels for every stage), a few points outside the range, zero
    padding rows masked off."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, 4), np.float32)
    for i in range(b):
        n_ground = n_valid // 2
        g = pts[i, :n_ground]
        g[:, 0] = rng.uniform(pc[0] + 2, pc[0] + 8, n_ground)
        g[:, 1] = rng.uniform(-3, 3, n_ground)
        g[:, 2] = -1.7 + rng.normal(0, 0.03, n_ground)
        o = pts[i, n_ground:n_valid]
        centres = rng.uniform([pc[0] + 1, pc[1] + 1], [pc[3] - 1, pc[4] - 1],
                              (4, 2))
        which = rng.randint(0, 4, len(o))
        o[:, 0] = centres[which, 0] + rng.uniform(-1.8, 1.8, len(o))
        o[:, 1] = centres[which, 1] + rng.uniform(-0.8, 0.8, len(o))
        o[:, 2] = rng.uniform(-1.7, -0.2, len(o))
        o[:8, 0] = pc[3] + 1.0  # outside the range
        pts[i, :n_valid, 3] = rng.uniform(0, 1, n_valid)
    mask = np.zeros((b, n), bool)
    mask[:, :n_valid] = True
    return pts, mask


# ---------------------------------------------------------------------
# voxel buffer and MeanVFE
# ---------------------------------------------------------------------

@pytest.mark.parametrize("p,max_voxels", [(5, 2000), (3, 400)])
def test_voxel_buffer_and_mean_vfe_equal_jax(p, max_voxels):
    """The buffer is bit-exact (a cap of 400 voxels overflows and a cap of
    3 points drops points); the mean sums points in the same order."""
    pts, mask = scene(3)
    pc, vs = TINY_SPEC["point_cloud_range"], TINY_SPEC["voxel_size"]
    vox = voxelize.voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                            pc, vs, max_voxels, p)
    buf = voxelize.voxel_buffer(torch.from_numpy(pts), vox["order"],
                                vox["voxel_starts"], vox["voxel_num_points"],
                                p).numpy()
    ref = jax.vmap(lambda a, m: jax_voxelize.voxelize(
        a, m, pc, vs, max_voxels, p))(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_array_equal(buf, np.asarray(ref["voxels"]))
    assert buf.shape == (2, max_voxels, p, 4)
    assert (np.asarray(ref["voxel_num_points"]) > 1).any()

    bd = dict(vox, points=torch.from_numpy(pts), _points_per_voxel_cap=p)
    got = MeanVFE({}, 4)(bd)["voxel_features"].numpy()
    want = JaxMeanVFE(model_cfg={}, num_point_features=4).apply(
        {}, {"voxels": ref["voxels"],
             "voxel_num_points": ref["voxel_num_points"]})["voxel_features"]
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------
# tiny SECOND end to end
# ---------------------------------------------------------------------

def tiny_second_cfg(backbone="VoxelBackBone8x"):
    """tests/test_sparse_conv.py's tiny SECOND: 12.8 x 12.8 x 4 m at 0.1 m,
    2000 voxels, sparse filters [8, 8, 16, 16, 16]."""
    import model_fixtures

    cfg = model_fixtures.tiny_pointpillar_cfg(num_class=1)[0].to_dict()
    cfg["NAME"] = "SECONDNet"
    cfg["VFE"] = {"NAME": "MeanVFE"}
    cfg["BACKBONE_3D"] = dict(TINY_BACKBONE, NAME=backbone)
    cfg["MAP_TO_BEV"] = {"NAME": "HeightCompression", "NUM_BEV_FEATURES": 32}
    cfg["BACKBONE_2D"] = {
        "NAME": "BaseBEVBackbone", "LAYER_NUMS": [1, 1],
        "LAYER_STRIDES": [1, 2], "NUM_FILTERS": [32, 64],
        "UPSAMPLE_STRIDES": [1, 2], "NUM_UPSAMPLE_FILTERS": [32, 32],
    }
    anchors = cfg["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"]
    anchors[0]["feature_map_stride"] = 8
    cfg["DENSE_HEAD"]["ANCHOR_GENERATOR_CONFIG"] = anchors[:1]
    cfg["COMPUTE_DTYPE"] = "float32"
    return cfg


def jax_variable_shapes(jmodel, batch):
    shapes = jax.eval_shape(
        lambda r, bd: jmodel.init(r, bd, train=False), jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return {"/".join(k): v.shape for k, v in
            __import__("flax").traverse_util.flatten_dict(shapes).items()}


def run_jax_second(jmodel, variables, post_cfg, num_class, pts, mask, caps):
    """The JAX SECOND on (B, N, 4) points → what ``chip_smoke.
    check_second_parity`` reads: each stage's sorted keys (``keys_1`` ..
    ``keys_5``; the last from the JAX ``downsample_coords`` of x_conv4, as
    the final (3, 1, 1) layer finds them), the ``NMS_PRE_MAXSIZE``
    candidates (``lax.top_k`` of the gated scores, which the JAX
    post-processing's two-stage top-k equals) and the detections."""
    pre_k = int(post_cfg["NMS_CONFIG"]["NMS_PRE_MAXSIZE"])
    thresh = float(post_cfg.get("SCORE_THRESH", 0.1))

    @jax.jit
    def infer(v, p, m):
        out = jmodel.apply(v, {"points": p, "points_mask": m}, train=False)
        post = jax_post_processing(out, post_cfg, num_class)
        ms = out["multi_scale_3d_features"]
        keys = [ms[f"x_conv{s}"][1] for s in range(1, 5)]
        grid4 = ms["x_conv4"][2]
        keys.append(jax.vmap(lambda k: jsp.downsample_coords(
            k, grid4, (2, 1, 1), (0, 0, 0), caps[3], (3, 1, 1))[0])(keys[3]))
        cls = jax.nn.sigmoid(out["batch_cls_preds"])
        scores = jnp.max(cls, axis=-1)
        masked = jnp.where(scores >= thresh, scores, NEG_INF)
        top, order = jax.lax.top_k(masked, min(pre_k, masked.shape[1]))
        boxes = jnp.take_along_axis(out["batch_box_preds"],
                                    order[..., None], axis=1)
        labels = jnp.take_along_axis(jnp.argmax(cls, axis=-1) + 1, order,
                                     axis=1)
        mid = {k: out[k] for k in ("encoded_spconv_tensor",
                                   "spatial_features_2d", "batch_cls_preds")}
        mid.update({f"feats_{s}": ms[f"x_conv{s}"][0] for s in range(1, 5)})
        return ({k: post[k] for k in OUT_KEYS}, keys, top, order, boxes,
                labels, mid)

    post, keys, top, order, boxes, labels, mid = infer(
        variables, jnp.asarray(pts), jnp.asarray(mask))
    ref = {k: np.asarray(v) for k, v in post.items()}
    ref.update({f"keys_{s + 1}": np.asarray(k).astype(np.int32)
                for s, k in enumerate(keys)})
    ref.update(cand_scores=np.asarray(top), cand_order=np.asarray(
        order).astype(np.int32), cand_boxes=np.asarray(boxes),
        cand_labels=np.asarray(labels).astype(np.int32))
    return ref, {k: np.asarray(v) for k, v in mid.items()}


def run_torch(tmodel, post_cfg, num_class, pts, mask):
    with torch.no_grad():
        out = tmodel({"points": torch.as_tensor(pts),
                      "points_mask": torch.as_tensor(mask)})
        post = post_processing(out, post_cfg, num_class)
    return out, post


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_second_cfg()
    jmodel = jax_build(JaxConfig(copy.deepcopy(cfg)), num_class=1,
                       dataset=JaxSpec(**TINY_SPEC))
    tmodel = build_network(Config(copy.deepcopy(cfg)), 1,
                           DatasetSpec(**TINY_SPEC), device="cpu")
    flat = weights.seeded_flax(tmodel, TINY_SEED)
    weights.load_into(tmodel, flat)
    pts, mask = scene(0)
    shapes = jax_variable_shapes(jmodel, {"points": pts, "points_mask": mask})
    post_cfg = cfg["POST_PROCESSING"]
    ref, mid = run_jax_second(jmodel, unflatten(flat), post_cfg, 1, pts,
                              mask, [2000, 2000, 1000, 500])
    out, post = run_torch(tmodel, post_cfg, 1, pts, mask)
    return {"flat": flat, "shapes": shapes, "ref": ref, "mid": mid,
            "out": out, "post": post, "post_cfg": post_cfg}


def test_seeded_flax_fills_both_models(tiny):
    assert {k: v.shape for k, v in tiny["flat"].items()} == tiny["shapes"]
    assert any("SparseDownLayer_3/kernel" in k for k in tiny["flat"])


def test_tiny_stage_keys_and_features_match_jax(tiny):
    out, ref, mid = tiny["out"], tiny["ref"], tiny["mid"]
    keys = second_stage_keys(out)
    sites = []
    for s, k in enumerate(keys, start=1):
        np.testing.assert_array_equal(k.numpy(), ref[f"keys_{s}"])
        sites.append((k != sparse.INVALID).sum(-1).tolist())
    assert min(min(c) for c in sites) > 0, sites
    for s in range(1, 5):
        np.testing.assert_allclose(
            out["multi_scale_3d_features"][f"x_conv{s}"][0].numpy(),
            mid[f"feats_{s}"], rtol=RTOL, atol=ATOL, err_msg=f"x_conv{s}")
    for k in ("encoded_spconv_tensor", "spatial_features_2d",
              "batch_cls_preds"):
        np.testing.assert_allclose(out[k].numpy(), mid[k], rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert out["encoded_spconv_tensor"].shape == (2, 2, 16, 16, 16)
    assert out["spatial_features"].shape == (2, 16, 16, 32)


def test_tiny_second_end_to_end_matches_jax(tiny):
    ref, post = tiny["ref"], tiny["post"]
    got = {k: v.numpy() for k, v in post.items()}
    assert ref["pred_count"].min() > 0, "test needs detections"
    np.testing.assert_array_equal(got["pred_count"], ref["pred_count"])
    for b, c in enumerate(ref["pred_count"].tolist()):
        np.testing.assert_array_equal(got["pred_labels"][b, :c],
                                      ref["pred_labels"][b, :c])
        for k in ("pred_boxes", "pred_scores"):
            np.testing.assert_allclose(got[k][b, :c], ref[k][b, :c],
                                       rtol=RTOL, atol=ATOL, err_msg=k)
    res = check_second_parity(tiny["out"], post, ref, tiny["post_cfg"],
                              tol=RTOL)
    assert res["counts"] == ref["pred_count"].tolist()


@pytest.mark.parametrize("fault", ["keys", "score", "order", "count",
                                   "label"])
def test_parity_check_refuses_faults(tiny, fault):
    """``chip_smoke.check_second_parity`` refuses a changed stage key, a
    moved candidate score, a candidate swap that is no near-tie, a changed
    count and a changed label."""
    ref = {k: v.copy() for k, v in tiny["ref"].items()}
    if fault == "keys":
        ref["keys_3"][1, 0] += 1
    elif fault == "score":
        ref["cand_scores"][0, 3] += 0.01
    elif fault == "order":
        live = int((ref["cand_scores"][0] > NEG_INF / 2).sum())
        ref["cand_order"][0, [0, live - 1]] = ref["cand_order"][0,
                                                             [live - 1, 0]]
        ref["cand_scores"][0, [0, live - 1]] = ref["cand_scores"][0,
                                                               [live - 1, 0]]
    elif fault == "count":
        ref["pred_count"][0] += 1
    elif fault == "label":
        ref["pred_labels"][0, 0] += 1
    with pytest.raises(RuntimeError):
        check_second_parity(tiny["out"], tiny["post"], ref, tiny["post_cfg"],
                            tol=RTOL)


def test_voxel_res_backbone_matches_jax():
    """VoxelResBackBone8x alone at the tiny size, on the tiny scene's
    voxels."""
    pts, mask = scene(5)
    pc, vs = TINY_SPEC["point_cloud_range"], TINY_SPEC["voxel_size"]
    vox = voxelize.voxelize(torch.from_numpy(pts), torch.from_numpy(mask),
                            pc, vs, 2000, 5)
    bd = MeanVFE({}, 4)(dict(vox, points=torch.from_numpy(pts),
                             _points_per_voxel_cap=5))
    feats, coords = bd["voxel_features"], bd["voxel_coords"]
    cfg = dict(TINY_BACKBONE, NUM_FILTERS=[8, 8, 16, 16, 16])
    tmod = spconv_backbone.VoxelResBackBone8x(cfg, 4, grid_size=TINY_GRID)
    tmod.eval()  # against JAX's train=False: the running statistics
    flat = weights.seeded_flax(tmod, 3)
    weights.load_into(tmod, flat)
    with torch.no_grad():
        out = tmod({"voxel_features": feats, "voxel_coords": coords})
    jmod = jax_spconv.VoxelResBackBone8x(model_cfg=cfg, input_channels=4,
                                         grid_size=TINY_GRID)
    ref = jax.jit(lambda v, f, c: jmod.apply(
        v, {"voxel_features": f, "voxel_coords": c}, train=False))(
        unflatten(flat), jnp.asarray(feats.numpy()),
        jnp.asarray(coords.numpy()))
    assert any(k.startswith("params/SparseBasicBlock_6/SubMConvLayer_1")
               for k in flat)
    for s in range(1, 5):
        g, k_, _ = out["multi_scale_3d_features"][f"x_conv{s}"]
        rg, rk, _ = ref["multi_scale_3d_features"][f"x_conv{s}"]
        np.testing.assert_array_equal(k_.numpy(), np.asarray(rk))
        np.testing.assert_allclose(g.numpy(), np.asarray(rg), rtol=RTOL,
                                   atol=ATOL, err_msg=f"x_conv{s}")
    np.testing.assert_allclose(out["encoded_spconv_tensor"].numpy(),
                               np.asarray(ref["encoded_spconv_tensor"]),
                               rtol=RTOL, atol=ATOL)
    assert np.abs(out["encoded_spconv_tensor"].numpy()).max() > 0


# ---------------------------------------------------------------------
# trained weights
# ---------------------------------------------------------------------

def second_model(device="cpu"):
    cfg = cfg_from_yaml_file(SECOND_CFG)
    mc = copy.deepcopy(cfg.MODEL)
    mc["COMPUTE_DTYPE"] = "float32"
    return build_network(mc, 3, spec_from_cfg(cfg), device=device), mc


@pytest.mark.parametrize("fault", ["none", "transposed_kernel",
                                   "missing_bn_var", "extra_key"])
def test_converter_consumes_all_136_second_arrays(fault):
    """bench_assets/second_params.npz (float16 on disk, loaded as fp32):
    all 136 arrays land in the port's SECOND and every shape is checked."""
    model, _ = second_model()
    flat = weights.load_flax_npz(SECOND_PARAMS)
    assert len(flat) == 136
    assert all(v.dtype == np.float32 for v in flat.values())
    key = "params/backbone_3d/SubMConvLayer_2/kernel"
    if fault == "transposed_kernel":  # (27, 4, 16) as (27, 16, 4)
        k0 = "params/backbone_3d/SubMConvLayer_0/kernel"
        flat[k0] = flat[k0].transpose(0, 2, 1).copy()
    elif fault == "missing_bn_var":
        del flat["batch_stats/backbone_3d/SparseDownLayer_1/"
                 "MaskedBatchNorm_0/var"]
    elif fault == "extra_key":
        flat["params/backbone_3d/SubMConvLayer_8/kernel"] = flat[key]
    if fault != "none":
        with pytest.raises(ValueError):
            weights.flax_to_torch(flat, model)
        return
    sd = weights.flax_to_torch(flat, model)
    assert set(sd) == set(model.state_dict())
    assert tuple(sd["backbone_3d.SparseDownLayer_3.weight"].shape) == (
        3, 64, 128)
    np.testing.assert_array_equal(sd["backbone_3d.SubMConvLayer_2.weight"],
                                  flat[key])


# ---------------------------------------------------------------------
# full-width reference for the card (which has no JAX)
# ---------------------------------------------------------------------

def jax_reference(n_scans=2):
    """The JAX SECOND in fp32 with bench_assets/second_params.npz on the
    first ``n_scans`` scans clipped to SECOND's range. Rewrite the stored
    fixture (about a minute on the CPU) with ``python -c "import sys;
    sys.path.insert(0, 'tests'); import test_torch_second as t;
    t.write_fixture()"``."""
    jcfg = jax_cfg_from_yaml(str(SECOND_CFG))
    mc = copy.deepcopy(dict(jcfg.MODEL))
    mc["COMPUTE_DTYPE"] = "float32"
    cfg = cfg_from_yaml_file(SECOND_CFG)
    spec = spec_from_cfg(cfg)
    jmodel = jax_build(mc, num_class=3, dataset=JaxSpec(**{
        f: getattr(spec, f) for f in (
            "class_names", "point_feature_dim", "point_cloud_range",
            "voxel_size", "max_voxels", "max_points_per_voxel")}))
    pts, mask = load_second_scans()
    v = spec.max_voxels
    ref, _ = run_jax_second(
        jmodel, unflatten(weights.load_flax_npz(SECOND_PARAMS)),
        mc["POST_PROCESSING"], 3, pts[:n_scans], mask[:n_scans],
        [v, v, v // 2, v // 4])
    return ref


def write_fixture():
    SECOND_REF.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(SECOND_REF, **jax_reference())


@pytest.mark.slow
def test_second_fixture_equals_fresh_jax_run():
    ref = jax_reference()
    with np.load(SECOND_REF) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_second_matches_fixture_on_cpu():
    """The SECOND parity phase of chip_smoke.py, here on the CPU."""
    model, mc = second_model()
    weights.load_into(model, weights.load_flax_npz(SECOND_PARAMS))
    pts, mask = load_second_scans()
    out, post = run_torch(model, mc["POST_PROCESSING"], 3, pts[:2], mask[:2])
    with np.load(SECOND_REF) as stored:
        res = check_second_parity(out, post, dict(stored),
                                  mc["POST_PROCESSING"], tol=PARITY_TOL)
    print(res)
    assert res["stage_sites"][0] == out["num_voxels"].tolist()
