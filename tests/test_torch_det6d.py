"""Det6D inference: the PyTorch port against the JAX package on the same
inputs and the same weights (flax variables carried across by
``de6d_tpu_torch.weights``), fp32 on the CPU.

Ball-query indices and FPS picks are compared exactly. Features, boxes
and scores: dense sums run in another order in XLA and PyTorch, so fp32
values differ by a few ulps (SA features and scores ~1e-6, boxes after
decode ~1e-6 relative); SA layers are held to 1e-5 and the tiny model's
detections to 1e-4, the tolerances of the PointPillars parity test.
Counts and labels must be equal.
"""

import contextlib
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
    PointnetSAModuleFSMSG as JaxSA,
)
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.models.detectors.detector3d_template import (
    post_processing as jax_post_processing,
)
from de6d_tpu.ops import ball_query as jax_bq
from de6d_tpu.ops import sampling as jax_sampling
from de6d_tpu.utils import box_coder_utils as jax_coders
from de6d_tpu.utils.testing import tiny_det6d_cfg
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config, cfg_from_yaml_file
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.backbones_3d.pointnet2_modules import (
    PointnetSAModuleFSMSG,
)
from de6d_tpu_torch.models.detectors.detector3d_template import (
    DatasetSpec, post_processing,
)
from de6d_tpu_torch.ops import ball_query as bq
from de6d_tpu_torch.utils.box_coder_utils import PointBinResidual6DCoder
from torch_fixtures import flatten_variables, perturb, unflatten

ROOT = Path(__file__).resolve().parents[1]
FULL = ROOT / "configs/kitti_models/det6d_car.yaml"
FIXTURE = ROOT / "de6d_tpu_torch/testdata/det6d_jax_ref.npz"
OUT_KEYS = ("pred_boxes", "pred_scores", "pred_labels", "pred_count")
TINY_RANGE = (0.0, -16.0, -3.0, 32.0, 16.0, 4.0)
RTOL = ATOL = 1e-4
SA_TOL = 1e-5


def scene(seed, b, n, pc, n_valid=None, clusters=8):
    """Uniform points in ``pc`` plus dense clusters; rows past
    ``n_valid[i]`` are zero padding, masked off."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n, 4), np.float32)
    for d in range(3):
        pts[..., d] = rng.uniform(pc[d], pc[d + 3], (b, n))
    per = n // (2 * clusters)
    for c in range(clusters):
        ctr = pts[:, c * per, :3].copy()
        pts[:, c * per:(c + 1) * per, :3] = (
            ctr[:, None] + rng.normal(0, 0.4, (b, per, 3)))
    pts[..., 3] = rng.uniform(0, 1, (b, n))
    valid = np.ones((b, n), bool)
    for i, nv in enumerate(n_valid or []):
        valid[i, nv:] = False
        pts[i, nv:] = 0.0
    return pts, valid


# ---------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------

def test_ball_query_equals_jax_including_annuli():
    pts, valid = scene(0, 2, 600, TINY_RANGE, n_valid=(600, 450))
    xyz = pts[..., :3]
    centers = xyz[:, ::3].copy()
    cvalid = valid[:, ::3].copy()
    cvalid[0, 7] = False
    scales = [(0.5, 0.0, 8), (1.0, 0.5, 16), (2.5, 1.0, 24)]
    got = bq.ball_query_scales(torch.from_numpy(xyz),
                               torch.from_numpy(centers), scales,
                               torch.from_numpy(valid),
                               torch.from_numpy(cvalid))
    hits = 0
    for (r, ri, ns), (idx, cnt) in zip(scales, got):
        ref_idx, ref_cnt = jax_bq.ball_query(
            jnp.asarray(xyz), jnp.asarray(centers), r, ns,
            jnp.asarray(valid), jnp.asarray(cvalid), radius_in=ri)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_cnt))
        one = bq.ball_query(torch.from_numpy(xyz), torch.from_numpy(centers),
                            r, ns, torch.from_numpy(valid),
                            torch.from_numpy(cvalid), radius_in=ri)
        assert all(torch.equal(a, b) for a, b in zip(one, (idx, cnt)))
        hits += int(cnt.sum())
        assert (cnt == ns).any() and (cnt == 0).any(), "test needs both"
    assert hits > 1000


def test_ball_query_equals_jax_on_a_real_scan():
    """SA1 of Det6D on one real scan (16384 rows, 4096 d-fps centers,
    dilated radii): the port's brute query equals the JAX package's
    brute query and its binned query (the path JAX takes there)."""
    from de6d_tpu.ops import binned as jax_binned

    pts, mask, pc = full_inputs(1)
    xyz = np.ascontiguousarray(pts[..., :3])
    picks = np.asarray(jax_sampling._farthest_point_sample_jnp(
        jnp.asarray(xyz), 4096, jnp.asarray(mask)))
    centers = np.take_along_axis(xyz, picks[..., None], axis=1)
    cvalid = np.take_along_axis(mask, picks, axis=1)
    scales = [(0.2, 0.0, 32), (0.4, 0.2, 32), (0.8, 0.4, 64)]
    got = bq.ball_query_scales(torch.from_numpy(xyz),
                               torch.from_numpy(centers), scales,
                               torch.from_numpy(mask),
                               torch.from_numpy(cvalid))
    args = [jnp.asarray(a) for a in (xyz, centers, mask, cvalid)]
    binned, overflow = jax_binned.binned_msg_query(
        args[0], args[1], tuple(r for r, _, _ in scales),
        tuple(n for _, _, n in scales), args[2], args[3],
        radius_in_list=tuple(ri for _, ri, _ in scales), pc_range=pc)
    assert int(np.asarray(overflow).max()) == 0
    for (r, ri, ns), (idx, cnt), (b_idx, b_cnt) in zip(scales, got, binned):
        ref_idx, ref_cnt = jax_bq.ball_query(*args[:2], r, ns, *args[2:],
                                             radius_in=ri)
        for ref_i, ref_c in ((ref_idx, ref_cnt), (b_idx, b_cnt)):
            np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_i))
            np.testing.assert_array_equal(cnt.numpy(), np.asarray(ref_c))
        assert int(cnt.sum()) > 10000


def test_sqdist_rounds_like_xla():
    """``d²`` equals the JAX package's ``_pairwise_sqdist`` bit for bit
    (its fused multiply-adds included) at KITTI coordinates."""
    rng = np.random.RandomState(1)
    a = rng.uniform(-40, 70, (300, 3)).astype(np.float32)
    p = rng.uniform(-40, 70, (700, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(jax_bq._pairwise_sqdist)(jnp.asarray(a),
                                                      jnp.asarray(p)))
    got = bq.pairwise_sqdist(torch.from_numpy(a)[None],
                             torch.from_numpy(p)[None])[0]
    np.testing.assert_array_equal(got.numpy(), ref)


def _sa_pair(folded, method, seed):
    kw = dict(
        radii=(0.6, 1.2), nsamples=(8, 16), mlps=((16, 16), (16, 32)),
        npoint_list=(96,), sample_range_list=((0, -1),),
        sample_method_list=(method,), dilated_radius_group=True,
        aggregation_mlp=(32,), confidence_mlp=(16,),
        pc_range=TINY_RANGE if folded else (), bin_cell_cap=16,
        bin_spill_cap=32,
    )
    pts, valid = scene(seed, 2, 512, TINY_RANGE, n_valid=(512, 400))
    xyz, feats = pts[..., :3], pts[..., 3:]
    scores = np.random.RandomState(seed + 1).normal(
        0, 2, valid.shape).astype(np.float32)
    jmod = JaxSA(**kw)
    args = [jnp.asarray(a) for a in (xyz, feats, valid, scores)]
    flat = perturb(flatten_variables(
        jmod.init(jax.random.PRNGKey(seed), *args)), seed)
    ref = jmod.apply(unflatten(flat), *args)
    tmod = PointnetSAModuleFSMSG(in_channels=1, **kw)
    weights.load_into(tmod, flat).eval()
    assert tmod._binned_ok(512) == jmod._binned_ok(512) == folded
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (xyz, feats, valid,
                                                    scores)))
    return ref, got


@pytest.mark.parametrize("folded", [True, False], ids=["folded", "unfolded"])
@pytest.mark.parametrize("method", ["d-fps", "s-fps"])
def test_sa_layer_equals_jax(folded, method):
    ref, got = _sa_pair(folded, method, seed=7 if folded else 8)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    for i in (1, 2):  # features, confidence scores
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=SA_TOL, atol=SA_TOL)
    assert float(np.abs(np.asarray(ref[1])).max()) > 0.1


@pytest.mark.parametrize("ground_aware", [True, False])
def test_6d_coder_decode_equals_jax(ground_aware):
    cfg = dict(use_mean_size=False, angle_bin_num=12,
               ground_aware=ground_aware, threshold=10, factor=45)
    rng = np.random.RandomState(2)
    enc = rng.normal(0, 1, (64, 32 if ground_aware else 31)).astype(
        np.float32)
    pts = rng.uniform(-20, 20, (64, 3)).astype(np.float32)
    if ground_aware:  # the gating case of tests/test_det6d_e2e.py
        enc[0] = 0.0
        enc[0, 3:6] = 0.1
        enc[0, 30], enc[0, 31] = 10.0, 0.5
        enc[1, 30], enc[1, 31] = -10.0, 0.5
    ref = np.asarray(jax_coders.PointBinResidual6DCoder(**cfg).decode(
        jnp.asarray(enc), jnp.asarray(pts)))
    coder = PointBinResidual6DCoder(**cfg)
    got = coder.decode(torch.from_numpy(enc), torch.from_numpy(pts)).numpy()
    assert got.shape == (64, 9) and coder.code_size == enc.shape[1]
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[:, 8], 0.0)  # roll
    np.testing.assert_array_equal(got[:, 7] == 0.0, ref[:, 7] == 0.0)
    if ground_aware:
        assert got[1, 7] == 0.0
        assert got[0, 7] == pytest.approx(
            -np.deg2rad(10) - 0.5 * np.deg2rad(45), abs=1e-6)


# ---------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------

@contextlib.contextmanager
def record_jax_picks():
    """Record the JAX package's per-SA-layer FPS picks (in call order)."""
    rec = []
    orig = (jax_sampling.farthest_point_sample,
            jax_sampling.weighted_farthest_point_sample)

    def wrap(fn):
        def run(*a, **k):
            rec.append(fn(*a, **k))
            return rec[-1]
        return run

    jax_sampling.farthest_point_sample = wrap(orig[0])
    jax_sampling.weighted_farthest_point_sample = wrap(orig[1])
    try:
        yield rec
    finally:
        (jax_sampling.farthest_point_sample,
         jax_sampling.weighted_farthest_point_sample) = orig


def run_jax(jmodel, variables, post_cfg, num_class, pts, mask):
    with record_jax_picks() as rec:
        @jax.jit
        def infer(v, p, m):
            rec.clear()
            out = jmodel.apply(v, {"points": p, "points_mask": m},
                               train=False)
            post = jax_post_processing(out, post_cfg, num_class)
            scores = [s for s in out["point_scores_list"] if s is not None]
            return {k: post[k] for k in OUT_KEYS}, list(rec), scores

        post, picks, scores = infer(variables, jnp.asarray(pts),
                                    jnp.asarray(mask))
    out = {k: np.asarray(v) for k, v in post.items()}
    for i, p in enumerate(picks):
        out[f"picks_{i}"] = np.asarray(p)
    for i, s in enumerate(scores):  # the s-fps weights' logits
        out[f"scores_{i}"] = np.asarray(s)
    return out


def run_torch(tmodel, post_cfg, num_class, pts, mask):
    """→ (the port's batch dict, its post-processed detections)."""
    with torch.no_grad():
        out = tmodel({"points": torch.from_numpy(pts),
                      "points_mask": torch.from_numpy(mask)})
        return out, post_processing(out, post_cfg, num_class)


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_det6d_cfg()
    tcfg = Config(copy.deepcopy(dict(jcfg)))
    spec_kw = dict(class_names=("Car",), point_feature_dim=4,
                   point_cloud_range=TINY_RANGE)
    jmodel = jax_build(jcfg, num_class=1, dataset=JaxSpec(**spec_kw))
    tmodel = build_network(tcfg, 1, DatasetSpec(**spec_kw), device="cpu")
    # the spec of tests/test_det6d_e2e.py: B = 2, N = 512
    pts, mask = scene(4, 2, 512, (0.0, -16.0, -2.0, 32.0, 16.0, 2.0))
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0),
        {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)},
    )
    flat = perturb(flatten_variables(init), seed=5)
    weights.load_into(tmodel, flat)
    post_cfg = tcfg["POST_PROCESSING"]
    ref = run_jax(jmodel, unflatten(flat), jcfg["POST_PROCESSING"], 1, pts,
                  mask)
    return ref, run_torch(tmodel, post_cfg, 1, pts, mask)


def test_tiny_det6d_matches_jax(tiny):
    """Per-layer picks identical (no near-tie parting), counts and labels
    equal, 9-column boxes and scores within 1e-4: chip_smoke's parity
    check, held strict."""
    from chip_smoke import check_det6d_parity

    ref, (out, post) = tiny
    assert ref["pred_count"].min() > 0, "test needs detections"
    assert [ref[f"picks_{i}"].shape[1] for i in range(3)] == [256, 128, 64]
    res = check_det6d_parity(out, post, ref, tol=RTOL)
    assert res["partings"] == [] and res["picks_differing"] == [0, 0, 0]


@pytest.mark.parametrize("fault", ["sa1", "sa2_swap", "count"])
def test_parity_check_refuses_faults(tiny, fault):
    """``chip_smoke.check_det6d_parity`` refuses a changed d-fps pick, an
    s-fps swap that is no near-tie, and a changed count."""
    from chip_smoke import check_det6d_parity

    ref, (out, post) = tiny
    ref = {k: v.copy() for k, v in ref.items()}
    if fault == "sa1":
        ref["picks_0"][1, 10] = ref["picks_0"][1, 11]
    elif fault == "sa2_swap":
        ref["picks_1"][0, [5, 6]] = ref["picks_1"][0, [6, 5]]
    elif fault == "count":
        ref["pred_count"][0] += 1
    with pytest.raises(RuntimeError):
        check_det6d_parity(out, post, ref, tol=RTOL)


# ---------------------------------------------------------------------
# full-width reference for the card (which has no JAX)
# ---------------------------------------------------------------------

def full_inputs(n_scans=2):
    """The first ``n_scans`` Det6D scans prepared as bench.py does: real
    rows clipped into the range ± 0.01, zero padding masked off."""
    cfg = cfg_from_yaml_file(FULL)
    pc = [float(x) for x in cfg.DATA_CONFIG.POINT_CLOUD_RANGE]
    pts = np.load(ROOT / "bench_assets/det6d_car_scans.npz")["points"]
    pts = pts[:n_scans].astype(np.float32)
    mask = ~np.all(pts == 0, axis=-1)
    for d in range(3):
        pts[..., d] = np.clip(pts[..., d], pc[d] + 0.01, pc[d + 3] - 0.01)
    pts[~mask] = 0.0
    return pts, mask, tuple(pc)


def fp32_model_cfg(cfg):
    """fp32 everywhere, the head's own bf16 override removed."""
    mc = copy.deepcopy(cfg.MODEL)
    mc["COMPUTE_DTYPE"] = "float32"
    mc["POINT_HEAD"].pop("_COMPUTE_DTYPE", None)
    return mc


def jax_reference(n_scans=2):
    """The JAX model in fp32 with the bench_assets weights on the first
    ``n_scans`` scans → detections and per-layer picks. Rewrite the
    stored fixture with ``python -c "import sys; sys.path.insert(0,
    'tests'); import test_torch_det6d as t; t.write_fixture()"``."""
    jcfg = jax_cfg_from_yaml(str(FULL))
    mc = fp32_model_cfg(jcfg)
    pts, mask, pc = full_inputs(n_scans)
    jmodel = jax_build(mc, num_class=1, dataset=JaxSpec(
        class_names=tuple(jcfg.CLASS_NAMES), point_feature_dim=4,
        point_cloud_range=pc))
    flat = weights.load_flax_npz(ROOT / "bench_assets/det6d_car_params.npz")
    return run_jax(jmodel, unflatten(flat), mc["POST_PROCESSING"], 1, pts,
                   mask)


def write_fixture():
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **jax_reference())


@pytest.mark.slow
def test_det6d_fixture_equals_fresh_jax_run():
    ref = jax_reference()
    with np.load(FIXTURE) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_det6d_matches_fixture_on_cpu():
    """The Det6D parity phase of chip_smoke.py, here on the CPU (where the
    SA2 and SA3 picks part from the reference at near-ties: the SA1
    confidence scores differ from XLA's by ulps)."""
    cfg = cfg_from_yaml_file(FULL)
    mc = fp32_model_cfg(cfg)
    pts, mask, pc = full_inputs()
    model = build_network(mc, 1, DatasetSpec(
        class_names=tuple(cfg.CLASS_NAMES), point_feature_dim=4,
        point_cloud_range=pc), device="cpu")
    weights.load_into(model, weights.load_flax_npz(
        ROOT / "bench_assets/det6d_car_params.npz"))
    out, post = run_torch(model, mc["POST_PROCESSING"], 1, pts, mask)
    from chip_smoke import PARITY_TOL, check_det6d_parity

    with np.load(FIXTURE) as stored:
        res = check_det6d_parity(out, post, dict(stored), tol=PARITY_TOL)
    assert res["picks_differing"][0] == 0
