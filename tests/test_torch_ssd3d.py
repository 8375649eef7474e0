"""3DSSD / 3DSSD-SASA inference: the PyTorch port against the JAX package
on the same inputs and the same weights (flax variables carried across
by ``de6d_tpu_torch.weights``), fp32 on the CPU.

Decodes are held to 1e-6. An f-fps pick is the argmax over a distance
matrix that cancels (``tests/test_torch_matrix_fps.py``), so the two
packages' picks may part where two candidates' keys lie within the matrix
tolerance of each other; ``chip_smoke.certify_sampling_call`` certifies
every parting, and the layers after it are held by feeding them the
reference's picks (through the SA module's ``new_xyz`` / ``new_valid``
here, through ``chip_smoke.forced_sampling`` for the whole model). SA
features and scores are held to 1e-5, the tiny models' candidates and
detections to 1e-4 (dense sums in another order), counts and labels to
equality.
"""

import copy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    PARITY_TOL, SSD3D_CFG, SSD3D_REF, SSD3D_SEED, certify_sampling_call,
    check_point_parity, load_ssd3d_scans, spec_from_cfg,
)
from de6d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
from de6d_tpu.models import build_network as jax_build
from de6d_tpu.models.backbones_3d import pointnet2_modules as jax_pn2
from de6d_tpu.models.detectors.detector3d_template import (
    DatasetSpec as JaxSpec,
)
from de6d_tpu.utils import box_coder_utils as jax_coders
from de6d_tpu.utils.testing import tiny_det6d_cfg
from de6d_tpu_torch import weights
from de6d_tpu_torch.config import Config, cfg_from_yaml_file
from de6d_tpu_torch.models import build_network
from de6d_tpu_torch.models.backbones_3d import pointnet2_modules as pn2
from de6d_tpu_torch.models.detectors.detector3d_template import DatasetSpec
from de6d_tpu_torch.ops import sampling
from de6d_tpu_torch.utils import box_coder_utils as coders
from test_torch_det6d import scene
from torch_fixtures import (
    flatten_variables, perturb, run_jax_point_detector, unflatten,
)

ROOT = Path(__file__).resolve().parents[1]
TINY_RANGE = (0.0, -16.0, -3.0, 32.0, 16.0, 4.0)
TOL = 1e-4
SA_TOL = 1e-5


# ---------------------------------------------------------------------
# coders
# ---------------------------------------------------------------------

@pytest.mark.parametrize("mean_size,velo", [(None, False), (None, True),
                                            ([[3.9, 1.6, 1.56],
                                              [0.8, 0.6, 1.73]], False)],
                         ids=["exp_sizes", "velocity", "mean_sizes"])
def test_bin_residual_coder_decode_equals_jax(mean_size, velo):
    cfg = dict(use_mean_size=mean_size is not None, mean_size=mean_size,
               angle_bin_num=12, pred_velo=velo)
    rng = np.random.RandomState(3)
    enc = rng.normal(0, 1, (2, 40, 32 if velo else 30)).astype(np.float32)
    enc[0, 0, 6:18] = 1.0  # every bin ties: the first one wins
    pts = rng.uniform(-20, 20, (2, 40, 3)).astype(np.float32)
    cls = rng.randint(1, 3, (2, 40))
    ref = np.asarray(jax_coders.PointBinResidualCoder(**cfg).decode(
        jnp.asarray(enc), jnp.asarray(pts), jnp.asarray(cls)))
    coder = coders.build_box_coder("PointBinResidualCoder", **cfg)
    got = coder.decode(torch.from_numpy(enc), torch.from_numpy(pts),
                       torch.from_numpy(cls)).numpy()
    assert coder.code_size == enc.shape[-1]
    assert got.shape == ref.shape == (2, 40, 9 if velo else 7)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert got[0, 0, 6] == pytest.approx(enc[0, 0, 18] * 2 * np.pi / 12,
                                         abs=1e-6)


# ---------------------------------------------------------------------
# sampling methods and the SA layer
# ---------------------------------------------------------------------

def _sampling_inputs(seed, channels=16):
    pts, valid = scene(seed, 2, 384, TINY_RANGE, n_valid=(384, 300))
    rng = np.random.RandomState(seed + 1)
    feats = np.abs(rng.normal(0, 1, valid.shape + (channels,))).astype(
        np.float32)
    scores = rng.normal(0, 2, valid.shape).astype(np.float32)
    scores[:, 10:14] = scores[:, 9:10]  # exact ties
    return pts[..., :3].copy(), feats, scores, valid


@pytest.mark.parametrize("method,rng_,gamma", [
    ("f-fps", (0, -1), 1.0), ("f-fps", (0, 256), 1.0), ("f-fps", (64, 320),
                                                         0.5),
    ("c-fps", (0, -1), 1.0), ("c-fps", (32, 352), 2.0), ("s-fps", (0, -1),
                                                         1.0),
    ("d-fps", (128, -1), 1.0),
], ids=lambda v: str(v).replace(" ", ""))
def test_run_sampling_equals_jax(method, rng_, gamma):
    xyz, feats, scores, valid = _sampling_inputs(seed=11)
    npoint = 96
    ref = np.asarray(jax_pn2.run_sampling(
        method, jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(scores),
        jnp.asarray(valid), npoint, rng_, gamma))
    t = [torch.from_numpy(a) for a in (xyz, feats, scores, valid)]
    own = pn2.run_sampling(method, *t, npoint, rng_, gamma)
    assert own.dtype == torch.int32 and tuple(own.shape) == ref.shape
    lo, hi = rng_[0], 384 if rng_[1] == -1 else rng_[1]
    assert int(own.min()) >= lo and int(own.max()) < hi
    call = dict(method=method, own=own, ref=torch.from_numpy(ref), xyz=t[0],
                features=t[1], scores=t[2], valid=t[3], npoint=npoint,
                range=rng_, gamma=gamma)
    partings = certify_sampling_call("test", 0, call, scores, tol=1e-6)
    if method != "f-fps":  # same scores, same coordinates: no parting
        assert partings == []
        np.testing.assert_array_equal(own.numpy(), ref)


def test_run_sampling_raises_for_unported_methods():
    xyz, feats, scores, valid = (torch.from_numpy(a) for a in
                                 _sampling_inputs(seed=1))
    for method in ("df-fps", "sectorized-fps", "g-fps"):
        with pytest.raises(NotImplementedError):
            pn2.run_sampling(method, xyz, feats, scores, valid, 8, (0, -1))
    with pytest.raises(ValueError):
        pn2.run_sampling("c-fps", xyz, feats, None, valid, 8, (0, -1))


@pytest.mark.parametrize("fault", ["ffps", "exact", "topk"])
def test_certificate_refuses_picks_that_are_no_near_tie(fault):
    xyz, feats, scores, valid = (torch.from_numpy(a) for a in
                                 _sampling_inputs(seed=5))
    method = {"ffps": "f-fps", "exact": "d-fps", "topk": "c-fps"}[fault]
    own = pn2.run_sampling(method, xyz, feats, scores, valid, 64, (0, -1))
    ref = own.clone()
    ref[1, [20, 40]] = ref[1, [40, 20]]
    call = dict(method=method, own=own, ref=ref, xyz=xyz, features=feats,
                scores=scores, valid=valid, npoint=64, range=(0, -1),
                gamma=1.0)
    with pytest.raises(RuntimeError):
        certify_sampling_call("test", 0, call, scores.numpy(), tol=1e-6)


def _sa_pair(folded, methods, npoints, ranges, seed, num_class=0):
    kw = dict(
        radii=(0.6, 1.2), nsamples=(8, 16), mlps=((16, 16), (16, 32)),
        npoint_list=npoints, sample_range_list=ranges,
        sample_method_list=methods, dilated_radius_group=True,
        aggregation_mlp=(32,), confidence_mlp=(16,),
        confidence_num_class=num_class,
        pc_range=TINY_RANGE if folded else (), bin_cell_cap=16,
        bin_spill_cap=32,
    )
    xyz, feats, scores, valid = _sampling_inputs(seed, channels=8)
    jmod = jax_pn2.PointnetSAModuleFSMSG(**kw)
    args = [jnp.asarray(a) for a in (xyz, feats, valid, scores)]
    flat = perturb(flatten_variables(
        jmod.init(jax.random.PRNGKey(seed), *args)), seed)
    ref = jmod.apply(unflatten(flat), *args)
    tmod = pn2.PointnetSAModuleFSMSG(in_channels=8, **kw)
    weights.load_into(tmod, flat).eval()
    assert tmod._binned_ok(384) == jmod._binned_ok(384) == folded
    t = [torch.from_numpy(a) for a in (xyz, feats, valid, scores)]
    with torch.no_grad():
        got = tmod(*t)
        if not np.array_equal(got[0].numpy(), np.asarray(ref[0])):
            # an f-fps pick parted (certified in test_run_sampling_equals_
            # jax): hold the rest of the layer at the reference's centres
            got = tmod(*t, new_xyz=torch.from_numpy(np.asarray(ref[0])),
                       new_valid=torch.from_numpy(np.asarray(ref[3])))
    return ref, got


@pytest.mark.parametrize("folded", [True, False], ids=["folded", "unfolded"])
@pytest.mark.parametrize("methods,npoints,ranges,num_class", [
    (("f-fps",), (96,), ((0, -1),), 0),
    (("f-fps", "d-fps"), (48, 48), ((0, 256), (0, -1)), 0),
    (("c-fps",), (96,), ((0, -1),), 3),
], ids=["f-fps", "f-fps+d-fps", "c-fps_per_class_scores"])
def test_sa_layer_equals_jax(folded, methods, npoints, ranges, num_class):
    ref, got = _sa_pair(folded, methods, npoints, ranges, seed=21,
                        num_class=num_class)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(ref[3]))
    assert tuple(got[2].shape) == ((2, 96, 3) if num_class else (2, 96))
    for i in (1, 2):  # features, confidence scores
        np.testing.assert_allclose(got[i].numpy(), np.asarray(ref[i]),
                                   rtol=SA_TOL, atol=SA_TOL)
    assert float(np.abs(np.asarray(ref[1])).max()) > 0.1


# ---------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------

def tiny_ssd3d_cfg(sasa):
    """``tiny_det6d_cfg`` turned into 3DSSD (f-fps in SA2, f-fps + d-fps in
    SA3, no confidence MLPs) or 3DSSD-SASA (s-fps in SA2)."""
    cfg = copy.deepcopy(dict(tiny_det6d_cfg()))
    cfg["NAME"] = "SSD3D"
    sa = cfg["BACKBONE_3D"]["SA_CONFIG"]
    sa["NPOINT_LIST"] = [[256], [128], [32, 32]]
    sa["SAMPLE_RANGE_LIST"] = [[[0, -1]], [[0, -1]], [[0, 64], [0, -1]]]
    sa["SAMPLE_METHOD_LIST"] = [["d-fps"], ["s-fps" if sasa else "f-fps"],
                                ["f-fps", "d-fps"]]
    if not sasa:
        del sa["CONFIDENCE_MLPS"]
    head = cfg["POINT_HEAD"]
    head["NAME"] = "PointHeadBoxVote"
    head["TARGET_CONFIG"]["BOX_CODER"] = "PointBinResidualCoder"
    head["TARGET_CONFIG"]["BOX_CODER_CONFIG"] = {
        "use_mean_size": False, "angle_bin_num": 12}
    return cfg


def build_tiny(jcfg, n, seed, n_valid):
    """Both packages' models for one tiny cfg with the port's seeded
    weights, the JAX reference on a ``scene`` of (2, n) points, and
    the inputs as tensors."""
    tcfg = Config(copy.deepcopy(jcfg))
    spec_kw = dict(class_names=("Car",), point_feature_dim=4,
                   point_cloud_range=TINY_RANGE)
    jmodel = jax_build(jcfg, num_class=1, dataset=JaxSpec(**spec_kw))
    tmodel = build_network(tcfg, 1, DatasetSpec(**spec_kw), device="cpu")
    pts, mask = scene(seed, 2, n, (0.0, -16.0, -2.0, 32.0, 16.0, 2.0),
                            n_valid=n_valid)
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0),
        {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)},
    )
    flat = weights.seeded_flax(tmodel, seed)
    init = flatten_variables(init)
    assert {k: v.shape for k, v in flat.items()} == {
        k: v.shape for k, v in init.items()}
    weights.load_into(tmodel, flat)
    ref = run_jax_point_detector(jmodel, unflatten(flat),
                                 jcfg["POST_PROCESSING"], 1, pts, mask)
    return ref, tmodel, tcfg, torch.from_numpy(pts), torch.from_numpy(mask)


@pytest.fixture(scope="module", params=[False, True], ids=["3dssd", "sasa"])
def tiny(request):
    # 2048 points: SA1 takes the folded path, SA2 and SA3 the unfolded one
    return (request.param,) + build_tiny(
        tiny_ssd3d_cfg(request.param), 2048, 6, n_valid=(2048, 1500))


def test_tiny_ssd3d_matches_jax(tiny):
    """chip_smoke's parity check at 1e-4: every sampling call identical or
    parting at a certified near-tie, candidates and detections equal."""
    sasa, ref, tmodel, tcfg, pts, mask = tiny
    assert ref["pred_count"].min() > 0, "test needs detections"
    assert [ref[f"picks_{i}"].shape[1] for i in range(4)] == [256, 128, 32,
                                                              32]
    assert ("scores_1" in ref) == sasa
    out, res = check_point_parity("test", tmodel, pts, mask,
                                  tcfg["POST_PROCESSING"], 1, ref, tol=TOL)
    assert res["sampling_calls"] == ["d-fps", "s-fps" if sasa else "f-fps",
                                     "f-fps", "d-fps"]
    assert res["picks_differing"][0] == res["picks_differing"][3] == 0
    assert res["detections_not_compared"] == []
    assert tuple(out["batch_box_preds"].shape) == (2, 32, 7)
    assert tmodel.backbone_3d.sa_modules[0]._binned_ok(2048)


@pytest.mark.parametrize("fault", ["dfps", "ffps", "vote", "cand", "count"])
def test_parity_check_refuses_faults(tiny, fault):
    """``chip_smoke.check_point_parity`` refuses a changed d-fps pick, an
    f-fps swap that is no near-tie, a moved vote, a moved candidate score
    and a changed count."""
    _, ref, tmodel, tcfg, pts, mask = tiny
    ref = {k: v.copy() for k, v in ref.items()}
    if fault == "dfps":
        ref["picks_0"][1, 10] = ref["picks_0"][1, 11]
    elif fault == "ffps":
        ref["picks_2"][0, [5, 6]] = ref["picks_2"][0, [6, 5]]
    elif fault == "vote":
        ref["vote_coords"][1, 7, 2] += 0.01
    elif fault == "cand":
        ref["cand_scores"][0, 3] += 0.01
    elif fault == "count":
        ref["pred_count"][0] += 1
    with pytest.raises(RuntimeError):
        check_point_parity("test", tmodel, pts, mask,
                           tcfg["POST_PROCESSING"], 1, ref, tol=TOL)


def test_vote_on_a_grouping_sphere_is_named_not_failed(tiny):
    """A reference vote moved by 1e-5 m towards a point on its sphere
    changes that candidate's grouped set: the check names the candidate,
    leaves it out of the comparison and does not compare that sample's
    detections; the other sample is still held."""
    from chip_smoke import vote_group_changes

    _, ref, tmodel, tcfg, pts, mask = tiny
    out, _ = check_point_parity("test", tmodel, pts, mask,
                                tcfg["POST_PROCESSING"], 1, ref, tol=TOL)
    sa = tmodel.point_head.sa_module
    votes = out["point_vote_coords"]
    # find a small shift of one vote of sample 0 that changes its grouped set
    shifts = [(c, axis, step) for c in range(votes.shape[1])
              for axis in range(3) for step in (0.05, -0.05, 0.2, -0.2)]
    for cand, axis, step in shifts:
        moved_ref = votes.clone()
        moved_ref[0, cand, axis] += step
        if bool(vote_group_changes(sa, out["point_coords"],
                                   out["point_valid"], votes, moved_ref,
                                   out["point_vote_valid"])[0, cand]):
            break
    else:
        pytest.fail("test needs a vote near a sphere")
    faulty = {k: v.copy() for k, v in ref.items()}
    faulty["vote_coords"] = moved_ref.numpy()
    faulty["cand_boxes"][0, cand] += 1.0  # not compared: on a sphere
    faulty["pred_count"][0] += 1  # not compared either
    _, res = check_point_parity("test", tmodel, pts, mask,
                                tcfg["POST_PROCESSING"], 1, faulty, tol=0.25)
    assert res["candidates_on_a_sphere"] == [1, 0]
    assert res["detections_not_compared"] == [0]
    faulty["pred_count"][1] += 1
    with pytest.raises(RuntimeError):
        check_point_parity("test", tmodel, pts, mask,
                           tcfg["POST_PROCESSING"], 1, faulty, tol=0.25)


def test_free_run_equals_forced_run_without_a_parting(tiny):
    """Where no pick parts, the forced run of the parity check is the
    model's own forward."""
    _, ref, tmodel, tcfg, pts, mask = tiny
    out, res = check_point_parity("test", tmodel, pts, mask,
                                  tcfg["POST_PROCESSING"], 1, ref, tol=TOL)
    with torch.no_grad():
        free = tmodel({"points": pts, "points_mask": mask})
    same = torch.equal(free["batch_box_preds"], out["batch_box_preds"])
    assert same == (not res["partings"])
    assert torch.equal(free["point_sample_idx_list"][0],
                       out["point_sample_idx_list"][0])  # d-fps


def test_ffps_matrix_is_fp32_in_a_bf16_model():
    """The compute dtype changes the SA features, not the type of the
    f-fps keys: ``run_sampling`` hands fp32 features to the matrix."""
    cfg = Config(copy.deepcopy(tiny_ssd3d_cfg(False)))
    cfg["COMPUTE_DTYPE"] = "bfloat16"
    model = build_network(cfg, 1, DatasetSpec(
        class_names=("Car",), point_feature_dim=4,
        point_cloud_range=TINY_RANGE), device="cpu")
    weights.load_into(model, weights.seeded_flax(model, 1))
    seen = []
    orig = sampling.calc_dist_matrix_for_sampling

    def spy(xyz, features=None, gamma=1.0):
        seen.append((xyz.dtype, features.dtype))
        return orig(xyz, features, gamma)

    pts, mask = scene(2, 1, 512, TINY_RANGE)
    sampling.calc_dist_matrix_for_sampling = spy
    try:
        with torch.no_grad():
            out = model({"points": torch.from_numpy(pts),
                         "points_mask": torch.from_numpy(mask)})
    finally:
        sampling.calc_dist_matrix_for_sampling = orig
    assert seen == [(torch.float32, torch.float32)] * 2
    assert out["point_features"].dtype == torch.float32
    assert torch.isfinite(out["batch_box_preds"]).all()


# ---------------------------------------------------------------------
# full-width reference for the card (which has no JAX)
# ---------------------------------------------------------------------

def full_models(cfg_path=SSD3D_CFG, seed=SSD3D_SEED, with_jax=True):
    """(JAX model or None, port model on the CPU with chip_smoke's seeded
    weights, the flat weights, model cfg, num_class), fp32."""
    cfg = cfg_from_yaml_file(cfg_path)
    mc = copy.deepcopy(cfg.MODEL)
    mc["COMPUTE_DTYPE"] = "float32"
    nc = len(cfg.CLASS_NAMES)
    spec = spec_from_cfg(cfg)
    tmodel = build_network(mc, nc, spec, device="cpu")
    flat = weights.seeded_flax(tmodel, seed)
    weights.load_into(tmodel, flat)
    jmodel = None
    if with_jax:
        jcfg = jax_cfg_from_yaml(str(cfg_path))
        jmc = copy.deepcopy(dict(jcfg.MODEL))
        jmc["COMPUTE_DTYPE"] = "float32"
        jmodel = jax_build(jmc, num_class=nc, dataset=JaxSpec(
            class_names=spec.class_names, point_feature_dim=4,
            point_cloud_range=spec.point_cloud_range))
    return jmodel, tmodel, flat, mc, nc


def jax_reference(cfg_path=SSD3D_CFG, seed=SSD3D_SEED, n_scans=2):
    """The JAX model in fp32 with the seeded weights on the first
    ``n_scans`` scans. Rewrite the stored fixture (a few minutes on the
    CPU) with ``python -c "import sys; sys.path.insert(0, 'tests');
    import test_torch_ssd3d as t; t.write_fixture()"``."""
    jmodel, _, flat, mc, nc = full_models(cfg_path, seed)
    pts, mask = load_ssd3d_scans()
    pts, mask = pts[:n_scans], mask[:n_scans]
    shapes = jax.eval_shape(
        lambda r, b: jmodel.init(r, b, train=False), jax.random.PRNGKey(0),
        {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)})
    init = {"/".join(k): v.shape for k, v in
            __import__("flax").traverse_util.flatten_dict(shapes).items()}
    assert init == {k: v.shape for k, v in flat.items()}, \
        "seeded weights do not fill the JAX model's tree"
    return run_jax_point_detector(jmodel, unflatten(flat),
                                  mc["POST_PROCESSING"], nc, pts, mask)


def write_fixture():
    SSD3D_REF.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(SSD3D_REF, **jax_reference())


@pytest.mark.slow
def test_ssd3d_fixture_equals_fresh_jax_run():
    ref = jax_reference()
    with np.load(SSD3D_REF) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_ssd3d_matches_fixture_on_cpu():
    """The 3DSSD parity phase of chip_smoke.py, here on the CPU."""
    _, tmodel, _, mc, nc = full_models(with_jax=False)
    pts, mask = load_ssd3d_scans()
    with np.load(SSD3D_REF) as stored:
        out, res = check_point_parity(
            "test", tmodel, torch.from_numpy(pts[:2]),
            torch.from_numpy(mask[:2]), mc["POST_PROCESSING"], nc,
            dict(stored), tol=PARITY_TOL)
    print(res)
    assert res["picks_differing"][0] == 0
    assert tuple(out["batch_box_preds"].shape) == (2, 256, 7)


@pytest.mark.slow
def test_full_width_sasa_matches_jax_on_cpu():
    """3DSSD-SASA at full width (d-fps, s-fps, f-fps + d-fps in one
    forward) against a fresh JAX run; no stored fixture, the card's smoke
    run serves 3DSSD."""
    path = ROOT / "configs/kitti_models/3dssd_sasa_car.yaml"
    ref = jax_reference(path)
    _, tmodel, _, mc, nc = full_models(path, with_jax=False)
    pts, mask = load_ssd3d_scans()
    _, res = check_point_parity(
        "test", tmodel, torch.from_numpy(pts[:2]), torch.from_numpy(mask[:2]),
        mc["POST_PROCESSING"], nc, ref, tol=PARITY_TOL)
    print(res)
    assert res["sampling_calls"] == ["d-fps", "s-fps", "f-fps", "d-fps"]
