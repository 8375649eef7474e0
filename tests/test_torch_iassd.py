"""IA-SSD inference: the PyTorch port against the JAX package on the same
inputs and the same weights (flax variables carried across by
``de6d_tpu_torch.weights``), fp32 on the CPU.

Sampling indices are compared exactly where nothing learned enters them
(D-FPS, Rand, ds-FPS, ry-FPS on coordinates; centre-aware top-k on the
same scores); F-FPS / FS picks and the whole models through
``chip_smoke``'s certificates (``tests/test_torch_ssd3d.py`` says why).
The decode is held to 1e-6, the tiny models' candidates and detections
to 1e-4 (dense sums in another order), counts and labels to equality.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (
    IASSD_CFG, IASSD_REF, IASSD_SEED, PARITY_TOL, certify_sampling_call,
    check_point_parity, load_ssd3d_scans,
)
from de6d_tpu.models.backbones_3d import iassd_backbone as jax_iassd
from de6d_tpu.utils import box_coder_utils as jax_coders
from de6d_tpu_torch.models.backbones_3d import iassd_backbone as iassd
from de6d_tpu_torch.utils import box_coder_utils as coders
from test_iassd import _tiny_iassd_cfg
from test_torch_det6d import scene
from test_torch_ssd3d import build_tiny, full_models, jax_reference

TINY_RANGE = (0.0, -16.0, -3.0, 32.0, 16.0, 4.0)
TOL = 1e-4


@pytest.mark.parametrize("mean_size", [None, [[3.9, 1.6, 1.56],
                                              [0.8, 0.6, 1.73]]],
                         ids=["exp_sizes", "mean_sizes"])
def test_bin_ori_coder_decode_equals_jax(mean_size):
    cfg = dict(use_mean_size=mean_size is not None, mean_size=mean_size,
               angle_bin_num=12)  # the yaml's key; the coder reads bin_size
    rng = np.random.RandomState(4)
    enc = rng.normal(0, 1, (2, 40, 30)).astype(np.float32)
    enc[0, 0, 6:18] = 1.0  # every bin ties: the first one wins
    pts = rng.uniform(-20, 20, (2, 40, 3)).astype(np.float32)
    cls = rng.randint(1, 3, (2, 40))
    ref = np.asarray(jax_coders.PointResidual_BinOri_Coder(**cfg).decode(
        jnp.asarray(enc), jnp.asarray(pts), jnp.asarray(cls)))
    coder = coders.build_box_coder("PointResidual_BinOri_Coder", **cfg)
    got = coder.decode(torch.from_numpy(enc), torch.from_numpy(pts),
                       torch.from_numpy(cls)).numpy()
    assert coder.code_size == 30 and got.shape == ref.shape == (2, 40, 7)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert got[0, 0, 6] == pytest.approx(
        -np.pi + np.pi / 12 + enc[0, 0, 18] * np.pi / 12, abs=1e-6)


def _sampling_inputs(seed, num_class=3):
    pts, valid = scene(seed, 2, 384, TINY_RANGE, n_valid=(384, 300))
    rng = np.random.RandomState(seed + 1)
    feats = np.abs(rng.normal(0, 1, valid.shape + (16,))).astype(np.float32)
    logits = rng.normal(0, 2, valid.shape + (num_class,)).astype(np.float32)
    logits[:, 10:14] = logits[:, 9:10]  # exact ties
    return pts[..., :3].copy(), feats, logits, valid


@pytest.mark.parametrize("method,rng_", [
    ("ctr_aware", (0, -1)), ("cls", (32, 352)), ("D-FPS", (0, -1)),
    ("D-FPS", (128, -1)), ("F-FPS", (0, -1)), ("F-FPS", (0, 256)),
    ("FS", (0, -1)), ("Rand", (0, -1)), ("ds-FPS", (0, -1)),
    ("ry-FPS", (0, -1)),
], ids=lambda v: str(v).replace(" ", ""))
def test_run_sampling_iassd_equals_jax(method, rng_):
    xyz, feats, logits, valid = _sampling_inputs(seed=13)
    npoint = 64
    ref = np.asarray(jax_iassd.run_sampling_iassd(
        method, jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(logits),
        jnp.asarray(valid), npoint, rng_))
    t = [torch.from_numpy(a) for a in (xyz, feats, logits, valid)]
    own = iassd.run_sampling_iassd(method, *t, npoint, rng_)
    assert own.dtype == torch.int32 and tuple(own.shape) == ref.shape
    assert own.shape[1] == (2 * npoint if method == "FS" else npoint)
    call = dict(method=method, own=own, ref=torch.from_numpy(ref), xyz=t[0],
                features=t[1], scores=t[2], valid=t[3], npoint=npoint,
                range=rng_, gamma=1.0)
    partings = certify_sampling_call("test", 0, call, logits, tol=1e-6)
    if method not in ("F-FPS", "FS"):
        assert partings == []
        np.testing.assert_array_equal(own.numpy(), ref)


def test_centre_aware_sampling_takes_single_logits_too():
    """(B, N) scores (one class squeezed) rank like (B, N, 1) logits."""
    xyz, feats, logits, valid = (torch.from_numpy(a) for a in
                                 _sampling_inputs(seed=2, num_class=1))
    a = iassd.run_sampling_iassd("ctr_aware", xyz, feats, logits, valid, 32,
                                 (0, -1))
    b = iassd.run_sampling_iassd("ctr_aware", xyz, feats, logits[..., 0],
                                 valid, 32, (0, -1))
    assert torch.equal(a, b)
    with pytest.raises(NotImplementedError):
        iassd.run_sampling_iassd("voxel", xyz, feats, logits, valid, 32,
                                 (0, -1))


def tiny_iassd_cfg(ffps):
    """The JAX package's own tiny IA-SSD config (``tests/test_iassd.py``:
    D-FPS, D-FPS, a sampling-only ctr_aware stage, the vote layer, an SA
    layer at the votes), or the same with F-FPS in layer 2 and FS in
    layer 3."""
    cfg = copy.deepcopy(_tiny_iassd_cfg())
    if ffps:
        sa = cfg["BACKBONE_3D"]["SA_CONFIG"]
        sa["SAMPLE_METHOD_LIST"] = [["D-FPS"], ["F-FPS"], ["FS"], [], []]
        sa["NPOINT_LIST"] = [[128], [64], [16], [-1], [-1]]  # FS: 2 x 16
    return cfg


@pytest.fixture(scope="module", params=[False, True],
                ids=["ctr_aware", "F-FPS_FS"])
def tiny(request):
    return (request.param,) + build_tiny(
        tiny_iassd_cfg(request.param), 1024, 9, n_valid=(1024, 800))


def test_tiny_iassd_matches_jax(tiny):
    ffps, ref, tmodel, tcfg, pts, mask = tiny
    assert ref["pred_count"].min() > 0, "test needs detections"
    out, res = check_point_parity("test", tmodel, pts, mask,
                                  tcfg["POST_PROCESSING"], 1, ref, tol=TOL)
    assert res["sampling_calls"] == (
        ["D-FPS", "F-FPS", "FS"] if ffps else ["D-FPS", "D-FPS", "ctr_aware"])
    assert res["picks_differing"][0] == 0
    assert res["detections_not_compared"] == []
    assert ("scores_2" in ref) != ffps
    assert tuple(out["batch_box_preds"].shape) == (2, 32, 7)
    assert tuple(out["center_box_preds"].shape) == (2, 32, 30)
    assert tuple(out["box_iou3d_preds"].shape) == (2, 32, 1)
    # the layer plumbing: slot 0 is the input, the vote layer keeps its
    # input's features and has no confidences, the last layer sits at the
    # votes
    assert [tuple(x.shape[1:2]) for x in out["encoder_coords"]] == [
        (1024,), (128,), (64,), (32,), (32,), (32,)]
    assert [p is None for p in out["sa_ins_preds"]] == [
        True, False, False, True, True, True]
    assert torch.equal(out["encoder_coords"][5], out["centers"])
    assert torch.equal(out["encoder_coords"][4], out["centers"])
    assert torch.equal(out["centers_origin"], out["encoder_coords"][3])
    lim = torch.tensor([3.0, 3.0, 2.0])
    assert (out["ctr_offsets"].abs() <= lim).all()
    assert out["ctr_offsets"].abs().max() > 0.01


@pytest.mark.parametrize("fault", ["dfps", "topk_or_ffps", "cand", "count"])
def test_parity_check_refuses_faults(tiny, fault):
    _, ref, tmodel, tcfg, pts, mask = tiny
    ref = {k: v.copy() for k, v in ref.items()}
    if fault == "dfps":
        ref["picks_0"][1, 10] = ref["picks_0"][1, 11]
    elif fault == "topk_or_ffps":
        ref["picks_2"][0, [0, 15]] = ref["picks_2"][0, [15, 0]]
    elif fault == "cand":
        ref["cand_boxes"][0, 3, 1] += 0.01
    elif fault == "count":
        ref["pred_count"][0] += 1
    with pytest.raises(RuntimeError):
        check_point_parity("test", tmodel, pts, mask,
                           tcfg["POST_PROCESSING"], 1, ref, tol=TOL)


def test_shipped_config_wiring():
    """``IA-SSD.yaml``: six layers, layer 4 only samples (no parameters),
    the vote layer feeds layer 6's centres, which reads layer 3's points;
    every seeded array lands in the model."""
    _, model, flat, _, _ = full_models(IASSD_CFG, IASSD_SEED, with_jax=False)
    mods = model.backbone_3d.sa_modules
    assert [type(m).__name__ for m in mods] == [
        "PointnetSAModuleFSMSG"] * 3 + ["SampleOnlyLayer", "VoteLayer",
                                        "PointnetSAModuleFSMSG"]
    assert not list(mods[3].parameters())
    assert [m.confidence_num_class for m in (mods[1], mods[2])] == [1, 1]
    assert [m.has_confidence for m in mods[:3]] == [False, True, True]
    assert model.backbone_3d.num_point_features == 512
    assert mods[5].SharedMLP_0.Dense_0.weight.shape[1] == 256 + 3
    assert mods[4].Dense_0.weight.shape == (128, 256)
    assert len(flat) == len(model.state_dict()) == 185
    assert model.point_head.box_coder.code_size == 30


# ---------------------------------------------------------------------
# full-width reference for the card (which has no JAX)
# ---------------------------------------------------------------------

def write_fixture():
    """Rewrite the stored fixture (a few minutes on the CPU) with ``python
    -c "import sys; sys.path.insert(0, 'tests'); import test_torch_iassd
    as t; t.write_fixture()"``."""
    IASSD_REF.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(IASSD_REF, **jax_reference(IASSD_CFG, IASSD_SEED))


@pytest.mark.slow
def test_iassd_fixture_equals_fresh_jax_run():
    ref = jax_reference(IASSD_CFG, IASSD_SEED)
    with np.load(IASSD_REF) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in ref:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_iassd_matches_fixture_on_cpu():
    """The IA-SSD parity phase of chip_smoke.py, here on the CPU."""
    _, tmodel, _, mc, nc = full_models(IASSD_CFG, IASSD_SEED, with_jax=False)
    pts, mask = load_ssd3d_scans()
    with np.load(IASSD_REF) as stored:
        out, res = check_point_parity(
            "test", tmodel, torch.from_numpy(pts[:2]),
            torch.from_numpy(mask[:2]), mc["POST_PROCESSING"], nc,
            dict(stored), tol=PARITY_TOL)
    print(res)
    assert res["sampling_calls"] == ["D-FPS", "D-FPS", "ctr_aware",
                                     "ctr_aware"]
    assert tuple(out["batch_box_preds"].shape) == (2, 256, 7)
