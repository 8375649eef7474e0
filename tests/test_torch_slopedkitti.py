"""SlopedKITTI in the port: its loader against the JAX loader on
``data/slopedkitti`` (``det6d_car.yaml``'s ``DATA_CONFIG``: gt sampling,
SlopeAug, flip, rotation, scaling), bit for bit at one JAX worker; the
SlopedKITTI protocol (``datasets/eval/slopedkitti_eval.py``: 4-tier
difficulty, centre-distance AP, ATE / ASE / AOE, ODS) on fixed detections
against the JAX package's result dict; and ``tools.train`` then
``tools.test`` on the CPU with the tiny Det6D over a tree cut from
``data/slopedkitti``.

``det6d_eval_jax_ref.npz`` holds the JAX fp32 eval of the trained
``det6d_car_params.npz`` over the 50 val frames for the card's check
without JAX (``chip_smoke.phase_eval_det6d``); regenerate it with
:func:`write_eval_fixture` (~3 min on the CPU).
"""

import copy
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

CFG = ROOT / "configs/slopedkitti_models/det6d_car.yaml"
DATA = ROOT / "data/slopedkitti"
EVAL_FIXTURE = ROOT / "de6d_tpu_torch/testdata/det6d_eval_jax_ref.npz"


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and ops on
    tensors above PyTorch's grain otherwise wait on OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs():
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg
    from de6d_tpu_torch.config import cfg_from_yaml_file

    cwd = os.getcwd()
    os.chdir(ROOT)  # _BASE_CONFIG_ resolves from the repository root
    try:
        return jax_cfg(str(CFG)), cfg_from_yaml_file(str(CFG))
    finally:
        os.chdir(cwd)


def _loaders(training, batch_size, workers=2):
    from de6d_tpu.datasets import build_dataloader as jax_build
    from de6d_tpu_torch.datasets import build_dataloader

    jcfg, tcfg = _cfgs()
    jset, jl = jax_build(jcfg.DATA_CONFIG, jcfg.CLASS_NAMES, batch_size,
                         root_path=str(DATA), training=training, seed=0,
                         workers=1)
    tset, tl = build_dataloader(tcfg.DATA_CONFIG, tcfg.CLASS_NAMES,
                                batch_size, root_path=str(DATA),
                                training=training, seed=0, workers=workers)
    return (jset, jl), (tset, tl)


def _first(loader, n):
    loader.set_epoch(0)
    out = []
    for b in loader:
        out.append(b)
        if len(out) == n:
            break
    return out


def test_train_batches_equal_jax_loader():
    """The first 6 train batches of epoch 0 at batch 4: every key bit for
    bit, 10-column gt boxes (9-DoF + class) and the slope planes of the
    samples SlopeAug sloped (a key only where every sample has it, as
    the JAX collate keeps it)."""
    from test_torch_kitti_pipeline import assert_batches_equal

    (_, jl), (_, tl) = _loaders(True, 4)
    want = _first(jl, 6)
    got = _first(tl, 6)
    tl.close()
    assert len(got) == len(want) == 6
    for i, (g, w) in enumerate(zip(got, want)):
        assert_batches_equal(g, w, f"train batch {i}")
        assert g["gt_boxes"].shape[-1] == 10
        assert g["points"].shape == (4, 16384, 4)
    pitches = np.concatenate([b["gt_boxes"][..., 7].ravel() for b in got])
    assert (pitches < -np.deg2rad(10)).any()


def test_val_batches_equal_jax_loader():
    from test_torch_kitti_pipeline import assert_batches_equal

    (_, jl), (_, tl) = _loaders(False, 8)
    want = _first(jl, 2)
    got = _first(tl, 2)
    tl.close()
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        assert_batches_equal(g, w, f"val batch {i}")


def fixed_detections(seed, gt_annos):
    """Detections made from the val frames' gt: boxes moved, resized and
    turned (yaw, pitch, roll) by a little, some missed, false positives
    added, scores drawn from a numpy seed."""
    rng = np.random.RandomState(seed)
    dets = []
    for a in gt_annos:
        n = len(a["name"])
        keep = rng.rand(n) > 0.15
        boxes = np.concatenate([a["gt_boxes_lidar"][keep],
                                np.zeros((2, 9), np.float32)])
        m = len(boxes)
        boxes[-2:, 0] = rng.uniform(5, 60, 2)
        boxes[-2:, 1] = rng.uniform(-20, 20, 2)
        boxes[-2:, 3:6] = [3.9, 1.6, 1.5]
        boxes[:, :3] += rng.normal(0, 0.3, (m, 3))
        boxes[:, 3:6] *= rng.uniform(0.9, 1.1, (m, 3))
        boxes[:, 6:9] += rng.normal(0, 0.05, (m, 3))
        dets.append({"pred_boxes": boxes.astype(np.float32),
                     "pred_scores": rng.uniform(0.1, 1, m).astype(np.float32),
                     "pred_labels": np.ones(m, np.int32)})
    return dets


def _annos(dataset, loader, dets):
    out, i = [], 0
    loader.set_epoch(0)
    for batch in loader:
        n = batch["batch_size"]
        out.extend(dataset.generate_prediction_dicts(
            batch, dets[i:i + n], dataset.class_names))
        i += n
    return out


def test_slopedkitti_eval_equals_jax_on_fixed_detections():
    """The port's prediction dicts (17-column boxes with pitch and roll)
    and its SlopedKITTI eval over the 50 val frames give the JAX
    package's result string and dict exactly (AP of every metric and
    tier, ATE / ASE / AOE, ODS)."""
    (jset, jl), (tset, tl) = _loaders(False, 8)
    dets = fixed_detections(0, [i["annos"] for i in tset.kitti_infos])
    want_annos = _annos(jset, jl, dets)
    got_annos = _annos(tset, tl, dets)
    tl.close()
    for g, w in zip(got_annos, want_annos, strict=True):
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]),
                                          err_msg=k)
    want_str, want = jset.evaluation(want_annos, jset.class_names)
    got_str, got = tset.evaluation(got_annos, tset.class_names)
    assert got_str == want_str
    assert sorted(got) == sorted(want)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    assert {"Car_ods/all_R40", "Car_ats/all", "Car_ass/all",
            "Car_aoe_score/all", "Car_cap/all_R40"} <= set(want)
    assert float(want["Car_cap/all_R40"]) > 0


# ---------------------------------------------------------------------
# the CLIs on a cut of data/slopedkitti
# ---------------------------------------------------------------------

def tiny_det6d_yaml(path):
    """``det6d_car.yaml`` with the tiny Det6D model of the JAX package's
    tests (``de6d_tpu.utils.testing.tiny_det6d_cfg``), written to
    ``path``; the data config is the SlopedKITTI one."""
    import yaml

    from de6d_tpu.utils.testing import tiny_det6d_cfg

    model = copy.deepcopy(dict(tiny_det6d_cfg()))

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x

    cfg = {
        "CLASS_NAMES": ["Car"],
        "DATA_CONFIG": {"_BASE_CONFIG_": str(
            ROOT / "configs/dataset_configs/slopedkitti_dataset.yaml")},
        "MODEL": plain(model),
        "OPTIMIZATION": {"BATCH_SIZE_PER_GPU": 2, "NUM_EPOCHS": 1,
                         "OPTIMIZER": "adam_onecycle", "LR": 0.003,
                         "WEIGHT_DECAY": 0.01, "MOMENTUM": 0.9,
                         "MOMS": [0.95, 0.85], "PCT_START": 0.4,
                         "DIV_FACTOR": 10, "DECAY_STEP_LIST": [35, 45],
                         "LR_DECAY": 0.1, "LR_CLIP": 1e-7,
                         "LR_WARMUP": False, "WARMUP_EPOCH": 1,
                         "GRAD_NORM_CLIP": 10},
    }
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    from de6d_tpu_torch.tools import train
    from torch_fixtures import slopedkitti_subtree

    tree = slopedkitti_subtree(tmp_path_factory.mktemp("slopedkitti"), 6,
                               4).resolve()
    work = tmp_path_factory.mktemp("work")
    cfg = tiny_det6d_yaml(work / "det6d_tiny.yaml")
    args = ["--cfg_file", str(cfg), "--device", "cpu", "--workers", "2",
            "--batch_size", "2"]
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(tree)]
    cwd = os.getcwd()
    os.chdir(work)
    try:
        run, ret = train.main(args + ["--epochs", "1", "--fix_random_seed",
                                      "--extra_tag", "a"] + data)
    finally:
        os.chdir(cwd)
    return work, args, data, run, ret


def test_train_cli_trains_det6d(trained):
    """One epoch of the tiny Det6D through ``tools/train.py``: 3 steps of
    batch 2, finite losses, a checkpoint, the post-training SlopedKITTI
    eval (recall counters on the first 7 columns of the 9-DoF boxes)."""
    work, _, _, run, ret = trained
    out = work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG / "a"
    assert (out / "ckpt/checkpoint_epoch_1").is_file()
    assert (out / "eval/eval_with_train/result.pkl").is_file()
    assert run.state.step == 3 and len(run.step_log) == 3
    assert np.isfinite([float(x[2]) for x in run.step_log]).all()
    assert ret["recall_counts"]["gt"] > 0
    assert "Car_ods/all_R40" in ret


def test_test_cli_evaluates_the_det6d_checkpoint(trained):
    from de6d_tpu_torch.tools import test

    work, args, data, run, ret = trained
    ckpt = (work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG
            / "a/ckpt/checkpoint_epoch_1")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        got = test.main(args + ["--ckpt", str(ckpt), "--extra_tag", "a",
                                "--allow-zero-recall", "--save_to_file"]
                        + data)
    finally:
        os.chdir(cwd)
    out = (work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG
           / "a/eval/single")
    assert (out / "result.pkl").is_file()
    txts = sorted((out / "final_result/data").glob("*.txt"))
    assert len(txts) == 4
    for t in txts:  # the name, 17 values: KITTI's, pitch, roll, score
        for line in t.read_text().splitlines():
            assert len(line.split()) == 18
    assert got["recall_counts"] == ret["recall_counts"]


# ---------------------------------------------------------------------
# the full eval's reference for the card (which has no JAX)
# ---------------------------------------------------------------------

EVAL_BATCH = 8


def fp32_cfgs():
    jcfg, tcfg = _cfgs()
    for c in (jcfg, tcfg):
        c.MODEL["COMPUTE_DTYPE"] = "float32"
        c.MODEL["POINT_HEAD"].pop("_COMPUTE_DTYPE", None)
    return jcfg, tcfg


def eval_reference():
    """The JAX package's fp32 eval of the trained Det6D over the 50 val
    frames at batch 8, as arrays: per-frame counts, boxes (9 columns),
    scores, labels; every sampling call's picks and the s-fps logits per
    batch; the recall counters; the SlopedKITTI result dict."""
    import jax
    import jax.numpy as jnp

    from de6d_tpu.models import build_network as jax_build
    from de6d_tpu.models.detectors.detector3d_template import (
        DatasetSpec as JaxSpec, generate_recall_record,
        post_processing as jax_post,
    )
    from de6d_tpu_torch import weights
    from test_torch_det6d import record_jax_picks
    from torch_fixtures import unflatten

    jcfg, _ = fp32_cfgs()
    (jset, jl), _ = _loaders(False, EVAL_BATCH)
    mc = jcfg.MODEL
    jmodel = jax_build(mc, num_class=1, dataset=JaxSpec(
        class_names=("Car",), point_feature_dim=4,
        point_cloud_range=tuple(jcfg.DATA_CONFIG.POINT_CLOUD_RANGE)))
    variables = unflatten(weights.load_flax_npz(
        ROOT / "bench_assets/det6d_car_params.npz"))
    post_cfg = mc["POST_PROCESSING"]
    with record_jax_picks() as rec:
        @jax.jit
        def step(v, p, m, g):
            rec.clear()
            out = jmodel.apply(v, {"points": p, "points_mask": m},
                               train=False)
            post = jax_post(out, post_cfg, 1)
            recall = generate_recall_record(
                {"gt_boxes": g}, post["pred_boxes"], post["pred_count"],
                thresh_list=tuple(post_cfg["RECALL_THRESH_LIST"]))
            scores = [s for s in out["point_scores_list"] if s is not None]
            return post, recall, list(rec), scores

        out = {"boxes": [], "scores": [], "labels": [], "count": [],
               "frame_id": []}
        recall, annos = {}, []
        jl.set_epoch(0)
        for bi, batch in enumerate(jl):
            post, rc, picks, scores = step(
                variables, *(jnp.asarray(batch[k]) for k in (
                    "points", "points_mask", "gt_boxes")))
            post = {k: np.asarray(v) for k, v in post.items()}
            for k, v in rc.items():
                recall[k] = recall.get(k, 0) + int(v)
            for i, p in enumerate(picks):
                out[f"b{bi}_picks_{i}"] = np.asarray(p)
            for i, s in enumerate(scores):
                out[f"b{bi}_scores_{i}"] = np.asarray(s)
            preds = []
            for i in range(batch["batch_size"]):
                c = int(post["pred_count"][i])
                preds.append({"pred_boxes": post["pred_boxes"][i, :c],
                              "pred_scores": post["pred_scores"][i, :c],
                              "pred_labels": post["pred_labels"][i, :c]})
                out["boxes"].append(post["pred_boxes"][i, :c])
                out["scores"].append(post["pred_scores"][i, :c])
                out["labels"].append(post["pred_labels"][i, :c])
                out["count"].append(c)
            out["frame_id"] += list(batch["frame_id"])
            annos += jset.generate_prediction_dicts(batch, preds,
                                                    jset.class_names)
    _, ap = jset.evaluation(annos, jset.class_names)
    res = {k: np.concatenate(out[k]) for k in ("boxes", "scores", "labels")}
    res["count"] = np.asarray(out["count"], np.int64)
    res["frame_id"] = np.asarray(out["frame_id"])
    res.update({k: v for k, v in out.items()
                if "_picks_" in k or "_scores_" in k})
    res["recall_keys"] = np.asarray(sorted(recall))
    res["recall_counts"] = np.asarray([recall[k] for k in sorted(recall)])
    res["ap_keys"] = np.asarray(sorted(ap))
    res["ap_values"] = np.asarray([float(ap[k]) for k in sorted(ap)])
    return res


def write_eval_fixture():
    """Rewrite ``testdata/det6d_eval_jax_ref.npz`` with ``python -c
    "import sys; sys.path.insert(0, 'tests'); import
    test_torch_slopedkitti as t; t.write_eval_fixture()"``."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(EVAL_FIXTURE, **eval_reference())


def test_eval_fixture_holds_what_the_card_reads():
    with np.load(EVAL_FIXTURE) as ref:
        assert int(ref["count"].sum()) == len(ref["scores"]) > 0
        assert len(ref["frame_id"]) == 50
        assert ref["boxes"].shape[1] == 9
        assert sum(k.endswith("_picks_0") for k in ref.files) == 7


@pytest.mark.slow
def test_eval_fixture_equals_fresh_jax_run():
    ref = eval_reference()
    with np.load(EVAL_FIXTURE) as stored:
        assert sorted(stored.files) == sorted(ref)
        for k in stored.files:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_eval_matches_fixture_on_cpu():
    """The fp32 eval phase of chip_smoke.py
    (``check_det6d_eval_parity``), here on the CPU."""
    from chip_smoke import det6d_eval_parity

    report = det6d_eval_parity("cpu")
    assert report["counts"] > 0
