"""The port's eval path against the JAX package's: ``ops.iou3d.boxes_iou3d``,
``generate_recall_record``, and ``train.eval_utils.eval_one_epoch`` of the
tiny PointPillars on a KITTI tree cut from ``data/kitti``.

Tolerances: the 3D IoU is held to 2e-6 absolute against the jitted JAX
function on random boxes (fp32; the BEV overlap's passes are written in
the JAX order, the z-overlap and volumes round alike; both lie up to
3.4e-5 from a float64 evaluation). On degenerate boxes (shared edges,
identical boxes turned by pi, millimetre boxes) jitted JAX is
ill-conditioned: it gives 0.8927 for two identical boxes whose yaws
differ by pi, and its eager result differs from its jitted one; there
the port must agree with it within 2e-6 or lie closer than it to the
float64 hull IoU of ``rotate_iou_np`` (and within 2e-3 of it). The recall counters exactly (no box
of these tests lies within 2e-6 of a threshold); the tiny model's
detections as ``test_torch_pointpillar`` holds them (counts and labels
equal, boxes and scores within 1e-4), its recall counters exactly and its
AP dict within 1e-9 (AP is a step function of the matches: equal matches
give equal AP up to the order of float sums).

``pointpillar_eval_jax_ref.npz`` is the JAX ``eval_one_epoch`` in fp32
with ``bench_assets/pointpillar_params.npz`` over the 100 val frames of
``data/kitti`` at batch 8: each frame's boxes, scores and labels, the
recall counters and the AP dict. The card holds the
port to it (``chip_smoke.check_eval_parity``); regenerate it with
:func:`write_fixture` (~2 min on the CPU).
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

TINY = ROOT / "configs/kitti_models/pointpillar_tiny.yaml"
FULL = ROOT / "configs/kitti_models/pointpillar.yaml"
PARAMS = ROOT / "bench_assets/pointpillar_params.npz"
FIXTURE = ROOT / "de6d_tpu_torch/testdata/pointpillar_eval_jax_ref.npz"
IOU_ATOL = 2e-6
TINY_SEED = 11


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and ops on
    tensors above PyTorch's grain otherwise wait on OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_boxes(rng, n):
    b = np.zeros((n, 7), np.float32)
    b[:, 0:2] = rng.uniform(-6, 6, (n, 2))
    b[:, 2] = rng.uniform(-1.5, 0.5, n)
    b[:, 3:6] = rng.uniform(0.4, 4.5, (n, 3))
    b[:, 6] = rng.uniform(-np.pi, np.pi, n)
    return b


def _degenerate_boxes(rng):
    """Identical, touching, nested, zero-height, tiny and huge boxes,
    axis-aligned and rotated by pi/2 and pi."""
    base = np.array([1.0, 2.0, -1.0, 4.0, 1.8, 1.5, 0.3], np.float32)
    rows = [base, base.copy(), base.copy(), base.copy(), base.copy(),
            base.copy(), base.copy(), base.copy()]
    rows[1][0] += 4.0  # touching along x
    rows[2][3:6] *= 0.5  # nested
    rows[3][5] = 0.0  # zero height
    rows[4][3:6] = 1e-3  # tiny
    rows[5][3:6] = 80.0  # huge
    rows[6][6] += np.pi  # same box, yaw + pi
    rows[7][6] = 0.0
    return np.stack(rows)


@pytest.mark.parametrize("case", ["random", "degenerate"])
def test_boxes_iou3d_equals_jax(case):
    import jax
    import jax.numpy as jnp
    from de6d_tpu.ops import iou3d as jiou
    from de6d_tpu_torch.datasets.eval.rotate_iou_np import boxes_iou3d_cpu
    from de6d_tpu_torch.ops import iou3d

    rng = np.random.RandomState(7)
    if case == "random":
        a, b = _random_boxes(rng, 60), _random_boxes(rng, 50)
        b[:20] = a[:20] + rng.normal(0, 0.2, (20, 7)).astype(np.float32)
    else:
        a = _degenerate_boxes(rng)
        b = np.concatenate([a, _random_boxes(rng, 4)])
    want = np.asarray(jax.jit(jiou.boxes_iou3d)(jnp.asarray(a),
                                                jnp.asarray(b)))
    got = iou3d.boxes_iou3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    if case == "random":
        np.testing.assert_allclose(got, want, rtol=0, atol=IOU_ATOL)
    else:
        # where the two fp32 results part, the port lies closer to a
        # float64 evaluation (the eval's hull IoU) than jitted JAX does
        f64 = boxes_iou3d_cpu(a.astype(np.float64), b.astype(np.float64))
        ok = ((np.abs(got - want) <= IOU_ATOL)
              | (np.abs(got - f64) < np.abs(want - f64)))
        assert ok.all(), np.argwhere(~ok)
        assert np.abs(got - f64).max() < 2e-3
    assert (want > 0.3).any() and (want == 0).any()
    # the batched form equals the per-sample one
    batched = iou3d.boxes_iou3d(torch.from_numpy(np.stack([a, a])),
                                torch.from_numpy(np.stack([b, b]))).numpy()
    np.testing.assert_array_equal(batched[1], got)


def test_generate_recall_record_equals_jax():
    """Counters over a batch of 3 with padding rows, partial counts and a
    sample without predictions."""
    import jax
    import jax.numpy as jnp
    from de6d_tpu.models.detectors.detector3d_template import (
        generate_recall_record as jax_record,
    )
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        generate_recall_record,
    )

    rng = np.random.RandomState(3)
    gt = np.zeros((3, 10, 8), np.float32)
    boxes = np.zeros((3, 16, 7), np.float32)
    for i, (n_gt, n_box) in enumerate(((10, 16), (6, 9), (4, 0))):
        g = _random_boxes(rng, n_gt)
        gt[i, :n_gt, :7] = g
        gt[i, :n_gt, 7] = 1
        p = _random_boxes(rng, 16)
        m = min(n_gt, 16)
        p[:m] = np.tile(g, (2, 1))[:m] + rng.normal(
            0, 0.15 * (i + 1), (m, 7)).astype(np.float32)
        boxes[i] = p
    counts = np.array([16, 9, 0], np.int32)
    want = jax.jit(lambda g, b, c: jax_record({"gt_boxes": g}, b, c))(
        jnp.asarray(gt), jnp.asarray(boxes), jnp.asarray(counts))
    got = generate_recall_record({"gt_boxes": torch.from_numpy(gt)},
                                 torch.from_numpy(boxes),
                                 torch.from_numpy(counts))
    want = {k: int(v) for k, v in want.items()}
    assert {k: int(v) for k, v in got.items()} == want
    assert want["gt"] == 20 and 0 < want["recalled_0.7"] < want[
        "recalled_0.3"]


# ---------------------------------------------------------------------
# eval_one_epoch
# ---------------------------------------------------------------------

def _cfg(package, path, data_path=None):
    if package == "jax":
        from de6d_tpu.config import cfg_from_yaml_file
    else:
        from de6d_tpu_torch.config import cfg_from_yaml_file
    cwd = os.getcwd()
    os.chdir(ROOT)  # _BASE_CONFIG_ resolves from the repository root
    try:
        cfg = cfg_from_yaml_file(str(path))
    finally:
        os.chdir(cwd)
    if data_path is not None:
        cfg.DATA_CONFIG.DATA_PATH = str(data_path)
    cfg.MODEL.COMPUTE_DTYPE = "float32"
    return cfg


def jax_eval(cfg_path, data_path, flat, batch_size):
    """The JAX package's ``eval_one_epoch`` (fp32, one worker) → (ret,
    det_annos, recall counts)."""
    from de6d_tpu.datasets import build_dataloader
    from de6d_tpu.models import build_network
    from de6d_tpu.train.eval_utils import eval_one_epoch
    from torch_fixtures import unflatten

    cfg = _cfg("jax", cfg_path, data_path)
    ds, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                  batch_size, root_path=str(data_path),
                                  training=False, workers=1)
    model = build_network(copy.deepcopy(dict(cfg.MODEL)),
                          num_class=len(cfg.CLASS_NAMES), dataset=ds.spec)
    v = unflatten(flat)
    ret, annos = eval_one_epoch(model, v["params"], v.get("batch_stats"),
                                loader, ds, cfg.MODEL, cfg.CLASS_NAMES)
    gt = sum(int(np.any(np.abs(b["gt_boxes"][..., :7]) > 0, -1).sum())
             for b in loader)
    counts = {"gt": gt}
    for k, v in ret.items():
        if k.startswith("recall/"):
            counts[k[len("recall/"):]] = int(round(v * gt))
    return ret, annos, counts


def port_eval(cfg_path, data_path, flat, batch_size, device="cpu",
              workers=1):
    """The port's ``eval_one_epoch`` with the same weights → (ret,
    det_annos)."""
    from de6d_tpu_torch import weights
    from de6d_tpu_torch.datasets import build_dataloader
    from de6d_tpu_torch.models import build_network
    from de6d_tpu_torch.train.eval_utils import eval_one_epoch

    cfg = _cfg("torch", cfg_path, data_path)
    ds, loader = build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES,
                                  batch_size, root_path=str(data_path),
                                  training=False, workers=workers)
    model = build_network(cfg.MODEL, len(cfg.CLASS_NAMES), ds.spec,
                          device="cpu")
    weights.load_into(model, flat)
    model.to(device)
    try:
        return eval_one_epoch(model, loader, ds, cfg.MODEL, cfg.CLASS_NAMES)
    finally:
        loader.close()


def annos_to_arrays(annos, class_names):
    """Per-frame detections of ``det_annos`` → flat arrays."""
    names = list(class_names)
    return {
        "frame_id": np.array([a["frame_id"] for a in annos]),
        "count": np.array([len(a["score"]) for a in annos], np.int64),
        "boxes": np.concatenate([np.asarray(a["boxes_lidar"], np.float32)
                                 .reshape(-1, 7) for a in annos]),
        "scores": np.concatenate([np.asarray(a["score"], np.float32)
                                  for a in annos]),
        "labels": np.concatenate([np.array([names.index(n) + 1
                                            for n in a["name"]], np.int64)
                                  for a in annos]),
    }


def ap_items(ret):
    """The AP entries of an eval's ret_dict, sorted by key."""
    keys = sorted(k for k in ret if k.startswith(("Car", "Pedestrian",
                                                  "Cyclist")))
    return keys, np.array([float(ret[k]) for k in keys])


@pytest.fixture(scope="module")
def tiny_tree(tmp_path_factory):
    from torch_fixtures import kitti_subtree

    return kitti_subtree(tmp_path_factory.mktemp("kitti"), 8, 4)


def test_tiny_eval_one_epoch_equals_jax(tiny_tree):
    """The tiny model (seeded weights) over 4 val frames at batch 2 in
    both packages: per-frame detections, recall counters, AP."""
    from de6d_tpu_torch import weights
    from de6d_tpu_torch.models import build_network
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        DatasetSpec,
    )
    from torch_fixtures import spec_kwargs

    cfg = _cfg("torch", TINY, tiny_tree)
    tmodel = build_network(cfg.MODEL, 1, DatasetSpec(**spec_kwargs(cfg)),
                           device="cpu")
    flat = weights.seeded_flax(tmodel, TINY_SEED)
    jret, jannos, jcounts = jax_eval(TINY, tiny_tree, flat, 2)
    tret, tannos = port_eval(TINY, tiny_tree, flat, 2)
    want = annos_to_arrays(jannos, cfg.CLASS_NAMES)
    got = annos_to_arrays(tannos, cfg.CLASS_NAMES)
    assert want["count"].sum() > 0, "test needs detections"
    np.testing.assert_array_equal(got["frame_id"], want["frame_id"])
    np.testing.assert_array_equal(got["count"], want["count"])
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-4,
                               atol=1e-4)
    assert tret["recall_counts"] == jcounts
    for k in jret:
        if k.startswith("recall/"):
            assert tret[k] == jret[k], k
    jk, jv = ap_items(jret)
    tk, tv = ap_items(tret)
    assert tk == jk and len(jk) == 24
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------
# the full-width fixture for the card
# ---------------------------------------------------------------------

def eval_reference(ret, annos, counts, class_names):
    out = annos_to_arrays(annos, class_names)
    keys, vals = ap_items(ret)
    out["ap_keys"] = np.array(keys)
    out["ap_values"] = vals
    out["recall_keys"] = np.array(sorted(counts))
    out["recall_counts"] = np.array([counts[k] for k in sorted(counts)],
                                    np.int64)
    return out


def write_fixture(path=FIXTURE):
    """JAX ``eval_one_epoch`` in fp32, trained weights, the 100 val frames
    of ``data/kitti`` at batch 8."""
    from de6d_tpu_torch import weights

    cfg = _cfg("torch", FULL)
    flat = weights.load_flax_npz(PARAMS)
    ret, annos, counts = jax_eval(FULL, ROOT / "data/kitti", flat, 8)
    np.savez_compressed(path, **eval_reference(ret, annos, counts,
                                               cfg.CLASS_NAMES))


def test_fixture_eval_code_reproduces_jax_ap():
    """The port's KITTI eval on the stored JAX detections (annos rebuilt
    by the port's ``generate_prediction_dicts``) gives the stored AP dict
    exactly: ``chip_smoke.check_eval_code``."""
    import chip_smoke

    res = chip_smoke.check_eval_code()
    assert res["ap_equal"]


@pytest.mark.slow
def test_full_width_eval_matches_fixture_on_cpu():
    """``chip_smoke``'s fp32 eval parity, here on the CPU."""
    import chip_smoke
    from de6d_tpu_torch import weights

    flat = weights.load_flax_npz(PARAMS)
    ret, annos = port_eval(FULL, ROOT / "data/kitti", flat, 8)
    chip_smoke.check_eval_parity(ret, annos)


def test_eval_parity_gate_certifies_and_refuses():
    """``chip_smoke``'s eval gate on the stored detections: a score-order
    flip of two detections is certified by ``certify_ap`` (the hybrid's
    AP equals the reference); a dropped detection fails the gate."""
    import chip_smoke

    with np.load(FIXTURE) as raw:
        ref = dict(raw)
    s = ref["scores"]
    gap = np.abs(s[:, None] - s[None]) + np.eye(len(s))
    i, j = (int(x) for x in np.unravel_index(np.argmin(gap), gap.shape))
    got = {k: v.copy() for k, v in ref.items()}
    got["scores"][i], got["scores"][j] = s[j], s[i]
    replaced = chip_smoke.certify_ap(got, ref, ["Car_3d/easy"])
    assert i in replaced and j in replaced
    ds, annos = chip_smoke.eval_annos_from_arrays(ref)
    _, ap = ds.evaluation(annos, ds.class_names)
    counts = dict(zip(ref["recall_keys"].tolist(),
                      ref["recall_counts"].tolist()))
    ret = {**ap, "recall_counts": counts}
    assert chip_smoke.check_eval_parity(ret, annos)["ap_differs_at"] == []
    annos[int(np.argmax(ref["count"]))]["score"] = annos[
        int(np.argmax(ref["count"]))]["score"][:-1]
    with pytest.raises(SystemExit):
        chip_smoke.check_eval_parity(ret, annos)


def test_eval_parity_gate_certifies_recall_partings(tmp_path, monkeypatch,
                                                    capsys):
    """A recall counter that parts at a gt box whose best IoU lies within
    ``PARTING_IOU`` of 0.7 in both runs is certified; one whose
    reference IoU lies farther from it fails the gate. The detections
    are the stored ones plus one box around a pedestrian of the first val
    frame, grown in x and y so that its 3D IoU with it is 0.7 +- delta
    (nested in the BEV: no shared edge, on which the IoU is
    ill-conditioned)."""
    import chip_smoke

    with np.load(FIXTURE) as raw:
        ref = dict(raw)
    gt = chip_smoke.eval_gt_boxes()[0]
    ped = gt[np.argmin(gt[:, 3])]  # the shortest box of the frame

    def with_box(arrays, iou):
        out = {k: v.copy() for k, v in arrays.items()}
        box = ped.copy()
        box[3:5] = ped[3:5] * np.float32(iou ** -0.5)  # IoU = V_gt / V_box
        out["boxes"] = np.concatenate([box[None], out["boxes"]])
        out["scores"] = np.concatenate([[np.float32(0.9)], out["scores"]])
        out["labels"] = np.concatenate([[2], out["labels"]])
        out["count"] = out["count"].copy()
        out["count"][0] += 1
        return out

    def run(delta_ref, delta_got):
        r = with_box(ref, 0.7 + delta_ref)
        g = with_box(ref, 0.7 - delta_got)
        ds, r_annos = chip_smoke.eval_annos_from_arrays(r)
        _, r_ap = ds.evaluation(r_annos, ds.class_names)
        r["ap_values"] = np.array([float(r_ap[k]) for k in r["ap_keys"]])
        counts = dict(zip(r["recall_keys"].tolist(),
                          r["recall_counts"].tolist()))
        counts["recalled_0.7"] += 1
        r["recall_counts"] = np.array([counts[k] for k in r["recall_keys"]])
        path = tmp_path / f"ref_{delta_ref}.npz"
        np.savez(path, **r)
        monkeypatch.setattr(chip_smoke, "EVAL_REF", path)
        _, g_annos = chip_smoke.eval_annos_from_arrays(g)
        _, g_ap = ds.evaluation(g_annos, ds.class_names)
        g_counts = dict(counts)
        g_counts["recalled_0.7"] -= 1
        return chip_smoke.check_eval_parity(
            {**g_ap, "recall_counts": g_counts}, g_annos)

    res = run(2e-4, 2e-4)
    assert [p[0] for p in res["recall_partings"]] == ["recalled_0.7"]
    with pytest.raises(SystemExit):
        run(1.1e-3, 1e-4)
    assert "recalled_0.7 parts at frame 0" in capsys.readouterr().err
