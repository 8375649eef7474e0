"""The port's KITTI AP evaluation (``de6d_tpu_torch.datasets.eval.
kitti_eval`` with ``de6d_tpu_torch.native``) against the JAX package's.

Both are the same numpy (and C++) code, so the result string and every
AP entry must be equal exactly, no tolerance: on the JAX tests' own
synthetic annos (``tests/test_kitti_eval.make_annos``), and on
detections around the val split's ground truth of ``data/kitti`` turned
into KITTI annos by each package's ``generate_prediction_dicts`` (which
must agree bit for bit too). The port's native matcher (built with
``g++`` on first use into ``de6d_tpu_torch/build/``) must equal its
Python fallback.
"""

import copy
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))

KITTI = ROOT / "data/kitti"
CLASSES = ["Car", "Pedestrian", "Cyclist"]


def _both(gt, dt, classes):
    from de6d_tpu.datasets.eval import kitti_eval as jk
    from de6d_tpu_torch.datasets.eval import kitti_eval as tk

    want = jk.get_official_eval_result(copy.deepcopy(gt), copy.deepcopy(dt),
                                       classes)
    got = tk.get_official_eval_result(copy.deepcopy(gt), copy.deepcopy(dt),
                                      classes)
    return got, want


def _assert_same(got, want):
    (gs, gd), (ws, wd) = got, want
    assert gs == ws
    assert sorted(gd) == sorted(wd)
    for k in wd:
        assert float(gd[k]) == float(wd[k]), k


@pytest.mark.parametrize("case", ["perfect", "half_missing", "jitter",
                                  "dontcare_van"])
def test_official_eval_equals_jax_on_jax_test_annos(case):
    from test_kitti_eval import make_annos

    rng = np.random.RandomState(0)
    kw = {"perfect": {}, "half_missing": {"n_frames": 12, "drop_frac": 0.5},
          "jitter": {"jitter": 0.1, "drop_frac": 0.2},
          "dontcare_van": {"n_frames": 6, "drop_frac": 0.3}}[case]
    gt, dt = make_annos(rng, **kw)
    if case == "dontcare_van":
        for g in gt:
            g["name"] = g["name"].copy()
            g["name"][0] = "DontCare"
            g["name"][1] = "Van"
    got, want = _both(gt, dt, ["Car"])
    _assert_same(got, want)
    assert 0 < want[1]["Car_3d/moderate_R40"]


def _val_detections(seed, n_frames):
    """Seeded lidar-frame detections near each val frame's ground truth
    (jittered, some dropped, false positives, three classes)."""
    with open(KITTI / "kitti_infos_val.pkl", "rb") as f:
        infos = pickle.load(f)[:n_frames]
    rng = np.random.RandomState(seed)
    preds = []
    for info in infos:
        a = info["annos"]
        keep = a["name"] != "DontCare"
        gt = a["gt_boxes_lidar"][keep[: len(a["gt_boxes_lidar"])]]
        labels = np.array([CLASSES.index(n) + 1 if n in CLASSES else 1
                           for n in a["name"][keep]])
        sel = rng.uniform(size=len(gt)) > 0.2
        boxes = gt[sel] + rng.normal(0, 0.15, (int(sel.sum()), 7))
        fp = np.zeros((3, 7))
        fp[:, 0] = rng.uniform(5, 60, 3)
        fp[:, 1] = rng.uniform(-20, 20, 3)
        fp[:, 2] = -1.0
        fp[:, 3:6] = [3.9, 1.6, 1.56]
        fp[:, 6] = rng.uniform(-np.pi, np.pi, 3)
        boxes = np.concatenate([boxes, fp]).astype(np.float32)
        preds.append({
            "pred_boxes": boxes,
            "pred_scores": rng.uniform(0.1, 1.0, len(boxes)).astype(
                np.float32),
            "pred_labels": np.concatenate(
                [labels[sel], rng.randint(1, 4, 3)]).astype(np.int32),
        })
    return infos, preds


def test_official_eval_equals_jax_on_val_detections():
    """20 val frames: the two packages' ``generate_prediction_dicts`` give
    the same annos, and the port's eval on them JAX's result."""
    from de6d_tpu.utils.calibration_kitti import Calibration as JaxCalib
    from de6d_tpu.datasets.kitti.kitti_dataset import KittiDataset as JaxKitti
    from de6d_tpu_torch.datasets.kitti.kitti_dataset import KittiDataset
    from de6d_tpu_torch.utils.calibration_kitti import Calibration

    infos, preds = _val_detections(0, 20)
    annos = {}
    for tag, ds_cls, calib_cls in (("jax", JaxKitti, JaxCalib),
                                   ("port", KittiDataset, Calibration)):
        batch = {
            "frame_id": [i["point_cloud"]["lidar_idx"] for i in infos],
            "image_shape": np.stack([i["image"]["image_shape"]
                                     for i in infos]),
            "calib": [calib_cls({"P2": i["calib"]["P2"],
                                 "R0": i["calib"]["R0_rect"],
                                 "Tr_velo2cam": i["calib"]["Tr_velo_to_cam"]})
                      for i in infos],
        }
        annos[tag] = ds_cls.generate_prediction_dicts(
            None, batch, copy.deepcopy(preds), CLASSES)
    for g, w in zip(annos["port"], annos["jax"], strict=True):
        assert sorted(g) == sorted(w)
        for k in w:
            assert np.array_equal(np.asarray(g[k]), np.asarray(w[k])), k
    gt = [copy.deepcopy(i["annos"]) for i in infos]
    got, want = _both(gt, annos["jax"], CLASSES)
    _assert_same(got, want)
    assert want[1]["Car_3d/moderate_R40"] > 0
    assert want[1]["Pedestrian_bev/easy"] > 0


def test_native_matcher_equals_python_fallback(monkeypatch):
    """The port's C++ matcher against its own Python kernel: the fused
    statistics, and the whole eval with the matcher switched off."""
    from test_kitti_eval import make_annos

    from de6d_tpu_torch.datasets.eval import kitti_eval
    from de6d_tpu_torch.native import native_eval

    assert native_eval.available(), "g++ builds the matcher"
    assert native_eval._so_path().parent == ROOT / "de6d_tpu_torch/build"
    rng = np.random.RandomState(1)
    gt, dt = make_annos(rng, n_frames=6, drop_frac=0.3, jitter=0.2)
    for g in gt:
        g["name"] = g["name"].copy()
        g["name"][0] = "DontCare"
        g["name"][1] = "Van"
    for metric in (0, 1, 2):
        overlaps = kitti_eval.calculate_iou_partly(dt, gt, metric)
        gt_l, dt_l, igt, idt, dc, _ = kitti_eval._prepare_data(gt, dt, 0, 1)
        thresholds = np.linspace(0.95, 0.3, 11)
        native = native_eval.fused_statistics(
            overlaps, gt_l, dt_l, igt, idt, dc, metric, 0.5, thresholds,
            True)
        monkeypatch.setattr(native_eval, "available", lambda: False)
        py = kitti_eval._fused_statistics(
            kitti_eval.compute_statistics, overlaps, gt_l, dt_l, igt, idt,
            dc, metric, 0.5, thresholds, True)
        monkeypatch.undo()
        np.testing.assert_array_equal(native, py)
    with_native = kitti_eval.get_official_eval_result(
        copy.deepcopy(gt), copy.deepcopy(dt), ["Car"])
    monkeypatch.setattr(native_eval, "available", lambda: False)
    fallback = kitti_eval.get_official_eval_result(
        copy.deepcopy(gt), copy.deepcopy(dt), ["Car"])
    _assert_same(with_native, fallback)
