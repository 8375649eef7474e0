"""``tools/train.py`` then ``tools/test.py`` on the CPU for tiny variants
of the detectors this slice trains, each on a cut of its tree (4 train
and 2 val frames): PointRCNN (``pointrcnn.yaml``'s data config) on
``data/kitti``; PointRCNN with SlopeAug (``pointrcnn_slopeaug.yaml``:
``random_make_slope_in_scene`` gives 10-column gt boxes) on
``data/kitti``, its checkpoint evaluated by ``tools/test.py`` with
``configs/slopedkitti_models/pointrcnn.yaml`` on ``data/slopedkitti``
under the SlopedKITTI protocol; 3DSSD (``3dssd_car.yaml``) on
``data/kitti``. One epoch of batch 2, finite losses, a checkpoint, the
post-training eval, and an eval result from ``tools/test.py``."""

import copy
import os
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and ops on
    tensors above PyTorch's grain otherwise wait on OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def plain(x):
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def tiny_model(name):
    if name == "3dssd":
        from test_torch_ssd3d_train import tiny_cfg

        return copy.deepcopy(tiny_cfg(overlap=True))
    from test_torch_pointrcnn_train import tiny_cfg

    return copy.deepcopy(tiny_cfg())


CASES = {
    "pointrcnn": "configs/kitti_models/pointrcnn.yaml",
    "pointrcnn_slopeaug": "configs/kitti_models/pointrcnn_slopeaug.yaml",
    "3dssd": "configs/kitti_models/3dssd_car.yaml",
}


def tiny_yaml(src_path, model_name, path):
    """The shipped yaml with the tiny model of this slice's tests (its
    classes) and a short one-cycle schedule, written to ``path``."""
    src = yaml.safe_load((ROOT / src_path).read_text())
    data = src["DATA_CONFIG"]
    data["_BASE_CONFIG_"] = str(ROOT / data["_BASE_CONFIG_"])
    cfg = {
        "CLASS_NAMES": src["CLASS_NAMES"], "DATA_CONFIG": data,
        "MODEL": plain(tiny_model(model_name)),
        "OPTIMIZATION": {**src["OPTIMIZATION"], "BATCH_SIZE_PER_GPU": 2,
                         "NUM_EPOCHS": 1, "LR": 0.003},
    }
    path.write_text(yaml.safe_dump(cfg))
    return path


def run_in(work, fn, *args):
    cwd = os.getcwd()
    os.chdir(work)
    try:
        return fn(*args)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request, tmp_path_factory):
    from de6d_tpu_torch.tools import train
    from torch_fixtures import kitti_subtree

    name = request.param
    tree = kitti_subtree(tmp_path_factory.mktemp(name), 4, 2).resolve()
    work = tmp_path_factory.mktemp("work")
    cfg = tiny_yaml(CASES[name], name, work / f"{name}_tiny.yaml")
    args = ["--cfg_file", str(cfg), "--device", "cpu", "--workers", "2",
            "--batch_size", "2"]
    data = ["--set", "DATA_CONFIG.DATA_PATH", str(tree)]
    gts = []

    def go():
        run = train.prepare(args + ["--epochs", "1", "--fix_random_seed",
                                    "--extra_tag", "a"] + data)
        get_loss = run.model.get_training_loss

        def recorded_loss(batch_dict):
            gts.append(batch_dict["gt_boxes"].detach().clone())
            return get_loss(batch_dict)

        run.model.get_training_loss = recorded_loss
        train.train(run)
        del run.model.get_training_loss
        return run, train.evaluate(run)[0]

    run, ret = run_in(work, go)
    return name, work, args, data, run, ret, gts


def test_train_cli_trains_and_evaluates(trained):
    """2 steps of batch 2, finite losses, a checkpoint, the post-training
    eval's recall; with SlopeAug every batch's gt boxes have 10 columns
    (the 7-DoF model reads the 9-DoF boxes), and the augmentor sloped the
    scenes."""
    name, work, _, _, run, ret, gts = trained
    out = work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG / "a"
    assert (out / "ckpt/checkpoint_epoch_1").is_file()
    assert (out / "eval/eval_with_train/result.pkl").is_file()
    assert run.state.step == 2 and len(run.step_log) == 2
    assert np.isfinite([float(x[2]) for x in run.step_log]).all()
    assert ret["recall_counts"]["gt"] > 0
    cols = {g.shape[-1] for g in gts}
    assert cols == ({10} if name == "pointrcnn_slopeaug" else {8})
    if name == "pointrcnn_slopeaug":
        assert any(bool((g[..., 7:9] != 0).any()) for g in gts)


def test_test_cli_evaluates_the_checkpoint(trained):
    """``tools/test.py --ckpt`` writes its result: the same recall as the
    post-training eval; the SlopeAug checkpoint under the SlopedKITTI
    protocol (centre-distance AP, ODS) on a cut of ``data/slopedkitti``."""
    from de6d_tpu_torch.tools import test
    from torch_fixtures import slopedkitti_subtree

    name, work, args, data, run, ret, _ = trained
    ckpt = (work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG
            / "a/ckpt/checkpoint_epoch_1")
    extra = ["--ckpt", str(ckpt), "--extra_tag", "a", "--allow-zero-recall"]
    if name != "pointrcnn_slopeaug":
        got = run_in(work, test.main, args + extra + data)
        out = (work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG
               / "a/eval/single")
        assert (out / "result.pkl").is_file()
        assert got["recall_counts"] == ret["recall_counts"]
        return
    sloped = slopedkitti_subtree(work / "sloped", 2, 2).resolve()
    cfg = tiny_yaml("configs/slopedkitti_models/pointrcnn.yaml",
                    "pointrcnn", work / "pointrcnn_sloped_tiny.yaml")
    args = ["--cfg_file", str(cfg)] + args[2:]
    got = run_in(work, test.main, args + extra + [
        "--set", "DATA_CONFIG.DATA_PATH", str(sloped)])
    assert got["recall_counts"]["gt"] > 0
    assert "Car_ods/all_R40" in got
    assert any(k.startswith("Car_") and "ap" in k.lower() for k in got)
