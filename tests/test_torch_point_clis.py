"""``tools/train.py`` then ``tools/test.py`` on the CPU for tiny variants
of the point detectors this slice trains: Det6D's direct-regression
ablation (``det6d_dr_car.yaml``'s head) and the non-ground-aware pitch
variant (``det6d_pitch_car.yaml``'s coder), each on a cut of
``data/slopedkitti``, and IA-SSD (``IA-SSD.yaml``'s data config) on a cut
of ``data/kitti`` (4 train and 2 val frames each): one epoch of batch 2,
finite losses, a checkpoint, the post-training eval, and the checkpoint
evaluated again by ``tools/test.py`` with the same recall."""

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
    from de6d_tpu.utils.testing import tiny_det6d_cfg

    if name == "ia_ssd":
        from test_iassd import _tiny_iassd_cfg

        return copy.deepcopy(_tiny_iassd_cfg())
    model = copy.deepcopy(dict(tiny_det6d_cfg()))
    if name == "det6d_dr":
        from test_torch_det6d_dr import dr_head_cfg

        model["POINT_HEAD"] = dr_head_cfg(32)
    else:  # det6d_pitch
        model["POINT_HEAD"]["TARGET_CONFIG"]["BOX_CODER_CONFIG"][
            "ground_aware"] = False
    return model


CASES = {
    "det6d_dr": ("configs/slopedkitti_models/det6d_dr_car.yaml",
                 "slopedkitti"),
    "det6d_pitch": ("configs/slopedkitti_models/det6d_pitch_car.yaml",
                    "slopedkitti"),
    "ia_ssd": ("configs/kitti_models/IA-SSD.yaml", "kitti"),
}


def tiny_yaml(name, path):
    """The shipped yaml of ``name`` with the tiny model of the JAX
    package's tests and a short one-cycle schedule, written to ``path``."""
    src = yaml.safe_load((ROOT / CASES[name][0]).read_text())
    data = src["DATA_CONFIG"]
    data["_BASE_CONFIG_"] = str(ROOT / data["_BASE_CONFIG_"])
    cfg = {
        "CLASS_NAMES": src["CLASS_NAMES"], "DATA_CONFIG": data,
        "MODEL": plain(tiny_model(name)),
        "OPTIMIZATION": {**src["OPTIMIZATION"], "BATCH_SIZE_PER_GPU": 2,
                         "NUM_EPOCHS": 1, "LR": 0.003},
    }
    path.write_text(yaml.safe_dump(cfg))
    return path


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request, tmp_path_factory):
    from de6d_tpu_torch.tools import train
    from torch_fixtures import kitti_subtree, slopedkitti_subtree

    name = request.param
    cut = slopedkitti_subtree if CASES[name][1] == "slopedkitti" else \
        kitti_subtree
    tree = cut(tmp_path_factory.mktemp(name), 4, 2).resolve()
    work = tmp_path_factory.mktemp("work")
    cfg = tiny_yaml(name, work / f"{name}_tiny.yaml")
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
    return name, work, args, data, run, ret


def test_train_cli_trains_and_evaluates(trained):
    """2 steps of batch 2, finite losses, a checkpoint, the post-training
    eval's result (SlopedKITTI's ODS for the Det6D variants)."""
    name, work, _, _, run, ret = trained
    out = work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG / "a"
    assert (out / "ckpt/checkpoint_epoch_1").is_file()
    assert (out / "eval/eval_with_train/result.pkl").is_file()
    assert run.state.step == 2 and len(run.step_log) == 2
    assert np.isfinite([float(x[2]) for x in run.step_log]).all()
    assert ret["recall_counts"]["gt"] > 0
    assert ("Car_ods/all_R40" in ret) == (name != "ia_ssd")


def test_test_cli_evaluates_the_checkpoint(trained):
    from de6d_tpu_torch.tools import test

    name, work, args, data, run, ret = trained
    ckpt = (work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG
            / "a/ckpt/checkpoint_epoch_1")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        got = test.main(args + ["--ckpt", str(ckpt), "--extra_tag", "a",
                                "--allow-zero-recall"] + data)
    finally:
        os.chdir(cwd)
    out = (work / "output" / run.cfg.EXP_GROUP_PATH / run.cfg.TAG
           / "a/eval/single")
    assert (out / "result.pkl").is_file()
    assert got["recall_counts"] == ret["recall_counts"]
