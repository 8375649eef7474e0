"""The port's CLIs, ``de6d_tpu_torch.tools.train`` and
``de6d_tpu_torch.tools.test``, on the CPU with the tiny PointPillars over a
KITTI tree cut from ``data/kitti`` (8 train and 4 val frames, their infos
and sampling database): a one-epoch run writes its checkpoint, log,
``result.pkl`` and post-training eval; ``test`` evaluates that checkpoint,
once and by ``--eval_all``; a run resumes from ``--ckpt``; a checkpoint
that is not the port's (an orbax directory of the JAX package's CLI under
the same ``output/`` path, or any other file) raises with its path; and
without a card both CLIs raise unless ``--device cpu`` is given.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

TINY = str(ROOT / "configs/kitti_models/pointpillar_tiny.yaml")
OUT = Path("output/kitti_models/pointpillar_tiny")


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread: the test workers share the cores, and ops on
    tensors above PyTorch's grain otherwise wait on OpenMP barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    from torch_fixtures import kitti_subtree

    return kitti_subtree(tmp_path_factory.mktemp("kitti"), 8, 4).resolve()


def _args(tree, *extra):
    return ["--cfg_file", TINY, "--device", "cpu", "--workers", "2",
            *extra, "--set", "DATA_CONFIG.DATA_PATH", str(tree)]


@pytest.fixture(scope="module")
def trained(tree, tmp_path_factory):
    """One epoch of ``tools/train.py`` in a fresh working directory."""
    import os

    from de6d_tpu_torch.tools import train

    work = tmp_path_factory.mktemp("work")
    cwd = os.getcwd()
    os.chdir(work)
    try:
        run, ret = train.main(_args(tree, "--epochs", "1",
                                    "--fix_random_seed", "--extra_tag", "a"))
    finally:
        os.chdir(cwd)
    return work, run, ret


def test_train_cli_writes_checkpoint_log_and_eval(trained):
    work, run, ret = trained
    out = work / OUT / "a"
    assert (out / "ckpt/checkpoint_epoch_1").is_file()
    assert list(out.glob("log_train_*.txt"))
    assert (out / "eval/eval_with_train/result.pkl").is_file()
    assert run.state.step == 4  # 8 frames at batch 2
    assert len(run.step_log) == 4
    assert ret["recall_counts"]["gt"] > 0
    assert "Car_3d/moderate_R40" in ret


def test_fix_random_seed_draws_from_666(trained, tree):
    """``--fix_random_seed`` draws the init from a generator seeded with
    666: a second prepare gives the same parameters, equal to
    ``build_network`` with that generator."""
    import os

    from de6d_tpu_torch.models import build_network
    from de6d_tpu_torch.tools import train

    work, _, _ = trained
    cwd = os.getcwd()
    os.chdir(work)
    try:
        run = train.prepare(_args(tree, "--fix_random_seed", "--extra_tag",
                                  "seed"))
    finally:
        os.chdir(cwd)
    ref = build_network(run.cfg.MODEL, 1, run.train_set.spec, device="cpu",
                        generator=torch.Generator().manual_seed(666))
    for (k, a), (_, b) in zip(run.model.state_dict().items(),
                              ref.state_dict().items(), strict=True):
        assert torch.equal(a, b), k


def test_test_cli_single_and_eval_all(trained, tree):
    import os

    from de6d_tpu_torch.tools import test

    work, _, _ = trained
    ckpt = work / OUT / "a/ckpt/checkpoint_epoch_1"
    cwd = os.getcwd()
    os.chdir(work)
    try:
        ret = test.main(_args(tree, "--ckpt", str(ckpt), "--extra_tag", "a",
                              "--allow-zero-recall", "--save_to_file"))
        again = test.main(_args(tree, "--eval_all", "--extra_tag", "a",
                                "--max_waiting_mins", "0",
                                "--allow-zero-recall"))
    finally:
        os.chdir(cwd)
    out = work / OUT / "a/eval"
    assert (out / "single/result.pkl").is_file()
    assert len(list((out / "single/final_result/data").glob("*.txt"))) == 4
    assert list(out.glob("log_eval_*.txt"))
    assert (out / "epoch_1/result.pkl").is_file()
    assert (out / "eval_list_val.txt").read_text().split() == [
        "checkpoint_epoch_1"]
    assert again["recall_counts"] == ret["recall_counts"]


def test_train_cli_resumes_from_ckpt(trained, tree):
    """``--ckpt`` restores the model, the optimizer and the epoch: a run
    to epoch 2 takes 4 more steps and writes ``checkpoint_epoch_2``."""
    import os

    from de6d_tpu_torch.tools import train

    work, _, _ = trained
    ckpt = work / OUT / "a/ckpt/checkpoint_epoch_1"
    cwd = os.getcwd()
    os.chdir(work)
    try:
        run = train.prepare(_args(tree, "--ckpt", str(ckpt), "--epochs", "2",
                                  "--extra_tag", "b"))
        saved = torch.load(ckpt, weights_only=True)
        for k, v in saved["model"].items():
            assert torch.equal(run.model.state_dict()[k], v), k
        assert run.start_epoch == 1 and run.state.step == 4
        train.train(run)
    finally:
        os.chdir(cwd)
    assert run.state.step == 8 and len(run.step_log) == 4
    assert (work / OUT / "b/ckpt/checkpoint_epoch_2").is_file()


def test_foreign_checkpoint_raises_with_its_path(tree, tmp_path):
    """An orbax checkpoint directory of the JAX CLI in the run's ckpt
    directory (the newest, so it would be resumed) and a file that is not
    a torch checkpoint both raise ``ValueError`` naming the path."""
    import os

    from de6d_tpu_torch.tools import test, train

    orbax = tmp_path / OUT / "c/ckpt/checkpoint_epoch_3"
    orbax.mkdir(parents=True)
    (orbax / "_METADATA").write_text("{}")
    junk = tmp_path / "junk.pth"
    junk.write_bytes(b"not a checkpoint")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with pytest.raises(ValueError, match="checkpoint_epoch_3"):
            train.prepare(_args(tree, "--extra_tag", "c"))
        with pytest.raises(ValueError, match="junk.pth"):
            test.main(_args(tree, "--ckpt", str(junk), "--extra_tag", "c"))
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("cli", ["train", "test"])
def test_clis_default_to_the_card(cli, tree, tmp_path):
    import importlib
    import os

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    mod = importlib.import_module(f"de6d_tpu_torch.tools.{cli}")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(["--cfg_file", TINY, "--ckpt", "x", "--set",
                      "DATA_CONFIG.DATA_PATH", str(tree)])
    finally:
        os.chdir(cwd)
