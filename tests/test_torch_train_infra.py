"""Training infrastructure of the port against the JAX package's (after
``tests/test_train_infra.py``): the learning-rate and momentum schedules
against the optax ones, one update of each optimizer against its optax
chain (decay mask and clip included), checkpoints and the train loop.

Tolerances: the port evaluates schedules in float64 on the host, optax
in float32, whose cosine rounds relative to the schedule's peak: 1e-6
relative plus 1e-6 of the peak rate. An optimizer update from the same
gradients: 1e-6 relative to each leaf's largest entry (fp32, other
operation order).
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from de6d_tpu.train import optimization as jax_opt
from de6d_tpu_torch.train import checkpoint, optimization
from de6d_tpu_torch.train.train_state import TrainState

ONECYCLE = {
    "OPTIMIZER": "adam_onecycle", "LR": 0.003, "WEIGHT_DECAY": 0.01,
    "MOMS": [0.95, 0.85], "PCT_START": 0.4, "DIV_FACTOR": 10,
    "NUM_EPOCHS": 8, "GRAD_NORM_CLIP": 10.0,
}
ADAM_WARMUP = {
    "OPTIMIZER": "adam", "LR": 0.01, "WEIGHT_DECAY": 0.01,
    "DECAY_STEP_LIST": [3, 6], "LR_DECAY": 0.1, "LR_CLIP": 1e-7,
    "NUM_EPOCHS": 8, "LR_WARMUP": True, "WARMUP_EPOCH": 2,
    "DIV_FACTOR": 10, "GRAD_NORM_CLIP": 10.0,
}
SGD = {"OPTIMIZER": "sgd", "LR": 0.02, "WEIGHT_DECAY": 0.01,
       "MOMENTUM": 0.9, "NUM_EPOCHS": 8, "LR_WARMUP": True,
       "WARMUP_EPOCH": 1, "DIV_FACTOR": 10, "GRAD_NORM_CLIP": 10.0}


class Tree(nn.Module):
    """Leaves of every kind the decay mask separates: a conv kernel, a
    dense kernel, biases, a BN scale."""

    def __init__(self, rng):
        super().__init__()
        for name, shape in (("conv", (6, 4, 3, 3)), ("dense", (5, 7)),
                            ("bias", (5,)), ("scale", (6,))):
            self.register_parameter(name, nn.Parameter(torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32))))


@pytest.mark.parametrize("cfg", [ONECYCLE, ADAM_WARMUP, SGD],
                         ids=["adam_onecycle", "adam_warmup", "sgd"])
def test_schedules_equal_optax(cfg):
    """The learning rate (and the one-cycle momentum) at every step of a
    400-step run, 50 steps an epoch, against the JAX package's."""
    steps_per_epoch = 50
    tree = Tree(np.random.RandomState(0))
    params = {n: jnp.asarray(p.detach().numpy())
              for n, p in tree.named_parameters()}
    _, want = jax_opt.build_optimizer_and_schedule(cfg, params,
                                                   steps_per_epoch)
    _, got = optimization.build_optimizer_and_schedule(cfg, tree,
                                                       steps_per_epoch)
    total = steps_per_epoch * cfg["NUM_EPOCHS"]
    steps = np.arange(total + 5)
    np.testing.assert_allclose([got(int(k)) for k in steps],
                               [float(want(jnp.int32(k))) for k in steps],
                               rtol=1e-6, atol=1e-6 * cfg["LR"])
    if cfg["OPTIMIZER"] == "adam_onecycle":
        mom_j = jax_opt.onecycle_momentum_schedule(total, cfg["PCT_START"])
        mom_t = optimization.onecycle_momentum_schedule(total,
                                                        cfg["PCT_START"])
        np.testing.assert_allclose([mom_t(int(k)) for k in steps],
                                   [float(mom_j(jnp.int32(k)))
                                    for k in steps], rtol=1e-6)


@pytest.mark.parametrize("grad_scale", [0.1, 100.0],
                         ids=["below_clip", "clipped"])
@pytest.mark.parametrize("cfg", [ONECYCLE, ADAM_WARMUP, SGD],
                         ids=["adam_onecycle", "adam_warmup", "sgd"])
def test_updates_equal_optax(cfg, grad_scale):
    """Three updates of each optimizer from the same random gradients
    (global norm below and above the clip of 10), against the optax
    chain: the parameters after each, with weight decay only on the
    kernels (ndim > 1), and the returned norm before the clip."""
    rng = np.random.RandomState(1)
    tree = Tree(rng)
    params = {n: jnp.asarray(p.detach().numpy())
              for n, p in tree.named_parameters()}
    opt_j, _ = jax_opt.build_optimizer_and_schedule(cfg, params, 50)
    opt_t, _ = optimization.build_optimizer_and_schedule(cfg, tree, 50)
    state = opt_j.init(params)
    for _ in range(3):
        grads = {n: (rng.standard_normal(p.shape) * grad_scale).astype(
            np.float32) for n, p in params.items()}
        updates, state = opt_j.update(
            {n: jnp.asarray(g) for n, g in grads.items()}, state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for n, p in tree.named_parameters():
            p.grad = torch.from_numpy(grads[n])
        norm = opt_t.step()
        np.testing.assert_allclose(
            float(norm), float(np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                                           for g in grads.values()))),
            rtol=1e-6)
        for n, p in tree.named_parameters():
            want = np.asarray(params[n])
            err = np.abs(p.detach().numpy() - want).max()
            assert err <= 1e-6 * np.abs(want).max(), (n, err)
    assert opt_t.count == 3


def test_decay_mask_and_groups():
    """With zero gradients only the decay moves a parameter, and only one
    with more than one dimension (the JAX ``_decay_mask``)."""
    tree = Tree(np.random.RandomState(2))
    before = {n: p.detach().clone() for n, p in tree.named_parameters()}
    opt, _ = optimization.build_optimizer_and_schedule(SGD, tree, 50)
    for p in tree.parameters():
        p.grad = torch.zeros_like(p)
    opt.step()
    for n, p in tree.named_parameters():
        moved = not torch.equal(p.detach(), before[n])
        assert moved == (p.ndim > 1), n


def _state(seed):
    tree = Tree(np.random.RandomState(seed))
    opt, _ = optimization.build_optimizer_and_schedule(ONECYCLE, tree, 10)
    for p in tree.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    return TrainState(step=1, model=tree, optimizer=opt)


def test_checkpoint_round_trip(tmp_path):
    state = _state(3)
    path = checkpoint.save_checkpoint(tmp_path, state, epoch=4)
    assert path.name == "checkpoint_epoch_4"
    assert checkpoint.latest_checkpoint(tmp_path) == path
    fresh = _state(4)
    restored, meta = checkpoint.restore_checkpoint(path, fresh)
    assert meta == {"epoch": 4} and restored.step == 1
    for (n, a), b in zip(state.model.named_parameters(),
                         restored.model.parameters()):
        assert torch.equal(a, b), n
        sa = state.optimizer.state[a]
        sb = restored.optimizer.state[b]
        assert torch.equal(sa["mu"], sb["mu"]) and torch.equal(sa["nu"],
                                                               sb["nu"])
    assert restored.optimizer.count == 1


def test_checkpoint_pruning(tmp_path):
    state = _state(5)
    for epoch in range(1, 6):
        checkpoint.save_checkpoint(tmp_path, state, epoch, max_keep=2)
    names = [p.name for p in checkpoint.list_checkpoints(tmp_path)]
    assert names == ["checkpoint_epoch_4", "checkpoint_epoch_5"]
    assert sorted(p.name for p in tmp_path.iterdir()) == names


def test_load_pretrained_partial(tmp_path):
    """Tensors whose name and shape match are copied, the rest kept."""
    src = _state(6)
    path = checkpoint.save_checkpoint(tmp_path, src, epoch=1)
    dst = _state(7)
    with torch.no_grad():
        dst.model.dense = nn.Parameter(torch.zeros(9, 7))  # other shape
    kept = dst.model.dense.detach().clone()
    _, n_loaded, n_skipped = checkpoint.load_pretrained(
        path, dst, logger=logging.getLogger("test"))
    assert (n_loaded, n_skipped) == (3, 1)
    assert torch.equal(dst.model.conv, src.model.conv)
    assert torch.equal(dst.model.dense, kept)


class _Loader:
    """A fixed batch per epoch, with ``set_epoch`` as the loop wants."""

    def __init__(self, batch):
        self.batch = batch
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __iter__(self):
        yield self.batch


def test_train_model_loop(tmp_path):
    """The tiny PointPillars through ``train_model`` on the CPU: every
    epoch's ``set_epoch``, the checkpoint cadence and pruning, the step
    count, a finite loss logged."""
    import copy
    from pathlib import Path

    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models import build_network
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        DatasetSpec,
    )
    from de6d_tpu_torch.train import create_train_state
    from de6d_tpu_torch.train.train_loop import train_model
    from model_fixtures import random_batch
    from torch_fixtures import spec_kwargs

    root = Path(__file__).resolve().parents[1]
    cfg = cfg_from_yaml_file(str(root / "configs/kitti_models/"
                                 "pointpillar_tiny.yaml"))
    spec = DatasetSpec(**spec_kwargs(cfg))
    torch.manual_seed(0)
    model = build_network(copy.deepcopy(cfg.MODEL), 1, spec, device="cpu")
    batch = random_batch(np.random.RandomState(0), spec, batch_size=2,
                         n_points=1024)
    batch["gt_boxes"][..., -1] = np.where(batch["gt_boxes"][..., 3] > 0, 1, 0)
    opt_cfg = dict(cfg.OPTIMIZATION)
    opt, sched = optimization.build_optimizer_and_schedule(opt_cfg, model, 1)
    state = create_train_state(model, opt)
    loader = _Loader(batch)

    class Log:
        def __init__(self):
            self.lines = []

        def info(self, msg):
            self.lines.append(msg)

    log = Log()
    state = train_model(model, opt, state, loader, opt_cfg, total_epochs=3,
                        ckpt_dir=tmp_path, ckpt_save_interval=1,
                        max_ckpt_save_num=2, logger=log, lr_schedule=sched,
                        log_interval=1)
    assert loader.epochs == [0, 1, 2] and state.step == 3
    assert [p.name for p in checkpoint.list_checkpoints(tmp_path)] == [
        "checkpoint_epoch_2", "checkpoint_epoch_3"]
    losses = [float(line.split("loss ")[1].split()[0])
              for line in log.lines if "loss" in line]
    assert len(losses) == 3 and all(np.isfinite(losses))
