"""Training loop (counterpart of ``de6d_tpu/train/train_loop.py``):
per-step learning rate (inside the optimizer), clip (inside the
optimizer), data and step meters, scalar logging, periodic checkpoints,
an optional ``torch.profiler`` window.

The loop keeps a 1-deep pipeline: after queueing step k it waits only
for step k-1 (a CUDA event recorded after it), so the host prepares the
next batch while the card runs.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..utils.common_utils import AverageMeter
from .checkpoint import save_checkpoint
from .train_state import make_train_step

DEVICE_BATCH_KEYS = ("points", "points_mask", "gt_boxes")


def device_batch(batch, device):
    """The keys the model reads, as tensors on ``device``. Host arrays go
    to the card through pinned memory, so the copy queues behind the
    step in flight instead of blocking the host until it ends (a copy
    from pageable memory is synchronous)."""
    out = {}
    for k in DEVICE_BATCH_KEYS:
        if k in batch:
            v = batch[k]
            if isinstance(v, np.ndarray):
                v = torch.from_numpy(v)
                if device.type == "cuda":
                    v = v.pin_memory()
            out[k] = v.to(device, non_blocking=True)
    return out


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def train_model(
    model,
    optimizer,
    state,
    train_loader,
    opt_cfg,
    start_epoch: int = 0,
    total_epochs: int = 80,
    ckpt_dir=None,
    ckpt_save_interval: int = 1,
    max_ckpt_save_num: int = 30,
    tb_log=None,
    logger=None,
    lr_schedule=None,
    log_interval: int = 50,
    profile_dir=None,
    profile_steps: tuple = (10, 20),
    step_log=None,
):
    """Train ``state`` over ``train_loader`` (any iterable of batches
    with ``set_epoch``) from ``start_epoch`` to ``total_epochs``. With
    ``profile_dir``, steps [profile_steps[0], profile_steps[1]) are traced
    by ``torch.profiler`` into ``profile_dir/trace.json``. With a list
    ``step_log``, each step appends (seconds waiting on the loader,
    seconds of the step on the host: its dispatch plus the wait for the
    step before it, its loss as a 0-d tensor on the device, not
    synchronised). Returns the state."""
    del opt_cfg  # the schedule and clip live in the optimizer
    device = next(model.parameters()).device
    train_step = make_train_step(model, optimizer)
    data_time = AverageMeter()
    step_time = AverageMeter()
    step_window = []  # last-50 steady-state window
    it = int(state.step)
    prof = None
    prev_done = None
    for epoch in range(start_epoch, total_epochs):
        train_loader.set_epoch(epoch)
        t_end = time.perf_counter()
        for batch in train_loader:
            if profile_dir is not None and it == profile_steps[0]:
                prof = _profiler(device)
                prof.__enter__()
            t_data = time.perf_counter() - t_end
            state, metrics = train_step(state, device_batch(batch, device))
            if prev_done is not None:
                prev_done.synchronize()
            prev_done = None
            if device.type == "cuda":
                prev_done = torch.cuda.Event()
                prev_done.record()
            t_step = time.perf_counter() - t_end - t_data
            data_time.update(t_data)
            step_time.update(t_step)
            if step_log is not None:
                step_log.append((t_data, t_step, metrics["loss"]))
            it += 1
            if prof is not None and it >= profile_steps[1]:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                prof.__exit__(None, None, None)
                Path(profile_dir).mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(Path(profile_dir) / "trace.json"))
                prof = None
                if logger:
                    logger.info(f"profiler trace saved to {profile_dir}")
            if tb_log is not None and it % log_interval == 0:
                for k, v in metrics.items():
                    tb_log.add_scalar(f"train/{k}", float(v), it)
                if lr_schedule is not None:
                    tb_log.add_scalar("meta_data/learning_rate",
                                      float(lr_schedule(it)), it)
            step_window.append(t_step)
            if len(step_window) > 50:
                step_window.pop(0)
            if logger is not None and it % log_interval == 0:
                w50 = sum(step_window) / len(step_window)
                logger.info(
                    f"epoch {epoch} it {it} "
                    f"loss {float(metrics['loss']):.4f} "
                    f"data {data_time.avg * 1e3:.0f}ms "
                    f"step {step_time.avg * 1e3:.0f}ms "
                    f"step50 {w50 * 1e3:.0f}ms")
            t_end = time.perf_counter()

        if ckpt_dir is not None and (epoch + 1) % ckpt_save_interval == 0:
            save_checkpoint(ckpt_dir, state, epoch + 1, max_ckpt_save_num)
            if logger:
                logger.info(f"saved checkpoint epoch {epoch + 1}")
    if prev_done is not None:
        prev_done.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
    return state
