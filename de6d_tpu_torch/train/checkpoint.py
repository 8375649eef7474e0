"""Checkpoints (counterpart of ``de6d_tpu/train/checkpoint.py``).

``ckpt_dir/checkpoint_epoch_<n>`` is one ``torch.save`` file holding the
epoch, the step, the model's state dict (parameters and BatchNorm
statistics) and the optimizer's (moments and step count). The format is
the port's own; the JAX package's orbax checkpoints are not read here
(``weights.flax_train_state_to_torch`` carries a JAX train state across).
Ring pruning keeps the newest ``max_keep``.
"""

from __future__ import annotations

import re
import zipfile
from pathlib import Path

import torch


def save_checkpoint(ckpt_dir, state, epoch: int, max_keep: int = 30):
    """Save the train state under ``ckpt_dir/checkpoint_epoch_<epoch>``."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    path = ckpt_dir / f"checkpoint_epoch_{epoch}"
    tmp = path.with_name(path.name + ".tmp")
    torch.save({
        "epoch": int(epoch),
        "step": int(state.step),
        "model": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
    }, tmp)
    tmp.replace(path)
    prune_checkpoints(ckpt_dir, max_keep)
    return path


def list_checkpoints(ckpt_dir):
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    ckpts = []
    for p in ckpt_dir.glob("checkpoint_epoch_*"):
        m = re.fullmatch(r"checkpoint_epoch_(\d+)", p.name)
        if m:
            ckpts.append((int(m.group(1)), p))
    return [p for _, p in sorted(ckpts)]


def prune_checkpoints(ckpt_dir, max_keep: int):
    """Delete the oldest checkpoints beyond ``max_keep``."""
    ckpts = list_checkpoints(ckpt_dir)
    while len(ckpts) > max_keep:
        ckpts.pop(0).unlink(missing_ok=True)


def _load(path):
    """A checkpoint of this package, or ValueError naming ``path``: a
    directory (an orbax checkpoint of the JAX package's CLI, which writes
    under the same ``output/`` path) or any other file is not read."""
    path = Path(path)
    if not (path.is_file() and zipfile.is_zipfile(path)):
        raise ValueError(
            f"{path} is not a de6d_tpu_torch checkpoint (a torch.save "
            "file); an orbax directory of the JAX package is not read "
            "here: weights.flax_train_state_to_torch carries a JAX train "
            "state across")
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if not (isinstance(raw, dict) and {"model", "optimizer", "epoch",
                                       "step"} <= set(raw)):
        raise ValueError(f"{path} is not a de6d_tpu_torch checkpoint "
                         "(no model / optimizer / epoch / step entries)")
    return raw


def restore_checkpoint(path, state):
    """Load a checkpoint into ``state``'s model and optimizer (built as
    when it was saved). Returns (state, meta ``{"epoch"}``)."""
    raw = _load(path)
    state.model.load_state_dict(raw["model"], strict=True)
    state.optimizer.load_state_dict(raw["optimizer"])
    state.step = int(raw["step"])
    return state, {"epoch": int(raw["epoch"])}


def latest_checkpoint(ckpt_dir):
    ckpts = list_checkpoints(ckpt_dir)
    return ckpts[-1] if ckpts else None


def load_pretrained(path, state, logger=None):
    """Shape-matched partial restore: copy every tensor of the
    checkpoint's model whose name and shape match ``state.model``'s, keep
    the rest fresh (e.g. a trained backbone under a new head). Returns
    (state, n_loaded, n_skipped)."""
    src = _load(path)["model"]
    dst = state.model.state_dict()
    n_loaded = n_skipped = 0
    for k, v in dst.items():
        s = src.get(k)
        if s is not None and tuple(s.shape) == tuple(v.shape):
            v.copy_(s.to(v.dtype))
            n_loaded += 1
        else:
            n_skipped += 1
    if logger is not None:
        logger.info(f"pretrained: loaded {n_loaded} tensors from {path}, "
                    f"kept {n_skipped} fresh")
    return state, n_loaded, n_skipped
