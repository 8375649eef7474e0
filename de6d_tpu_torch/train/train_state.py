"""Train state and train step (counterpart of
``de6d_tpu/train/train_state.py``).

The JAX step is one jitted function of (params, batch_stats, opt_state);
here the parameters and BatchNorm statistics live in the model and the
moments in the optimizer, both updated in place: forward in train mode
(which moves the running statistics), loss, backward, the global norm,
the clip and the update. Parameters stay fp32 and the layers cast them
to the compute dtype at use, so the gradients land on the fp32
parameters; there is no autocast and no loss scaling, as in the JAX
step.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer


def create_train_state(model, optimizer, step: int = 0):
    """Wrap a built model (its weights already loaded) and its optimizer."""
    return TrainState(step=int(step), model=model, optimizer=optimizer)


def make_train_step(model, optimizer):
    """Returns ``train_step(state, batch) -> (state, metrics)``: the terms
    of the detector's ``get_training_loss`` (``loss`` and its parts, e.g.
    PointPillars' ``rpn_loss_*``, Det6D's ``vote_loss_reg``,
    ``point_loss_*``, ``point_pos_num``) and ``grad_norm`` (before the
    clip), as 0-d tensors on the model's device, not synchronised."""

    def train_step(state: TrainState, batch: dict):
        model.train()
        optimizer.zero_grad(set_to_none=True)
        out = model(dict(batch))
        loss, tb = model.get_training_loss(out)
        loss.backward()
        grad_norm = optimizer.step()
        metrics = {k: v.detach() for k, v in tb.items()}
        metrics["grad_norm"] = grad_norm
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(model, post_cfg, num_class: int):
    """Inference step: eval-mode forward + NMS post-processing."""
    from ..models.detectors.detector3d_template import post_processing

    def eval_step(batch):
        model.eval()
        return post_processing(model(dict(batch)), post_cfg, num_class)

    return eval_step
