"""Optimizers and learning-rate schedules (counterpart of
``de6d_tpu/train/optimization.py``, whose optax chains this module
writes out as one ``torch.optim.Optimizer``).

The optax chain of each optimizer, in its order, at the 0-based step k:

- ``adam_onecycle``: clip by global norm → Adam with ``b1 = mom(k)``,
  ``b2 = 0.999``, ``eps = 1e-8``, bias-corrected with count k + 1 and the
  current b1 → ``+ wd * p`` on the decayed parameters → ``* -lr(k)``;
  ``lr`` is optax's ``cosine_onecycle_schedule`` (final divisor 1e4),
  ``mom`` the inverse one-cycle momentum.
- ``adam``: clip → optax's ``adamw`` (b1 0.9) with a step-decay schedule
  (optionally behind a cosine warm-up).
- ``sgd``: clip → momentum trace ``t = g + m * t`` → ``* -lr(k)`` →
  ``+ wd * p`` (optax adds the decay after the learning rate here, so it
  is not multiplied by it).

Weight decay reaches only parameters with more than one dimension (the
JAX ``_decay_mask``: no BN scale or bias, no bias). The clip leaves the
gradients alone when their global norm is below the limit and otherwise
scales them by ``limit / norm`` (not ``torch.nn.utils.clip_grad_norm_``,
which divides by ``norm + 1e-6``). Schedules are evaluated on the host
in float64; the JAX package evaluates them in float32 on the device.
"""

from __future__ import annotations

import math

import torch


def _cosine_interpolate(start, end, pct):
    return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)


def cosine_onecycle_schedule(transition_steps: int, peak_value: float,
                             pct_start: float = 0.3, div_factor: float = 25.0,
                             final_div_factor: float = 1e4):
    """optax's ``cosine_onecycle_schedule``: cosine from ``peak /
    div_factor`` up to ``peak`` over the first ``pct_start`` of the steps,
    then down to ``peak / div_factor / final_div_factor``."""
    if transition_steps <= 0:
        raise ValueError("cosine_onecycle_schedule: transition_steps <= 0")
    b1, b2 = int(pct_start * transition_steps), int(transition_steps)
    v0 = peak_value / div_factor
    v1 = v0 * div_factor
    v2 = v1 * (1.0 / (div_factor * final_div_factor))

    def sched(step):
        if step < 0:
            return 0.0
        if step < b1:
            return _cosine_interpolate(v0, v1, step / b1)
        if step < b2:
            return _cosine_interpolate(v1, v2, (step - b1) / (b2 - b1))
        return v2

    return sched


def onecycle_momentum_schedule(total_steps: int, pct_start: float,
                               moms=(0.95, 0.85)):
    """Momentum anneals opposite to the learning rate: m0 → m1 over the
    warm-up, back to m0 over the cool-down."""
    hi, lo = moms
    warm = max(int(total_steps * pct_start), 1)

    def sched(step):
        step = min(step, total_steps)
        if step < warm:
            t1 = min(max(step / warm, 0.0), 1.0)
            return hi + (lo - hi) * 0.5 * (1 - math.cos(math.pi * t1))
        t2 = min(max((step - warm) / max(total_steps - warm, 1), 0.0), 1.0)
        return lo + (hi - lo) * 0.5 * (1 - math.cos(math.pi * t2))

    return sched


def _maybe_warmup(base_sched, opt_cfg, lr: float, steps_per_epoch: int):
    """With ``LR_WARMUP``, the first ``WARMUP_EPOCH`` epochs ramp the rate
    along a cosine from ``LR / DIV_FACTOR`` up to the base schedule."""
    if not opt_cfg.get("LR_WARMUP", False):
        return base_sched
    warmup_steps = max(
        int(opt_cfg.get("WARMUP_EPOCH", 1)) * steps_per_epoch, 1)
    eta_min = lr / float(opt_cfg.get("DIV_FACTOR", 10.0))

    def sched(step):
        if step >= warmup_steps:
            return base_sched(step)
        t = min(max(step / warmup_steps, 0.0), 1.0)
        return eta_min + (base_sched(step) - eta_min) * 0.5 * (
            1 - math.cos(math.pi * t))

    return sched


class ChainOptimizer(torch.optim.Optimizer):
    """One of the JAX package's optax chains over a model's parameters.

    ``step()`` reads the gradients, clips them, updates the parameters
    and returns the gradients' global norm before the clip (a 0-d tensor
    on their device; no host synchronisation). The step count k lives in
    every parameter group (``"count"``), so ``state_dict()`` carries it.
    Parameters with more than one dimension are in the first group, which
    takes the weight decay.
    """

    B2, EPS = 0.999, 1e-8  # optax's scale_by_adam defaults, as the JAX chains

    def __init__(self, named_params, kind: str, lr_schedule,
                 mom_schedule=None, weight_decay: float = 0.0,
                 clip: float = 0.0, momentum: float = 0.9):
        if kind not in ("adam_onecycle", "adam", "sgd"):
            raise NotImplementedError(kind)
        named = [(n, p) for n, p in named_params if p.requires_grad]
        groups = [
            {"params": [p for _, p in named if p.ndim > 1],
             "weight_decay": weight_decay},
            {"params": [p for _, p in named if p.ndim <= 1],
             "weight_decay": 0.0},
        ]
        super().__init__([g for g in groups if g["params"]], {"count": 0})
        self.kind = kind
        self.lr_schedule = lr_schedule
        self.mom_schedule = mom_schedule
        self.clip = clip
        self.momentum = momentum
        self.names = {p: n for n, p in named}

    @property
    def count(self) -> int:
        return int(self.param_groups[0]["count"])

    def _slots(self, params):
        keys = ("trace",) if self.kind == "sgd" else ("mu", "nu")
        for p in params:
            st = self.state[p]
            for key in keys:
                if key not in st:
                    st[key] = torch.zeros_like(p)
        return [[self.state[p][key] for p in params] for key in keys]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("ChainOptimizer.step takes no closure")
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        if self.clip > 0:
            scale = torch.where(norm < self.clip, torch.ones_like(norm),
                                self.clip / norm)
            grads = torch._foreach_mul(grads, scale)
        k = self.count
        lr = float(self.lr_schedule(k))
        start = 0
        for group in self.param_groups:
            ps = group["params"]
            gs = grads[start:start + len(ps)]
            start += len(ps)
            wd = group["weight_decay"]
            if self.kind == "sgd":
                (trace,) = self._slots(ps)
                torch._foreach_mul_(trace, self.momentum)
                torch._foreach_add_(trace, gs)
                upd = torch._foreach_mul(trace, -lr)
            else:
                b1 = (float(self.mom_schedule(k))
                      if self.kind == "adam_onecycle" else 0.9)
                mu, nu = self._slots(ps)
                torch._foreach_mul_(mu, b1)
                torch._foreach_add_(mu, gs, alpha=1 - b1)
                torch._foreach_mul_(nu, self.B2)
                torch._foreach_addcmul_(nu, gs, gs, value=1 - self.B2)
                denom = torch._foreach_div(nu, 1 - self.B2 ** (k + 1))
                torch._foreach_sqrt_(denom)
                torch._foreach_add_(denom, self.EPS)
                upd = torch._foreach_div(mu, 1 - b1 ** (k + 1))
                torch._foreach_div_(upd, denom)
                if wd:
                    torch._foreach_add_(upd, ps, alpha=wd)
                torch._foreach_mul_(upd, -lr)
            if wd and self.kind == "sgd":
                torch._foreach_add_(upd, ps, alpha=wd)
            torch._foreach_add_(ps, upd)
            group["count"] = k + 1
        return norm

    def load_named_state(self, named_state: dict):
        """Resume from moments keyed by parameter name:
        ``{"count": k, "mu": {name: tensor}, "nu": {name: tensor}}`` (or
        ``"trace"`` for sgd), as ``weights.flax_train_state_to_torch``
        gives them."""
        keys = ("trace",) if self.kind == "sgd" else ("mu", "nu")
        for group in self.param_groups:
            group["count"] = int(named_state["count"])
            for p in group["params"]:
                name = self.names[p]
                for key in keys:
                    src = named_state[key][name]
                    if tuple(src.shape) != tuple(p.shape):
                        raise ValueError(
                            f"{key}/{name}: shape {tuple(src.shape)} vs "
                            f"{tuple(p.shape)}")
                    self.state[p][key] = src.to(p.device, p.dtype).clone()


def build_optimizer_and_schedule(opt_cfg, model, steps_per_epoch: int):
    """(optimizer over ``model``'s parameters, lr schedule ``k -> lr``)."""
    total_steps = int(steps_per_epoch * opt_cfg["NUM_EPOCHS"])
    lr = float(opt_cfg["LR"])
    wd = float(opt_cfg.get("WEIGHT_DECAY", 0.0))
    clip = float(opt_cfg.get("GRAD_NORM_CLIP", 0.0))
    name = str(opt_cfg.get("OPTIMIZER", "adam_onecycle"))
    mom_sched = None
    momentum = 0.9
    if name == "adam_onecycle":
        pct_start = float(opt_cfg.get("PCT_START", 0.4))
        div = float(opt_cfg.get("DIV_FACTOR", 10.0))
        lr_sched = cosine_onecycle_schedule(
            total_steps, lr, pct_start=pct_start, div_factor=div,
            final_div_factor=div * 1e4 / div)
        mom_sched = onecycle_momentum_schedule(
            total_steps, pct_start, tuple(opt_cfg.get("MOMS", [0.95, 0.85])))
    elif name == "adam":
        decay_steps = [int(e * steps_per_epoch)
                       for e in opt_cfg.get("DECAY_STEP_LIST", [])]
        gamma = float(opt_cfg.get("LR_DECAY", 0.1))
        lr_clip = float(opt_cfg.get("LR_CLIP", 1e-7))

        def lr_sched(step):
            f = 1.0
            for d in decay_steps:
                if step >= d:
                    f *= gamma
            return max(lr * f, lr_clip)

        lr_sched = _maybe_warmup(lr_sched, opt_cfg, lr, steps_per_epoch)
    elif name == "sgd":
        lr_sched = _maybe_warmup(lambda step: lr, opt_cfg, lr, steps_per_epoch)
        momentum = float(opt_cfg.get("MOMENTUM", 0.9))
    else:
        raise NotImplementedError(name)
    opt = ChainOptimizer(model.named_parameters(), name, lr_sched,
                         mom_schedule=mom_sched, weight_decay=wd, clip=clip,
                         momentum=momentum)
    return opt, lr_sched
