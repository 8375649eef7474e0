"""Train-step references for the point detectors' parity tests: one JAX
loss-and-gradient evaluation in train mode and ``steps`` steps of the JAX
package's ``make_train_step``, with every sampling call's picks recorded,
and the port's step from the same variables with the reference's picks
forced (``chip_smoke.forced_sampling``).

Targets may be arrays or lists of arrays (IA-SSD's per-layer instance
labels, ``None`` where a layer has none)."""

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from de6d_tpu_torch import weights

ROOT = Path(__file__).resolve().parents[1]
T = torch.from_numpy


@contextlib.contextmanager
def recorded_jax_sampling():
    """Inside a JAX trace, record each sampling call of the point
    backbones (``run_sampling``, ``run_sampling_iassd``) in call order as
    (picks, the scores it ranks or weights by, or None)."""
    from chip_smoke import sampling_segments
    from de6d_tpu.models.backbones_3d import iassd_backbone as jax_iassd
    from de6d_tpu.models.backbones_3d import pointnet2_modules as jax_pn2

    rec = []

    def wrap(fn):
        def run(method, xyz, features, scores, valid, npoint, sample_range,
                *rest):
            idx = fn(method, xyz, features, scores, valid, npoint,
                     sample_range, *rest)
            kinds = {k for k, _, _ in sampling_segments(method, int(npoint))}
            rec.append((idx, scores if kinds & {"topk", "sfps"} else None))
            return idx
        return run

    orig = (jax_pn2.run_sampling, jax_iassd.run_sampling_iassd)
    jax_pn2.run_sampling = wrap(orig[0])
    jax_iassd.run_sampling_iassd = wrap(orig[1])
    try:
        yield rec
    finally:
        jax_pn2.run_sampling, jax_iassd.run_sampling_iassd = orig


def to_numpy(x):
    if x is None:
        return None
    if isinstance(x, (list, tuple)):
        return [to_numpy(v) for v in x]
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def flat(tree, prefix):
    from flax.traverse_util import flatten_dict

    return {"/".join((prefix,) + k): np.asarray(v, np.float32)
            for k, v in flatten_dict(tree).items()}


def _reference_output(tb, new_stats, keep, grads, target_keys):
    from optax import global_norm

    return {
        "metrics": {k: float(v) for k, v in tb.items()}
        | {"grad_norm": float(global_norm(grads))},
        "grads": flat(grads, "params"),
        "batch_stats": flat(new_stats, "batch_stats"),
        "targets": {k: to_numpy(keep[k]) for k in target_keys},
        "picks": [np.asarray(i) for i, _ in keep["calls"]],
        "scores": [None if s is None else np.asarray(s)
                   for _, s in keep["calls"]],
    }


def jax_step_reference(jmodel, variables, batch, target_keys):
    """One JAX loss-and-gradient evaluation in train mode, as numpy: the
    loss terms and the gradient norm, the gradients, the new BatchNorm
    statistics, the targets, each sampling call's picks and scores."""
    return jax_train_reference(jmodel, variables, batch, None, target_keys,
                               steps=0)


def jax_train_reference(jmodel, variables, batch, opt_cfg, target_keys,
                        steps=3):
    """:func:`jax_step_reference`, then ``steps`` steps of the JAX
    package's train step (``make_train_step``'s computation: the same
    loss and gradient, then the optimizer's update, each jitted on its
    own so that one compiled gradient serves every step and the picks of
    each): each step's picks, loss and the state before and after it
    (parameters, statistics, Adam's moments and count, as numpy)."""
    import optax

    params, stats = variables["params"], variables["batch_stats"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with recorded_jax_sampling() as rec:
        def loss_fn(p, s, b):
            rec.clear()
            out, mutated = jmodel.apply(
                {"params": p, "batch_stats": s}, dict(b), train=True,
                mutable=["batch_stats"])
            loss, tb = jmodel.get_training_loss(out)
            keep = {k: out[k] for k in target_keys}
            keep["calls"] = list(rec)
            return loss, (tb, mutated["batch_stats"], keep)

        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

        def run(p, s):
            (_, (tb, new_stats, keep)), grads = grad_fn(p, s, jb)
            return tb, new_stats, keep, grads

        first = run(params, stats)
    out = _reference_output(*first, target_keys)
    if not steps:
        return out
    from de6d_tpu.train.optimization import build_optimizer_and_schedule

    optimizer, _ = build_optimizer_and_schedule(opt_cfg, params,
                                                steps_per_epoch=1)

    @jax.jit
    def update(g, o, p):
        updates, o = optimizer.update(g, o, p)
        return optax.apply_updates(p, updates), o

    def flat_state(p, s, o):
        adam = o[1].inner_state[0]  # clip, then the chain
        return (flat(p, "params"), flat(s, "batch_stats"),
                flat(adam.mu, "params"), flat(adam.nu, "params"),
                int(adam.count))

    opt_state = optimizer.init(params)
    step_picks, states, losses = [], [], []
    for k in range(steps):
        tb, new_stats, keep, grads = first if k == 0 else run(params, stats)
        step_picks.append([np.asarray(i) for i, _ in keep["calls"]])
        states.append(flat_state(params, stats, opt_state))
        params, opt_state = update(grads, opt_state, params)
        stats = new_stats
        losses.append(float(tb["loss"]))
    states.append(flat_state(params, stats, opt_state))
    return out | {"losses": losses, "states": states,
                  "step_picks": step_picks}


def port_train_run(tmodel, flat_vars, batch, opt_cfg, ref, target_keys,
                   steps=3):
    """The port's step from the same variables, every sampling call forced
    to the reference's picks (``ref["picks"]`` for the first forward,
    ``ref["step_picks"][k]`` in step k) and its own picks of the first
    forward kept: metrics, targets, gradients and BatchNorm statistics of
    the first step; then each of ``steps`` steps from the JAX state before
    it, with its loss and the parameters after it."""
    from chip_smoke import forced_sampling
    from de6d_tpu_torch.train import (
        build_optimizer_and_schedule, create_train_state, make_train_step,
    )

    weights.load_into(tmodel, flat_vars)
    opt, _ = build_optimizer_and_schedule(opt_cfg, tmodel, 1)
    state = create_train_state(tmodel, opt)
    tb = {k: T(v) for k, v in batch.items()}
    out = {"losses": [], "params_after": []}
    with forced_sampling(ref["picks"]) as calls:
        tmodel.train()
        fwd = tmodel(dict(tb))
    out["targets"] = {k: to_numpy(fwd[k]) for k in target_keys}
    out["calls"] = list(calls)
    if not steps:  # the first forward's loss and gradients alone
        tmodel.zero_grad(set_to_none=True)
        loss, terms = tmodel.get_training_loss(fwd)
        loss.backward()
        out["grads"] = {n: torch.zeros_like(p) if p.grad is None
                        else p.grad.clone()
                        for n, p in tmodel.named_parameters()}
        out["metrics"] = {k: float(v) for k, v in terms.items()} | {
            "grad_norm": float(torch.sqrt(sum(
                (g.double() ** 2).sum() for g in out["grads"].values())))}
        out["buffers"] = {n: b.clone() for n, b in tmodel.named_buffers()
                          if "running" in n}
        return out
    step = make_train_step(tmodel, opt)
    for i in range(steps):
        sd, named = weights.flax_train_state_to_torch(tmodel,
                                                      *ref["states"][i])
        tmodel.load_state_dict(sd)
        opt.load_named_state(named)
        with forced_sampling(ref["step_picks"][i]):
            state, m = step(state, tb)
        out["losses"].append(float(m["loss"]))
        if i == 0:
            out["metrics"] = {k: float(v) for k, v in m.items()}
            # a layer no loss reaches (the s-fps confidence MLPs without
            # SASA) has no gradient: JAX's is zeros
            out["grads"] = {n: torch.zeros_like(p) if p.grad is None
                            else p.grad.clone()
                            for n, p in tmodel.named_parameters()}
            out["buffers"] = {n: b.clone()
                              for n, b in tmodel.named_buffers()
                              if "running" in n}
        out["params_after"].append({n: p.detach().clone()
                                    for n, p in tmodel.named_parameters()})
    return out


def leaf_close(got, ref, rel, what):
    scale = max(float(np.abs(ref).max()), 1e-12)
    err = float(np.abs(got - ref).max())
    assert err <= rel * scale, f"{what}: max |d| {err} > {rel} * {scale}"


def check_gradients(pair, rel=1e-4):
    want = weights.flax_params_to_torch(pair["ref"]["grads"], pair["tmodel"])
    got = pair["got"]["grads"]
    assert set(want) == set(got)
    for name, g in want.items():
        leaf_close(got[name].numpy(), g.numpy(), rel, name)


def f64_gradients(pair):
    """The first step's gradients evaluated by the port in float64 (every
    layer, the reference's picks), per parameter as numpy."""
    import copy

    from chip_smoke import forced_sampling

    model = copy.deepcopy(pair["tmodel"])
    weights.load_into(model, pair["flat"])
    model.double()
    for mod in model.modules():
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = torch.float64
    model.train()
    model.zero_grad(set_to_none=True)
    batch = {k: T(v) for k, v in pair["batch"].items()}
    batch["points"] = batch["points"].double()
    with forced_sampling(pair["ref"]["picks"]):
        out = model(batch)
    model.get_training_loss(out)[0].backward()
    return {n: np.zeros(p.shape) if p.grad is None else p.grad.numpy()
            for n, p in model.named_parameters()}


def check_gradients_against_f64(pair, rel=1e-4):
    """Each leaf's gradient within ``rel`` of its largest entry, or within
    twice the larger distance of the two fp32 gradients (JAX's, the
    port's) from the float64 one where that is larger: the rule behind
    ``chip_smoke``'s train tolerances, for a step whose fp32 summation
    noise is itself near ``rel``."""
    want = weights.flax_params_to_torch(pair["ref"]["grads"], pair["tmodel"])
    g64 = f64_gradients(pair)
    got = pair["got"]["grads"]
    assert set(want) == set(got) == set(g64)
    for name, g in want.items():
        r, a, e = g.numpy(), got[name].numpy(), g64[name]
        scale = max(float(np.abs(e).max()), 1e-12)
        noise = max(np.abs(r - e).max(), np.abs(a - e).max()) / scale
        err = float(np.abs(a - r).max()) / scale
        assert err <= max(rel, 2 * noise), (name, err, noise)


def check_batch_stats(pair, tol=1e-5):
    want = weights.flax_to_torch({**pair["flat"],
                                  **pair["ref"]["batch_stats"]},
                                 pair["tmodel"])
    got = pair["got"]["buffers"]
    assert got
    for name, b in got.items():
        np.testing.assert_allclose(b.numpy(), want[name].numpy(), rtol=tol,
                                   atol=tol, err_msg=name)


def check_metrics(pair, rel=1e-5):
    ref, got = pair["ref"]["metrics"], pair["got"]["metrics"]
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=rel, err_msg=k)


def check_three_steps(pair):
    """3 Adam steps, each from the JAX state before it: the loss of each
    within 1e-5 relative, the parameters after it within 1e-5 of the
    leaf's largest entry; an entry whose gradient sits at the level of the
    two libraries' summation-order noise may part (at most 0.5 % of a
    leaf), by no more than the learning rates summed over the steps
    (Adam divides each entry by its own root-mean-square gradient)."""
    from de6d_tpu_torch.train.optimization import (
        build_optimizer_and_schedule,
    )

    ref, got = pair["ref"], pair["got"]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=1e-5)
    _, sched = build_optimizer_and_schedule(pair["opt_cfg"], pair["tmodel"],
                                            1)
    lr_sum = sum(sched(k) for k in range(3))
    for k in range(3):
        want = weights.flax_params_to_torch(ref["states"][k + 1][0],
                                            pair["tmodel"])
        for name, p in want.items():
            r = p.numpy()
            err = np.abs(got["params_after"][k][name].numpy() - r)
            parted = err > 1e-5 * np.abs(r).max()
            assert parted.mean() <= 0.005, (k, name, parted.mean())
            assert err.max() <= lr_sum, (k, name, err.max(), lr_sum)


def certify_calls(tag, pair, tol):
    """Every sampling call's own picks equal the reference's or part at a
    certified near-tie."""
    from chip_smoke import certify_sampling_call

    ref, got = pair["ref"], pair["got"]
    assert len(got["calls"]) == len(ref["picks"])
    for k, call in enumerate(got["calls"]):
        certify_sampling_call(tag, k, call, ref["scores"][k], tol)


def opt_cfg_of(cfg_path, epochs=20):
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg

    opt = dict(jax_cfg(str(ROOT / cfg_path)).OPTIMIZATION)
    opt["NUM_EPOCHS"] = epochs
    return opt
