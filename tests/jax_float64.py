"""The JAX package's train step in float64 with the decisions of its
float32 step, as the reference a parity test holds an fp32 gradient or
an Adam step to where the JAX package's own fp32 evaluation of it is
ill-conditioned.

Inside :func:`jax_float64` every computation of the point detectors
runs in float64 (``jax.enable_x64``; the compute dtype, the MLPs' and
BatchNorms' and the backbones' fixed ``float32`` casts read float64),
while the discrete decisions stay those of the float32 step: every
sampling call returns the picks it is given, and the ball query decides
membership on float32 coordinates, as the fp32 step does. Nothing of the
JAX package is edited: its module globals are swapped for the duration
of the context and restored after it.

Why the fp32 evaluation can be ill-conditioned: a max-pool after a ReLU
whose input lies within fp32 round-off of 0 passes a gradient in one
evaluation and none in another (``tests/test_torch_ssd3d_train.py``
names one such entry)."""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np

from torch_fixtures import unflatten


class _Float64Names(types.ModuleType):
    """``jnp`` with ``float32`` read as ``float64``."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


@contextlib.contextmanager
def jax_float64(picks, proposals=None):
    """JAX in float64 with ``picks`` (one (B, npoint) array per sampling
    call, in call order) and a RoI stage's ``proposals``
    (:func:`fp32_proposals`) forced, and the discrete decisions of the
    float32 step made in float32: the ball query's and the
    three-nearest-neighbour search's, the box containment's, the RoI
    sampler's (its draws too). Yields ``restart(picks=None,
    proposals=None)``, to be called at the start of every forward (with
    the traced picks and proposals where a compiled function takes them
    as arguments)."""
    from de6d_tpu.models.backbones_3d import pointnet2_backbone as jbb
    from de6d_tpu.models.backbones_3d import pointnet2_modules as jpn2
    from de6d_tpu.models.dense_heads import point_head_vote as jhv
    from de6d_tpu.models.model_utils import dtype_utils
    from de6d_tpu.models.model_utils import mlp as jmlp
    from de6d_tpu.models.roi_heads import roi_head_utils as jroi
    from de6d_tpu.ops import ball_query as jbq
    from de6d_tpu.ops import geometry as jgeo

    state = {"calls": iter(()), "proposals": proposals}

    def restart(traced_picks=None, traced_proposals=None):
        state["calls"] = iter(picks if traced_picks is None
                              else traced_picks)
        if traced_proposals is not None:
            state["proposals"] = traced_proposals

    def in_float32(fn):
        def run(*args, **kwargs):
            with jax.enable_x64(False):
                out = fn(*_as32(args), **_as32(kwargs))
            return _as64(out)
        return run

    swaps = [(m, "jnp", _Float64Names("jnp"))
             for m in (jbb, jpn2, jhv, jmlp)]
    swaps += [(jpn2, "run_sampling",
               lambda *a, **k: jnp.asarray(next(state["calls"]))),
              (jroi, "proposal_layer",
               lambda batch_dict, nms_cfg, num_rois:
               {**batch_dict, **_as64(state["proposals"])})]
    swaps += [(m, name, in_float32(getattr(m, name))) for m, name in (
        (jbq, "ball_query"), (jbq, "three_nn"),
        (jgeo, "points_in_boxes_mask"), (jgeo, "points_in_boxes_index"),
        (jroi, "assign_roi_targets"))]
    saved = [(m, name, getattr(m, name)) for m, name, _ in swaps]
    dtypes = dict(dtype_utils._DTYPES)
    with jax.enable_x64(True):
        try:
            for m, name, new in swaps:
                setattr(m, name, new)
            dtype_utils._DTYPES.update(float32=jnp.float64,
                                       fp32=jnp.float64)
            yield restart
        finally:
            for m, name, old in saved:
                setattr(m, name, old)
            dtype_utils._DTYPES.clear()
            dtype_utils._DTYPES.update(dtypes)


def _as32(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if jnp.result_type(x) == jnp.float64 else x, tree)


def _as64(tree):
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(x, jnp.float64)
        if jnp.result_type(x) == jnp.float32 else jnp.asarray(x), tree)


PROPOSAL_KEYS = ("rois", "roi_scores", "roi_labels", "roi_valid")


_COMPILED = {}


def fp32_proposals(jmodel, flat, batch):
    """The proposals of the JAX package's own fp32 train-mode forward at
    ``flat`` (its picks, its NMS), as :func:`jax_float64` replays them."""
    from de6d_tpu.models.roi_heads import roi_head_utils as jroi

    key = ("proposals", id(jmodel))
    if key not in _COMPILED:
        def forward(v, b):
            seen = {}

            def record(batch_dict, nms_cfg, num_rois):
                out = layer(batch_dict, nms_cfg, num_rois)
                seen.update({k: out[k] for k in PROPOSAL_KEYS})
                return out

            jroi.proposal_layer = record
            try:
                jmodel.apply(v, dict(b), train=True, mutable=["batch_stats"])
            finally:
                jroi.proposal_layer = layer
            return seen

        layer = jroi.proposal_layer
        _COMPILED[key] = (jmodel, jax.jit(forward))
    out = _COMPILED[key][1](unflatten(flat),
                            {k: jnp.asarray(x) for k, x in batch.items()})
    return {k: np.asarray(x) for k, x in out.items()}


def step_gradients(jmodel, flat, batch, picks, proposals=None):
    """The JAX package's train-mode loss and gradient in float64 at the
    variables ``flat`` (``params/...`` and ``batch_stats/...``) on
    ``batch`` with ``picks`` and, for a RoI stage, ``proposals`` forced:
    (loss terms, gradients keyed ``params/...``, float64 numpy). One
    compiled function serves every call with the same model."""
    from flax.traverse_util import flatten_dict

    with jax_float64(picks, proposals) as restart:
        key = ("grad", id(jmodel), proposals is None)
        if key not in _COMPILED:
            def loss_fn(p, s, b, traced_picks, traced_proposals):
                restart(traced_picks, traced_proposals)
                out, _ = jmodel.apply({"params": p, "batch_stats": s},
                                      dict(b), train=True,
                                      mutable=["batch_stats"])
                return jmodel.get_training_loss(out)

            _COMPILED[key] = (jmodel, jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True)))
        v = _as64(unflatten(flat))
        (_, terms), g = _COMPILED[key][1](
            v["params"], v["batch_stats"],
            _as64({k: jnp.asarray(x) for k, x in batch.items()}),
            [jnp.asarray(x) for x in picks],
            None if proposals is None else _as64(proposals))
        grads = {"params/" + "/".join(k): np.asarray(x)
                 for k, x in flatten_dict(g).items()}
        return {k: float(x) for k, x in terms.items()}, grads


def adam_step(opt_cfg, state, grads):
    """The JAX package's optimizer (``build_optimizer_and_schedule``) in
    float64 from ``state`` (parameters, statistics, Adam's first and
    second moments and count as ``torch_point_train`` records them) with
    ``grads`` (``params/...``): the parameters after the step, keyed
    ``params/...``. One compiled step serves every call with the same
    ``opt_cfg``."""
    import optax
    from flax.traverse_util import flatten_dict

    from de6d_tpu.train.optimization import build_optimizer_and_schedule

    params, _, mu, nu, count = state
    with jax.enable_x64(True):
        p = _as64(unflatten(params))["params"]
        key = ("adam", id(opt_cfg))
        if key not in _COMPILED:
            opt, _ = build_optimizer_and_schedule(opt_cfg, p,
                                                  steps_per_epoch=1)

            def step(p, g, mu, nu, count):
                # every step counter of the state (Adam's, the injected
                # schedules') at ``count``; Adam's moments the recorded
                o = jax.tree_util.tree_map(
                    lambda x: count.astype(x.dtype)
                    if jnp.issubdtype(x.dtype, jnp.integer) and x.ndim == 0
                    else x, opt.init(p))
                inject = o[1]  # clip by global norm, then the chain
                adam = inject.inner_state[0]._replace(mu=mu, nu=nu)
                o = (o[0], inject._replace(
                    inner_state=(adam,) + tuple(inject.inner_state[1:])))
                upd, _ = opt.update(g, o, p)
                return optax.apply_updates(p, upd)

            _COMPILED[key] = (opt_cfg, jax.jit(step))
        new = _COMPILED[key][1](
            p, _as64(unflatten(grads))["params"],
            _as64(unflatten(mu))["params"], _as64(unflatten(nu))["params"],
            jnp.asarray(count, jnp.int64))
        return {"params/" + "/".join(k): np.asarray(x)
                for k, x in flatten_dict(new).items()}


def port_step_gradients(pair, k):
    """The port's fp32 train-mode gradient at the JAX state before step
    ``k`` of ``pair`` (``torch_point_train``'s), that step's picks
    forced: {parameter name: numpy}."""
    import copy

    import torch

    from chip_smoke import forced_sampling
    from de6d_tpu_torch import weights

    model = copy.deepcopy(pair["tmodel"])
    sd, _ = weights.flax_train_state_to_torch(model, *pair["ref"]["states"][k])
    model.load_state_dict(sd)
    model.train()
    model.zero_grad(set_to_none=True)
    batch = {n: torch.from_numpy(v) for n, v in pair["batch"].items()}
    with forced_sampling(pair["ref"]["step_picks"][k]):
        out = model(batch)
    model.get_training_loss(out)[0].backward()
    return {n: np.zeros(p.shape, np.float32) if p.grad is None
            else p.grad.numpy() for n, p in model.named_parameters()}


def clipped(opt_cfg, grads):
    clip = float(opt_cfg.get("GRAD_NORM_CLIP", 0))
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                       for g in grads.values()))
    scale = min(1.0, clip / norm) if clip > 0 else 1.0
    return {n: g.astype(np.float64) * scale for n, g in grads.items()}


def check_adam_steps(pair, jmodel, roi=False, tol=1e-5):
    """``torch_point_train``'s 3 Adam steps held to the JAX package's
    float64 steps: from the JAX state before each step, its optimizer in
    float64 on its float64 gradient (that step's picks and, with ``roi``,
    its fp32 proposals replayed). The port's parameters after each step
    lie within ``tol`` of the leaf's largest entry, but for the entries
    that the fp32 gradient does not resolve: Adam moves every entry by
    about the learning rate ``lr`` whatever its gradient, so holding an
    entry to ``tol * max|p|`` needs its gradient to a relative
    ``tol * max|p| / lr``; where the port's fp32 gradient of that step
    lies farther than half that from the float64 one (both clipped by
    their global norm, as the optimizer takes them), the entry may part.
    Returns, per step, the number of such entries and of them parted."""
    from de6d_tpu_torch import weights
    from de6d_tpu_torch.train.optimization import (
        build_optimizer_and_schedule,
    )

    ref, got, tmodel = pair["ref"], pair["got"], pair["tmodel"]
    _, sched = build_optimizer_and_schedule(pair["opt_cfg"], tmodel, 1)
    report = []
    for k in range(len(got["params_after"])):
        state = ref["states"][k]
        flat = {**state[0], **state[1]}
        props = fp32_proposals(jmodel, flat, pair["batch"]) if roi else None
        _, g64 = step_gradients(jmodel, flat, pair["batch"],
                                ref["step_picks"][k], props)
        want = weights.flax_params_to_torch(
            adam_step(pair["opt_cfg"], state, g64), tmodel)
        # as the optimizer takes them: clipped by their global norm
        g64 = clipped(pair["opt_cfg"], {
            n: x.numpy() for n, x in
            weights.flax_params_to_torch(g64, tmodel).items()})
        g32 = clipped(pair["opt_cfg"], port_step_gradients(pair, k))
        unresolved = parted_unresolved = 0
        for name, p in want.items():
            r, g = p.numpy(), g64[name]
            bound = tol * np.abs(r).max()
            err = np.abs(got["params_after"][k][name].numpy() - r)
            noisy = (np.abs(g32[name] - g)
                     > 0.5 * bound / sched(k) * np.abs(g))
            parted = err > bound
            assert not (parted & ~noisy).any(), (
                k, name, np.argwhere(parted & ~noisy)[:4].tolist(),
                float(err[parted & ~noisy].max()), bound)
            unresolved += int(noisy.sum())
            parted_unresolved += int((parted & noisy).sum())
        report.append((unresolved, parted_unresolved))
    return report
