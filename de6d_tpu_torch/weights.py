"""flax → torch weight carry-over, and seeded weights in the flax layout.

``load_flax_npz`` reads a flat ``.npz`` of flax variables (keys like
``params/backbone_2d/ConvBlock_0/Conv_0/kernel`` and
``batch_stats/vfe/PFNLayer_0/bn/mean``, as ``bench_assets/*_params.npz``
stores them). ``flax_to_torch`` turns that dict into a state dict for a
port model whose submodule paths mirror the flax module names; a
``ModuleList`` entry ``sa_modules.0`` is flax's list member
``sa_modules_0``.

Layout mapping, by the layer's ``FLAX_KIND``:
  * SparseConv: kernel (K, Cin, Cout) → weight, the same layout;
  * Dense: kernel (in, out) → weight (out, in);
  * Conv: kernel HWIO → weight OIHW;
  * ConvTranspose: kernel (kh, kw, in, out) → weight
    ``kernel[::-1, ::-1].transpose(2, 3, 0, 1)`` — torch flips the kernel
    of a transposed convolution and flax does not;
  * BatchNorm: params scale/bias and batch_stats mean/var → weight, bias,
    running_mean, running_var.

``torch_to_flax`` goes the other way.
``flax_params_to_torch`` maps a params-only flat dict (``params/...``
keys: a flax gradient tree, or Adam's ``mu`` / ``nu``, which have the
params' shape) by the same converters onto the model's parameters (BN
scale and bias, no statistics); ``flax_train_state_to_torch`` carries a
whole JAX train state (params, batch_stats, Adam's moments and count)
into the port's model and ``train.optimization.ChainOptimizer``. The
converters are linear, so a gradient or a moment maps like its weight.

``seeded_flax`` draws such a flat dict from a numpy seed for a model the
repository holds no trained weights for; the same seed gives the same
arrays wherever it runs, and the dict unflattens into the JAX model's
variables.
"""

from __future__ import annotations

import re
from collections import OrderedDict

import numpy as np
import torch

from .models.model_utils.mlp import FCStack


def load_flax_npz(path) -> dict:
    """``.npz`` of flax variables → ``{"params/...": float32 ndarray}``."""
    with np.load(path, allow_pickle=False) as raw:
        return {k: raw[k].astype(np.float32) for k in raw.files}


def _flax_entries(kind: str, path: str):
    """(torch name, flax key, converter) for one layer."""
    p = "/".join(x for x in ("params", path) if x)
    s = "/".join(x for x in ("batch_stats", path) if x)
    if kind == "BatchNorm":
        return [
            ("weight", f"{p}/scale", None),
            ("bias", f"{p}/bias", None),
            ("running_mean", f"{s}/mean", None),
            ("running_var", f"{s}/var", None),
        ]
    kernel = {
        "SparseConv": lambda k: k,
        "Dense": lambda k: k.T,
        "Conv": lambda k: k.transpose(3, 2, 0, 1),
        "ConvTranspose": lambda k: k[::-1, ::-1].transpose(2, 3, 0, 1),
    }[kind]
    return [("weight", f"{p}/kernel", kernel), ("bias", f"{p}/bias", None)]


def flax_path(torch_name: str) -> str:
    """Torch submodule path → flax path: ``a.b_1.0.c`` → ``a/b_1_0/c``
    (flax names list members ``<attr>_<i>``)."""
    return re.sub(r"\.(\d+)(?=\.|$)", r"_\1", torch_name).replace(".", "/")


def flax_to_torch(flat: dict, model: torch.nn.Module,
                  params_only: bool = False) -> OrderedDict:
    """Map flat flax variables onto ``model``'s state dict (with
    ``params_only``, the ``params/...`` keys onto ``named_parameters()``).
    Every flax key must be consumed and every shape must match, else
    ``ValueError``."""
    target = (dict(model.named_parameters()) if params_only
              else model.state_dict())
    out = OrderedDict()
    used = set()
    for name, module in model.named_modules():
        kind = getattr(module, "FLAX_KIND", None)
        if kind is None:
            continue
        for attr, key, conv in _flax_entries(kind, flax_path(name)):
            tname = f"{name}.{attr}" if name else attr
            if params_only and not key.startswith("params"):
                continue
            if tname not in target:
                if key in flat:
                    raise ValueError(f"{key} has no torch slot ({tname})")
                continue  # e.g. a layer without bias
            if key not in flat:
                raise ValueError(f"missing flax key {key} for {tname}")
            arr = flat[key]
            arr = conv(arr) if conv else arr
            if tuple(arr.shape) != tuple(target[tname].shape):
                raise ValueError(
                    f"{key}: shape {arr.shape} vs torch "
                    f"{tuple(target[tname].shape)}"
                )
            out[tname] = torch.from_numpy(np.array(arr, order="C")).to(
                target[tname].dtype
            )
            used.add(key)
    unused = sorted(set(flat) - used)
    if unused:
        raise ValueError(f"unconsumed flax keys: {unused[:8]}")
    missing = sorted(set(target) - set(out))
    if missing:
        raise ValueError(f"torch state not covered by flax keys: {missing[:8]}")
    return out


def flax_params_to_torch(flat: dict, model: torch.nn.Module) -> OrderedDict:
    """A params-shaped flax tree (``params/...`` keys: gradients, Adam
    moments) → ``{torch parameter name: tensor}``."""
    return flax_to_torch(flat, model, params_only=True)


def flax_train_state_to_torch(model: torch.nn.Module, params: dict,
                              batch_stats: dict, mu: dict, nu: dict,
                              count: int):
    """A JAX train state as flat numpy dicts (``params/...``,
    ``batch_stats/...``; ``mu`` and ``nu`` keyed like ``params``) →
    (the model's state dict, the optimizer's named state for
    ``ChainOptimizer.load_named_state``)."""
    state = flax_to_torch({**params, **batch_stats}, model)
    named = {"count": int(count),
             "mu": flax_params_to_torch(mu, model),
             "nu": flax_params_to_torch(nu, model)}
    return state, named


# the inverse of each kind's kernel converter in _flax_entries
_KERNEL_TO_FLAX = {
    "SparseConv": lambda t: t,
    "Dense": lambda t: t.T,
    "Conv": lambda t: t.transpose(2, 3, 1, 0),
    "ConvTranspose": lambda t: t.transpose(2, 3, 0, 1)[::-1, ::-1],
}


def torch_to_flax(model: torch.nn.Module, params_only: bool = False) -> dict:
    """The other way: ``model``'s parameters and BatchNorm statistics (with
    ``params_only``, its parameters) as the flat flax dict that
    :func:`flax_to_torch` reads (float32 numpy), so that a port state
    goes back into the JAX package's ``params`` / ``batch_stats``."""
    state = (dict(model.named_parameters()) if params_only
             else model.state_dict())
    flat = {}
    for name, module in model.named_modules():
        kind = getattr(module, "FLAX_KIND", None)
        if kind is None:
            continue
        for attr, key, conv in _flax_entries(kind, flax_path(name)):
            tname = f"{name}.{attr}" if name else attr
            if tname not in state:
                continue
            a = state[tname].detach().float().cpu().numpy()
            if conv is not None:
                a = _KERNEL_TO_FLAX[kind](a)
            flat[key] = np.ascontiguousarray(a, np.float32)
    return flat


def load_into(model: torch.nn.Module, flat: dict) -> torch.nn.Module:
    """``flax_to_torch`` + a strict ``load_state_dict``."""
    model.load_state_dict(flax_to_torch(flat, model), strict=True)
    return model


def seeded_flax(model: torch.nn.Module, seed: int) -> dict:
    """Random, well-conditioned variables for ``model`` in the flat flax
    layout that :func:`flax_to_torch` reads, drawn from
    ``np.random.default_rng(seed)`` in ``named_modules()`` order: kernels
    ``normal * sqrt(2 / fan_in)``, biases ``normal * 0.05``, BN scale in
    [0.9, 1.1], BN mean ``normal * 0.1``, BN var in [0.5, 1.5], so that
    activations keep their scale through a deep ReLU stack and the BN
    arithmetic is exercised. The last Dense of an ``FCStack`` (raw
    predictions: logits, box codes, offsets) gets a fifth of that kernel
    scale, so that decoded boxes keep sizes a detector could predict
    (exp of a code of order 1 would give boxes from millimetres to
    kilometres, on which IoUs are ill-conditioned)."""
    rng = np.random.default_rng(seed)
    flat = {}
    predictions = {
        f"{name}.Dense_{len(m.fc_list)}" if name else
        f"Dense_{len(m.fc_list)}"
        for name, m in model.named_modules() if isinstance(m, FCStack)
    }

    def f32(a):
        return np.asarray(a, np.float32)

    for name, module in model.named_modules():
        kind = getattr(module, "FLAX_KIND", None)
        if kind is None:
            continue
        path = flax_path(name)
        p = "/".join(x for x in ("params", path) if x)
        if kind == "BatchNorm":
            n = module.weight.shape[0]
            s = "/".join(x for x in ("batch_stats", path) if x)
            flat[f"{p}/scale"] = f32(rng.uniform(0.9, 1.1, n))
            flat[f"{p}/bias"] = f32(rng.normal(0.0, 0.05, n))
            flat[f"{s}/mean"] = f32(rng.normal(0.0, 0.1, n))
            flat[f"{s}/var"] = f32(rng.uniform(0.5, 1.5, n))
            continue
        w = tuple(module.weight.shape)
        shape = {
            "SparseConv": lambda: w,
            "Dense": lambda: (w[1], w[0]),
            "Conv": lambda: (w[2], w[3], w[1], w[0]),
            "ConvTranspose": lambda: (w[2], w[3], w[0], w[1]),
        }[kind]()
        fan_in = int(np.prod(shape[:-1]))
        scale = np.sqrt(2.0 / fan_in) * (0.2 if name in predictions else 1.0)
        flat[f"{p}/kernel"] = f32(rng.normal(0.0, 1.0, shape) * scale)
        if getattr(module, "bias", None) is not None:
            flat[f"{p}/bias"] = f32(rng.normal(0.0, 0.05, shape[-1]))
    return flat
