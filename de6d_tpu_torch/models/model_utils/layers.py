"""Parameter-holding layers with the JAX package's (flax) arithmetic.

Parameters are fp32; each layer casts its input and weights to the
module's compute dtype at use, as flax's ``dtype=`` does. Each class
names its flax counterpart in ``FLAX_KIND`` so ``weights.flax_to_torch``
knows how to carry a flax kernel across.

The layers initialise as flax's do: kernels by ``lecun_normal`` (a normal
of variance 1 / fan_in truncated at two standard deviations, with flax's
fan-in of each kernel layout), biases zero, BatchNorm scale one and bias
zero. ``Conv`` takes flax's ``kernel_init`` / ``bias_init`` overrides as
callables ``fn(tensor, generator)``. :func:`init_flax_` draws a whole
model again from one ``torch.Generator``, or from a
``numpy.random.Generator``, whose draws are the same on every machine and
PyTorch build (a seeded ``torch.Generator``'s truncated normals are not);
the bits cannot be flax's (jax's PRNG is not torch's), only the
distributions are.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# the standard deviation of a unit normal truncated at +-2, by which
# flax's variance_scaling divides to keep the requested variance
_TRUNC_STD = 0.87962566103423978


def _fill(t, values):
    """Copy numpy ``values`` into ``t`` in its dtype."""
    with torch.no_grad():
        return t.copy_(torch.from_numpy(np.ascontiguousarray(values)).to(
            t.dtype))


def _trunc_normal_np(rng, shape):
    """Unit normals redrawn until every one lies within [-2, 2]."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2
    return x


def lecun_normal(fan_in: int):
    """flax ``lecun_normal()``: ``variance_scaling(1, "fan_in",
    "truncated_normal")`` for a kernel of fan-in ``fan_in``."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD

    def init(t, generator=None):
        if isinstance(generator, np.random.Generator):
            return _fill(t, _trunc_normal_np(generator, tuple(t.shape)) * std)
        return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std,
                                     generator=generator)

    return init


def normal(stddev: float):
    """flax ``initializers.normal(stddev)``."""
    def init(t, generator=None):
        if isinstance(generator, np.random.Generator):
            return _fill(t, generator.normal(0.0, stddev, tuple(t.shape)))
        return nn.init.normal_(t, 0.0, stddev, generator=generator)

    return init


def constant(value: float):
    """flax ``initializers.constant(value)``."""
    def init(t, generator=None):
        return nn.init.constant_(t, value)

    return init


zeros = constant(0.0)


def init_flax_(model: nn.Module, generator=None):
    """Draw every layer of ``model`` again as flax initialises it, in
    module order, from ``generator``: a CPU ``torch.Generator`` (call
    before moving the model to the card) or a ``numpy.random.Generator``
    (the same weights on every machine). Returns the model."""
    with torch.no_grad():
        for m in model.modules():
            if hasattr(m, "FLAX_KIND"):
                m.reset_parameters(generator)
    return model


class _FlaxInit(nn.Module):
    """Kernel and bias initialisers of a flax layer; ``fan_in`` is the
    kernel's flax fan-in."""

    def _set_inits(self, fan_in, kernel_init=None, bias_init=None):
        self.kernel_init = kernel_init or lecun_normal(fan_in)
        self.bias_init = bias_init or zeros

    def reset_parameters(self, generator=None):
        with torch.no_grad():
            self.kernel_init(self.weight, generator)
            if self.bias is not None:
                self.bias_init(self.bias, generator)


class Dense(_FlaxInit):
    """flax ``nn.Dense``: ``y = x @ W (+ b)`` on the last axis; fan-in
    ``in_features``."""

    FLAX_KIND = "Dense"

    def __init__(self, in_features, out_features, use_bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (
            nn.Parameter(torch.empty(out_features)) if use_bias else None
        )
        self._set_inits(in_features)
        self.reset_parameters()

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.99, epsilon=1e-3)``:
    ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32 (or
    wider: flax promotes to at least fp32), cast to the compute dtype. In
    eval mode ``mean`` / ``var`` are the running statistics. In train mode
    (``self.training``) they are the batch's, over every position of every
    axis but the channel one, padding included, as flax computes them:
    ``var = max(0, E[x²] - E[x]²)`` (biased, flax's fast variance); the
    running statistics then move to ``momentum * running + (1 - momentum)
    * batch`` with that same biased variance."""

    FLAX_KIND = "BatchNorm"
    MOMENTUM = 0.99  # every flax BatchNorm of the JAX package

    def __init__(self, num_features, eps=1e-3, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def reset_parameters(self, generator=None):
        """flax's: scale one, bias zero, mean zero, var one."""
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x, channel_dim: int = -1):
        shape = [1] * x.ndim
        shape[channel_dim] = -1
        xf = x.to(torch.promote_types(x.dtype, torch.float32))  # as flax
        if self.training:
            axes = [d for d in range(x.ndim) if d != channel_dim % x.ndim]
            mean = xf.mean(dim=axes)
            var = torch.clamp(
                (xf * xf).mean(dim=axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(
                    m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean.reshape(shape)) * mul.reshape(shape)
        y = y + self.bias.reshape(shape)
        return y.to(self.dtype)


class Conv(_FlaxInit):
    """flax ``nn.Conv`` on an NCHW (channels-last in memory) tensor;
    fan-in ``kernel * kernel * cin`` (flax's HWIO kernel)."""

    FLAX_KIND = "Conv"

    def __init__(self, cin, cout, kernel, stride=1, padding=0,
                 use_bias=True, dtype=torch.float32, kernel_init=None,
                 bias_init=None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(cout)) if use_bias else None
        self._set_inits(kernel * kernel * cin, kernel_init, bias_init)
        self.reset_parameters()

    def forward(self, x):
        w = self.weight.to(self.dtype).contiguous(
            memory_format=torch.channels_last
        )
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), w, b, self.stride, self.padding)


class ConvTranspose(_FlaxInit):
    """flax ``nn.ConvTranspose`` with kernel == stride (the only form
    BaseBEVBackbone uses; output is exactly ``stride`` times larger).
    The torch weight is (in, out, kh, kw); flax does not flip the kernel
    and torch does, so ``weights.flax_to_torch`` flips it on the way in.
    No bias (``use_bias=False`` in BaseBEVBackbone); fan-in ``stride *
    stride * cin`` (flax's (kh, kw, in, out) kernel)."""

    FLAX_KIND = "ConvTranspose"

    def __init__(self, cin, cout, stride, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, stride, stride))
        self.bias = None
        self._set_inits(stride * stride * cin)
        self.reset_parameters()

    def forward(self, x):
        w = self.weight.to(self.dtype)
        return F.conv_transpose2d(x.to(self.dtype), w, None, self.stride)
