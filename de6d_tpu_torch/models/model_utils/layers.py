"""Parameter-holding layers with the JAX package's (flax) arithmetic.

Parameters are fp32; each layer casts its input and weights to the
module's compute dtype at use, as flax's ``dtype=`` does. Each class
names its flax counterpart in ``FLAX_KIND`` so ``weights.flax_to_torch``
knows how to carry a flax kernel across.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Module):
    """flax ``nn.Dense``: ``y = x @ W (+ b)`` on the last axis."""

    FLAX_KIND = "Dense"

    def __init__(self, in_features, out_features, use_bias=True,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = (
            nn.Parameter(torch.zeros(out_features)) if use_bias else None
        )
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

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


class Conv(nn.Module):
    """flax ``nn.Conv`` on an NCHW (channels-last in memory) tensor."""

    FLAX_KIND = "Conv"

    def __init__(self, cin, cout, kernel, stride=1, padding=0,
                 use_bias=True, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if use_bias else None
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        w = self.weight.to(self.dtype).contiguous(
            memory_format=torch.channels_last
        )
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), w, b, self.stride, self.padding)


class ConvTranspose(nn.Module):
    """flax ``nn.ConvTranspose`` with kernel == stride (the only form
    BaseBEVBackbone uses; output is exactly ``stride`` times larger).
    The torch weight is (in, out, kh, kw); flax does not flip the kernel
    and torch does, so ``weights.flax_to_torch`` flips it on the way in."""

    FLAX_KIND = "ConvTranspose"

    def __init__(self, cin, cout, stride, dtype=torch.float32):
        super().__init__()
        self.stride = stride
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cin, cout, stride, stride))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x):
        w = self.weight.to(self.dtype)
        return F.conv_transpose2d(x.to(self.dtype), w, None, self.stride)
