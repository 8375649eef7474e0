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
    """flax ``nn.BatchNorm`` in eval mode (running statistics):
    ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in fp32, cast
    to the compute dtype. Eval only: the training slice adds the batch
    statistics."""

    FLAX_KIND = "BatchNorm"

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
        mean = self.running_mean.reshape(shape)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x.float() - mean) * mul.reshape(shape)
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
