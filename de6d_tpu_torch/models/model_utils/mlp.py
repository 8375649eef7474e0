"""Shared MLP blocks (counterpart of
``de6d_tpu/models/model_utils/mlp.py``: ``SharedMLP`` with ``folded()``,
``FCStack``). Dense + BatchNorm + ReLU stacks over the last axis; child
names follow flax's (``Dense_i``, ``BatchNorm_i``) so the flax weights
map onto them by path."""

from __future__ import annotations

import torch
from torch import nn

from .layers import BatchNorm, Dense


def _dense_bn_relu(module, x, n_layers: int, use_bn: bool, dtype):
    """The hidden stack: Dense (compute dtype) → fp32 BN → ReLU → cast."""
    x = x.to(dtype)
    for i in range(n_layers):
        x = getattr(module, f"Dense_{i}")(x)
        if use_bn:
            x = getattr(module, f"BatchNorm_{i}")(x)
        x = torch.relu(x).to(dtype)
    return x


class SharedMLP(nn.Module):
    """Dense(no bias) + BN(fp32) + ReLU per channel entry; the output
    stays in the compute dtype (it is a feature)."""

    def __init__(self, in_channels: int, channels, use_bn: bool = True,
                 dtype=torch.float32):
        super().__init__()
        self.channels = tuple(int(c) for c in channels)
        self.use_bn = use_bn
        self.dtype = dtype
        cin = int(in_channels)
        for i, c in enumerate(self.channels):
            self.add_module(f"Dense_{i}",
                            Dense(cin, c, use_bias=not use_bn, dtype=dtype))
            if use_bn:
                self.add_module(f"BatchNorm_{i}",
                                BatchNorm(c, dtype=torch.float32))
            cin = c
        self.out_channels = cin

    def forward(self, x):
        return _dense_bn_relu(self, x, len(self.channels), self.use_bn,
                              self.dtype)

    def folded(self):
        """Eval-time affine weights ``[(W (in, out), b), ...]`` in fp32:
        Dense(no bias) + BN fold into ``(W·s, β − μ·s)`` with
        ``s = γ / sqrt(σ² + 1e-3)``."""
        out = []
        for i in range(len(self.channels)):
            dense = getattr(self, f"Dense_{i}")
            w = dense.weight.float()  # (out, in)
            if self.use_bn:
                bn = getattr(self, f"BatchNorm_{i}")
                s = bn.weight.float() / torch.sqrt(bn.running_var.float()
                                                   + 1e-3)
                b = bn.bias.float() - bn.running_mean.float() * s
                w = w * s[:, None]
            else:
                b = dense.bias.float()
            out.append((w.t(), b))
        return out


class FCStack(nn.Module):
    """``fc_list`` of Dense + BN + ReLU, then a biased Dense to
    ``output_channels`` that always runs in fp32 (raw predictions feed
    decode and NMS)."""

    def __init__(self, in_channels: int, fc_list, output_channels: int,
                 use_bn: bool = True, dtype=torch.float32):
        super().__init__()
        self.fc_list = tuple(int(c) for c in fc_list)
        self.use_bn = use_bn
        self.dtype = dtype
        cin = int(in_channels)
        for i, c in enumerate(self.fc_list):
            self.add_module(f"Dense_{i}",
                            Dense(cin, c, use_bias=not use_bn, dtype=dtype))
            if use_bn:
                self.add_module(f"BatchNorm_{i}",
                                BatchNorm(c, dtype=torch.float32))
            cin = c
        self.add_module(f"Dense_{len(self.fc_list)}",
                        Dense(cin, int(output_channels)))

    def forward(self, x):
        x = _dense_bn_relu(self, x, len(self.fc_list), self.use_bn,
                           self.dtype)
        return getattr(self, f"Dense_{len(self.fc_list)}")(x.float())
