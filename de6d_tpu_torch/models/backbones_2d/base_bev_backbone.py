"""2D BEV backbone (counterpart of
``de6d_tpu/models/backbones_2d/base_bev_backbone.py``): downsampling
blocks of (stride-S 3x3 conv + [3x3 conv] x L), each followed by a
transposed-conv upsample, multi-scale concat.

The NHWC canvas becomes a channels-last NCHW tensor with
``permute(0, 3, 1, 2)`` (no copy); the output goes back to NHWC the same
way. Convolutions run on cuDNN, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import torch
from torch import nn

from ...registry import BACKBONES_2D
from ..model_utils.dtype_utils import compute_dtype
from ..model_utils.layers import BatchNorm, Conv, ConvTranspose


class ConvBlock(nn.Module):
    def __init__(self, cin, channels, stride, num_layers, dtype):
        super().__init__()
        self.n = num_layers + 1
        for k in range(self.n):
            self.add_module(f"Conv_{k}", Conv(
                cin if k == 0 else channels, channels, 3,
                stride=stride if k == 0 else 1, padding=1, use_bias=False,
                dtype=dtype,
            ))
            self.add_module(f"BatchNorm_{k}", BatchNorm(channels, dtype=dtype))

    def forward(self, x):
        for k in range(self.n):
            x = getattr(self, f"Conv_{k}")(x)
            x = torch.relu(getattr(self, f"BatchNorm_{k}")(x, channel_dim=1))
        return x


@BACKBONES_2D.register
class BaseBEVBackbone(nn.Module):
    """One upsample (ConvTranspose, stride >= 1) per block, as every
    shipped config has; the JAX module's fractional-stride and extra
    final upsample are not ported (no config uses them)."""

    def __init__(self, model_cfg, input_channels):
        super().__init__()
        self.model_cfg = model_cfg
        dt = compute_dtype(model_cfg)
        self.dtype = dt
        layer_nums = list(model_cfg.get("LAYER_NUMS", []))
        strides = list(model_cfg.get("LAYER_STRIDES", []))
        filters = list(model_cfg.get("NUM_FILTERS", []))
        up_strides = list(model_cfg.get("UPSAMPLE_STRIDES", []))
        up_filters = list(model_cfg.get("NUM_UPSAMPLE_FILTERS", []))
        if len(up_strides) != len(layer_nums) or min(up_strides, default=1) < 1:
            raise ValueError(
                f"BaseBEVBackbone: UPSAMPLE_STRIDES {up_strides} must give "
                f"one stride >= 1 per block ({len(layer_nums)} blocks)"
            )
        self.n_blocks = len(layer_nums)
        # flax numbers auto-named children per class in call order
        cin = input_channels
        for i in range(self.n_blocks):
            self.add_module(f"ConvBlock_{i}", ConvBlock(
                cin, filters[i], strides[i], layer_nums[i], dt
            ))
            cin = filters[i]
            self.add_module(f"ConvTranspose_{i}", ConvTranspose(
                cin, up_filters[i], int(up_strides[i]), dtype=dt
            ))
            self.add_module(f"BatchNorm_{i}", BatchNorm(up_filters[i], dtype=dt))

    @property
    def num_bev_features(self):
        return sum(int(u) for u in self.model_cfg["NUM_UPSAMPLE_FILTERS"])

    def forward(self, batch_dict):
        # (B, ny, nx, C) -> channels-last NCHW view
        x = batch_dict["spatial_features"].to(self.dtype).permute(0, 3, 1, 2)
        ups = []
        for i in range(self.n_blocks):
            x = getattr(self, f"ConvBlock_{i}")(x)
            u = getattr(self, f"ConvTranspose_{i}")(x)
            u = getattr(self, f"BatchNorm_{i}")(u, channel_dim=1)
            ups.append(torch.relu(u))
        x = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        batch_dict["spatial_features_2d"] = x.permute(0, 2, 3, 1)  # NHWC
        return batch_dict
