"""Sparse voxel backbones (counterpart of
``de6d_tpu/models/backbones_3d/spconv_backbone.py``): ``VoxelBackBone8x``
(submanifold and strided sparse convs, 8x downsampling, a final (3, 1, 1)
z-strided conv to ``encoded_spconv_tensor``) and ``VoxelResBackBone8x``
(the residual ``SparseBasicBlock`` variant).

Every sample keeps a static-capacity site list sorted by key; each stage
builds its submanifold neighbour table once (one lookup launch) and every
conv layer is one launch of the gather-GEMM kernel for the whole batch.
In train mode (``self.training``) the convolutions backpropagate (their
data gradient on the same kernel, their weight gradient on its own) and
``MaskedBatchNorm`` takes the batch's statistics over the sites. Module
and parameter names follow the flax modules so that
``weights.flax_to_torch`` carries the trained variables across.
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops import sparse
from ...registry import BACKBONES_3D
from ..model_utils.dtype_utils import compute_dtype
from ..model_utils.layers import BatchNorm, normal


class MaskedBatchNorm(BatchNorm):
    """flax ``MaskedBatchNorm``: :class:`BatchNorm`'s parameters and
    statistics, zero outside ``mask``, cast back to the input's dtype. In
    train mode (``self.training``) the statistics are the batch's over
    the masked rows only (every sample), in fp32: ``cnt = max(Σ mask,
    1)``, the mean, and the two-pass variance ``Σ mask (x - mean)² / cnt``
    (not :class:`BatchNorm`'s ``E[x²] - E[x]²``); the running statistics
    move to ``0.99 · running + 0.01 · batch``. It multiplies in the flax
    module's order, ``(x - mean) * rsqrt(var + eps)`` and then ``* scale
    + bias``, which rounds otherwise than ``BatchNorm``'s ``rsqrt(var +
    eps) * scale``."""

    def forward(self, x, mask):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            w = mask.to(xf.dtype)[..., None]
            axes = tuple(range(x.ndim - 1))
            cnt = torch.clamp(w.sum(), min=1.0)
            mean = (xf * w).sum(dim=axes) / cnt
            var = (w * (xf - mean) ** 2).sum(dim=axes) / cnt
            with torch.no_grad():
                m = self.MOMENTUM
                self.running_mean.copy_(
                    m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return torch.where(mask[..., None], y, 0.0).to(x.dtype)


class _SparseConv(nn.Module):
    """A sparse conv's (K, Cin, Cout) kernel (flax param ``kernel``, same
    layout) and its ``MaskedBatchNorm_0``."""

    FLAX_KIND = "SparseConv"

    def __init__(self, cin, cout, kernel):
        super().__init__()
        k3 = kernel[0] * kernel[1] * kernel[2]
        self.weight = nn.Parameter(torch.empty(k3, cin, cout))
        self.bias = None
        self.MaskedBatchNorm_0 = MaskedBatchNorm(cout)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        """flax's ``variance_scaling(1, "fan_in", "normal")``: fan-in
        ``k3 * cin``, not truncated."""
        k3, cin, _ = self.weight.shape
        with torch.no_grad():
            normal((k3 * cin) ** -0.5)(self.weight, generator)


class SubMConvLayer(_SparseConv):
    """Submanifold conv + masked BN (+ ReLU) on a stage's shared
    neighbour table."""

    def __init__(self, cin, cout, kernel=(3, 3, 3), use_relu=True):
        super().__init__(cin, cout, kernel)
        self.use_relu = use_relu

    def forward(self, feats, keys, table):
        mask = keys != sparse.INVALID
        out = sparse.subm_conv_table(feats, table[0], table[1],
                                     self.weight.to(feats.dtype), mask)
        out = self.MaskedBatchNorm_0(out, mask)
        return torch.relu(out) if self.use_relu else out


class SparseDownLayer(_SparseConv):
    """Strided sparse conv onto the active output sites + masked BN +
    ReLU."""

    def __init__(self, cin, cout, kernel=(3, 3, 3), stride=(2, 2, 2),
                 padding=(1, 1, 1)):
        super().__init__(cin, cout, kernel)
        self.kernel, self.stride, self.padding = kernel, stride, padding

    def forward(self, feats, keys, grid, max_out: int):
        """Returns (out_feats (B, Q, Cout), out_keys (B, Q), out_grid)."""
        out_keys, out_grid = sparse.downsample_coords(
            keys, grid, self.stride, self.padding, max_out, self.kernel)
        out = sparse.strided_conv(
            feats, keys, grid, self.weight.to(feats.dtype), self.kernel,
            self.stride, self.padding, out_keys, out_grid)
        out = self.MaskedBatchNorm_0(out, out_keys != sparse.INVALID)
        return torch.relu(out), out_keys, out_grid


class SparseBasicBlock(nn.Module):
    """Residual block of two submanifold convs."""

    def __init__(self, channels):
        super().__init__()
        self.SubMConvLayer_0 = SubMConvLayer(channels, channels)
        self.SubMConvLayer_1 = SubMConvLayer(channels, channels,
                                             use_relu=False)

    def forward(self, feats, keys, table):
        out = self.SubMConvLayer_0(feats, keys, table)
        out = self.SubMConvLayer_1(out, keys, table)
        return torch.relu(out + feats)


class _VoxelBackboneBase(nn.Module):
    residual = False

    def __init__(self, model_cfg, input_channels, grid_size, **kwargs):
        super().__init__()
        self.model_cfg = model_cfg
        self.dtype = compute_dtype(model_cfg)
        nx, ny, nz = (int(g) for g in grid_size)
        self.grid = (nz + 1, ny, nx)  # +1 z pad (reference sparse_shape)
        nf = list(model_cfg.get("NUM_FILTERS", [16, 16, 32, 64, 64]))
        out_ch = int(model_cfg.get("OUT_CHANNELS", 128))
        # flax numbers children per class in call order
        n_subm, n_block = [0], [0]

        def subm(cin, cout):
            name = f"SubMConvLayer_{n_subm[0]}"
            n_subm[0] += 1
            self.add_module(name, SubMConvLayer(cin, cout))
            return name

        def stage(cin, channels, n_blocks):
            names = []
            for _ in range(n_blocks):
                if self.residual:
                    name = f"SparseBasicBlock_{n_block[0]}"
                    n_block[0] += 1
                    self.add_module(name, SparseBasicBlock(channels))
                    names.append(name)
                else:
                    names.append(subm(cin, channels))
                cin = channels
            return names

        # channels of multi_scale_3d_features, for PV-RCNN's set abstraction
        self.multi_scale_channels = {f"x_conv{s + 1}": nf[s + 1]
                                     for s in range(4)}
        self.conv_input = subm(input_channels, nf[0])
        self.stages = [stage(nf[0], nf[1], 1), stage(nf[2], nf[2], 2),
                       stage(nf[3], nf[3], 2), stage(nf[4], nf[4], 2)]
        self.SparseDownLayer_0 = SparseDownLayer(nf[1], nf[2])
        self.SparseDownLayer_1 = SparseDownLayer(nf[2], nf[3])
        self.SparseDownLayer_2 = SparseDownLayer(nf[3], nf[4],
                                                 padding=(0, 1, 1))
        self.SparseDownLayer_3 = SparseDownLayer(
            nf[4], out_ch, kernel=(3, 1, 1), stride=(2, 1, 1),
            padding=(0, 0, 0))

    def forward(self, batch_dict):
        feats = batch_dict["voxel_features"]  # (B, V, C)
        coords = batch_dict["voxel_coords"]  # (B, V, 3) zyx
        grid = self.grid
        v = feats.shape[1]
        keys = sparse.coords_to_keys(coords, grid, coords[..., 0] >= 0)
        feats, keys = sparse.sort_sparse(feats, keys)
        x = feats.to(self.dtype)
        caps = list(self.model_cfg.get("MAX_VOXELS_PER_STAGE",
                                       [v, v, v // 2, v // 4]))
        downs = (self.SparseDownLayer_0, self.SparseDownLayer_1,
                 self.SparseDownLayer_2)
        ms = {}
        for s, names in enumerate(self.stages):
            if s == 0:
                table = sparse.subm_neighbor_table(keys, grid)
                x = getattr(self, self.conv_input)(x, keys, table)
            else:
                x, keys, grid = downs[s - 1](x, keys, grid, int(caps[s]))
                table = sparse.subm_neighbor_table(keys, grid)
            for name in names:
                x = getattr(self, name)(x, keys, table)
            ms[f"x_conv{s + 1}"] = (x, keys, grid)
        x, keys, grid = self.SparseDownLayer_3(x, keys, grid, int(caps[3]))
        batch_dict["encoded_spconv_tensor"] = sparse.to_dense(
            x, keys, grid).float()  # (B, nz, ny, nx, C)
        batch_dict["encoded_spconv_keys"] = keys
        batch_dict["encoded_spconv_tensor_stride"] = 8
        batch_dict["multi_scale_3d_features"] = ms
        batch_dict["multi_scale_3d_strides"] = {
            "x_conv1": 1, "x_conv2": 2, "x_conv3": 4, "x_conv4": 8,
        }
        return batch_dict


@BACKBONES_3D.register
class VoxelBackBone8x(_VoxelBackboneBase):
    residual = False


@BACKBONES_3D.register
class VoxelResBackBone8x(_VoxelBackboneBase):
    residual = True
