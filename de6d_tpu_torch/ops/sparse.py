"""Sparse 3D convolution over key-sorted site lists (counterpart of
``de6d_tpu/ops/sparse.py``), with the batch axis written out.

A sparse tensor is (features (B, V, C), keys (B, V)) with a static
capacity V: ``keys`` are z-major linear coordinates sorted ascending per
sample, ``INVALID`` (int32 max) for empty slots. Neighbour lookup is a
search in the sorted table (``ops/kernels/lookup.py``); every
convolution, submanifold or strided, is a gather-GEMM from a neighbour
table (``ops/kernels/sparse_conv.py``, differentiable in the features
and the weights); both tables come from one neighbour-table launch that
generates the neighbour keys itself. Every function returns what the JAX
function returns, vmapped over B, and its gradient what ``jax.grad``
gives. The convolutions tell the kernel how their data gradient gets
the table's transpose: a submanifold table through its mirrored offsets,
a strided layer's from its geometry (``sparse_conv.Submanifold`` /
``Strided``).
"""

from __future__ import annotations

import torch

from .kernels.lookup import (  # noqa: F401  (the JAX API)
    INVALID, _floordiv, coords_to_keys, keys_to_coords, lookup,
    neighbor_table,
)
from .kernels.sparse_conv import Strided, Submanifold, sparse_conv


def sort_sparse(features, keys):
    """Sort each sample's sites by key ascending (INVALID last, stable)."""
    order = torch.sort(keys, dim=-1, stable=True)[1]
    feats = torch.gather(
        features, 1, order[..., None].expand(-1, -1, features.shape[-1])
    )
    return feats, torch.gather(keys, 1, order)


def subm_neighbor_table(keys_sorted, grid, kernel=(3, 3, 3), valid=None):
    """(idx (B, V, K), hit (B, V, K)) neighbour table of a submanifold
    conv; it depends only on the key set, so a stage builds it once.
    ``hit`` holds only on ``valid`` rows (every non-INVALID key by
    default)."""
    ask = keys_sorted if valid is None else torch.where(
        valid, keys_sorted, INVALID)
    return neighbor_table(keys_sorted, ask, grid, grid, kernel)


def subm_conv_table(features, table_idx, table_hit, weights, valid):
    """Submanifold conv from a stage's table: features (B, V, Cin), the
    :func:`subm_neighbor_table` of the sites (B, V, K) for a centred
    kernel with every site asking, weights (K, Cin, Cout), valid (B, V) =
    the sites → (B, V, Cout). Such a table is its own transpose through
    the mirrored offsets, so on the card the data gradient runs on it as
    it is (``sparse_conv.Submanifold``; raises for an even K or a table
    that is not square, and for rows that break the contract: on CPU
    tensors here, on the card at a later ``sparse_conv_dgrad`` or
    ``sparse_conv.raise_mirror_fault``)."""
    return sparse_conv(features, table_idx, table_hit, weights, valid,
                       transpose=Submanifold())


def downsample_coords(keys_sorted, grid, stride, padding, max_out: int,
                      kernel=(3, 3, 3)):
    """Active outputs of a strided conv: an output site is active iff any
    input lies in its receptive field (the spconv rule). Returns
    (out_keys_sorted (B, max_out), out_grid)."""
    (sz, sy, sx), (pz, py, px), (kz, ky, kx) = stride, padding, kernel
    nz, ny, nx = (int(g) for g in grid)
    out_grid = (
        (nz + 2 * pz - kz) // sz + 1,
        (ny + 2 * py - ky) // sy + 1,
        (nx + 2 * px - kx) // sx + 1,
    )
    coords = keys_to_coords(keys_sorted, grid)
    valid = keys_sorted != INVALID

    def axis_candidates(p, pad, k, s, n_out):
        lo = -_floordiv(-(p + pad - k + 1), s)  # ceil division
        hi = _floordiv(p + pad, s)
        n_cand = -(-k // s)
        cand = lo[..., None] + torch.arange(n_cand, dtype=torch.int32,
                                            device=p.device)
        ok = (cand >= torch.clamp(lo, min=0)[..., None]) & (
            cand <= torch.clamp(hi, max=n_out - 1)[..., None])
        return cand, ok  # (B, V, n_cand)

    cz, okz = axis_candidates(coords[..., 0], pz, kz, sz, out_grid[0])
    cy, oky = axis_candidates(coords[..., 1], py, ky, sy, out_grid[1])
    cx, okx = axis_candidates(coords[..., 2], px, kx, sx, out_grid[2])
    ok = (okz[..., :, None, None] & oky[..., None, :, None]
          & okx[..., None, None, :] & valid[..., None, None, None])
    keys = ((cz[..., :, None, None] * out_grid[1] + cy[..., None, :, None])
            * out_grid[2] + cx[..., None, None, :]).to(torch.int32)
    keys = torch.where(ok, keys, INVALID).reshape(keys_sorted.shape[0], -1)
    return unique_keys(keys, max_out), out_grid


def strided_neighbor_table(keys_sorted, out_keys_sorted, grid, out_grid,
                           kernel, stride, padding):
    """(idx (B, Q, K), hit (B, Q, K)): for each output site of a strided
    conv and kernel offset, its input row."""
    return neighbor_table(keys_sorted, out_keys_sorted, grid, out_grid,
                          kernel, stride, padding, centered=False)


def strided_conv(features, keys_sorted, grid, weights, kernel, stride,
                 padding, out_keys_sorted, out_grid):
    """Strided sparse conv onto precomputed output sites:
    ``out[o] = Σ_k W_k · in[o * stride − pad + k]``. Its data gradient
    runs on the transposed table built from the same geometry
    (``sparse_conv.Strided``, ``lookup.transposed_table``)."""
    idx, hit = strided_neighbor_table(keys_sorted, out_keys_sorted, grid,
                                      out_grid, kernel, stride, padding)
    geometry = Strided(keys_sorted, out_keys_sorted, tuple(grid),
                       tuple(out_grid), tuple(kernel), tuple(stride),
                       tuple(padding))
    return sparse_conv(features, idx, hit, weights,
                       out_keys_sorted != INVALID, transpose=geometry)


def unique_keys(keys, size: int):
    """(B, N) keys → (B, size) ascending unique keys with INVALID fill,
    as ``jnp.unique(keys, size=size, fill_value=INVALID)`` per row."""
    sk = torch.sort(keys, dim=-1)[0]
    first = torch.ones_like(sk, dtype=torch.bool)
    first[:, 1:] = sk[:, 1:] != sk[:, :-1]
    # later duplicates become INVALID, which sorts after every key
    out = torch.sort(torch.where(first, sk, INVALID), dim=-1)[0][
        :, :size].contiguous()
    if size > out.shape[1]:
        out = torch.cat([out, out.new_full(
            (out.shape[0], size - out.shape[1]), INVALID)], dim=1)
    return out


def to_dense(features, keys_sorted, grid):
    """(B, V, C) sparse → (B, nz, ny, nx, C) dense volume (zeros where no
    site)."""
    nz, ny, nx = (int(g) for g in grid)
    b, _, c = features.shape
    g = nz * ny * nx
    valid = keys_sorted != INVALID
    rows = torch.where(valid, keys_sorted.long(), g)
    rows = rows + (g + 1) * torch.arange(b, device=rows.device)[:, None]
    dense = features.new_zeros((b * (g + 1), c))
    dense.index_copy_(0, rows.reshape(-1), torch.where(
        valid[..., None], features, 0.0).reshape(-1, c))
    return dense.reshape(b, g + 1, c)[:, :g].reshape(b, nz, ny, nx, c)
