"""Sorted-table key lookup, the neighbour table of a sparse conv with its
keys generated in the kernel, and the transposed table of a strided conv
(its data gradient's table) gathered from the same sorted keys; one
launch per table for the batch.

Replaces the TPU kernel ``de6d_tpu/ops/pallas/lookup.py:lookup_pallas``.
The CUDA kernels are ``csrc/lookup.cu``: a block takes a run of queries
(4096 consecutive queries for :func:`lookup`, 128 asking rows times the
kernel's offsets for :func:`neighbor_table`), stages the window of the
table between the lower bounds of its least and greatest query in shared
memory (a device-memory search where it does not fit), and each query
binary-searches that window. Both are bound by bytes: each input read
once, each output written once.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from . import build

INVALID = 2**31 - 1  # int32 max: the invalid-key sentinel
# the kernels' limits (csrc/lookup.cu: idx * 2 + hit fits an int32)
MAX_OFFSETS = 32
MAX_TABLE = 2**30


def _floordiv(a, b: int):
    return torch.div(a, b, rounding_mode="floor")


def coords_to_keys(coords, grid, valid=None):
    """(..., 3) zyx int coords + grid (nz, ny, nx) → (...) int32 linear
    keys; out-of-range or invalid sites → INVALID."""
    nz, ny, nx = (int(g) for g in grid)
    z, y, x = coords[..., 0], coords[..., 1], coords[..., 2]
    ok = (z >= 0) & (z < nz) & (y >= 0) & (y < ny) & (x >= 0) & (x < nx)
    if valid is not None:
        ok = ok & valid
    key = ((z * ny + y) * nx + x).to(torch.int32)
    return torch.where(ok, key, INVALID)


def keys_to_coords(keys, grid):
    """(...) keys → (..., 3) int32 zyx coords, -1 for INVALID."""
    _, ny, nx = (int(g) for g in grid)
    z = _floordiv(keys, ny * nx)
    rem = keys - z * (ny * nx)
    y = _floordiv(rem, nx)
    x = rem - y * nx
    coords = torch.stack([z, y, x], dim=-1).to(torch.int32)
    return torch.where((keys != INVALID)[..., None], coords, -1)


def kernel_offsets(kernel, device, centered=True):
    """Kernel size (kz, ky, kx) → (K, 3) int32 offsets in z-major order,
    centered for a submanifold conv, from 0 for a strided one."""
    ranges = [range(k) for k in kernel]
    offs = torch.tensor(list(itertools.product(*ranges)), dtype=torch.int32,
                        device=device).reshape(-1, 3)
    if centered:
        offs = offs - torch.tensor([k // 2 for k in kernel],
                                   dtype=torch.int32, device=device)
    return offs


def lookup_plain(keys_sorted, query_keys):
    """Plain PyTorch version: ``torch.searchsorted`` plus an equality
    test. (B, V) int32 ascending tables, (B, Q) int32 queries → idx
    (B, Q) int32 (the insertion point, clipped to V - 1) and hit (B, Q)
    bool."""
    v = keys_sorted.shape[1]
    keys_sorted = keys_sorted.contiguous()
    pos = torch.searchsorted(keys_sorted, query_keys.contiguous(),
                             out_int32=True)
    idx = torch.clamp(pos, max=v - 1)
    found = torch.gather(keys_sorted, 1, idx.long()) == query_keys
    hit = found & (pos < v) & (query_keys != INVALID)
    return idx, hit


def bytes_moved(v: int, query_keys) -> int:
    """Bytes the function must move: the queries once, (idx, hit) once,
    each sample's table once."""
    b, q = query_keys.shape
    return b * q * (4 + 4 + 1) + b * v * 4


def _check_tables(what, keys_sorted, query_keys):
    """True for CUDA tensors (the kernel), False for CPU ones (the plain
    version); raises for anything else."""
    ts, qs = keys_sorted.shape, query_keys.shape
    if len(ts) != 2 or len(qs) != 2 or ts[0] != qs[0]:
        raise ValueError(f"{what}: tables {tuple(ts)}, queries {tuple(qs)}")
    if keys_sorted.dtype != torch.int32 or query_keys.dtype != torch.int32:
        raise TypeError(f"{what}: keys must be int32")
    if keys_sorted.is_cuda and query_keys.device == keys_sorted.device:
        return True
    if keys_sorted.is_cpu and query_keys.is_cpu:
        return False
    raise ValueError(f"{what}: unsupported devices {keys_sorted.device}, "
                     f"{query_keys.device}")


def lookup(keys_sorted, query_keys):
    """(B, V) int32 key tables, ascending with an ``INVALID`` tail, and
    (B, Q) int32 queries → (idx (B, Q) int32, hit (B, Q) bool): ``hit``
    iff the query is in its sample's table and is not ``INVALID``, and
    then ``keys_sorted[b, idx] == query``; on a miss ``idx`` is the
    insertion point clipped to V - 1 (in range). V = 0 gives no hit.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    on_card = _check_tables("lookup", keys_sorted, query_keys)
    b, v = keys_sorted.shape
    q = query_keys.shape[1]
    if v == 0:
        return (query_keys.new_zeros((b, q)),
                torch.zeros((b, q), dtype=torch.bool,
                            device=keys_sorted.device))
    if not on_card:
        return lookup_plain(keys_sorted, query_keys)
    if v > MAX_TABLE:
        raise ValueError(f"lookup: table of {v} keys")
    dev = keys_sorted.device
    idx = torch.empty((b, q), dtype=torch.int32, device=dev)
    hit = torch.empty((b, q), dtype=torch.bool, device=dev)
    if b and q:
        keys_sorted = keys_sorted.contiguous()
        query_keys = query_keys.contiguous()
        build.check(build.lib().de6d_lookup(
            keys_sorted.data_ptr(), query_keys.data_ptr(), idx.data_ptr(),
            hit.data_ptr(), b, v, q,
            torch.cuda.current_stream(dev).cuda_stream), "lookup")
        lookup.launches += 1
    return idx, hit


lookup.launches = 0


@functools.lru_cache(maxsize=64)
def _geometry(grid, ask_grid, kernel, stride, padding, centered):
    """(K, the kernel's 14 geometry ints as a C array) for hashable
    tuples: neighbour k of a site at ask coords c is at c * stride -
    padding' + (k's z-major offset from 0), padding' = padding + kernel //
    2 for a centered kernel. Raises for what the kernel does not take."""
    kz, ky, kx = (int(k) for k in kernel)
    nz, ny, nx = (int(g) for g in grid)
    if kz * ky * kx > MAX_OFFSETS or min(kz, ky, kx) < 1:
        raise ValueError(f"neighbor_table: kernel {kernel} has more than "
                         f"{MAX_OFFSETS} offsets")
    if nz * ny * nx >= INVALID:
        raise ValueError(f"neighbor_table: grid {grid} too large for int32 "
                         "keys")
    pad = [int(p) + (int(k) // 2 if centered else 0)
           for p, k in zip(padding, kernel)]
    geom = (ctypes.c_int * 14)(nz, ny, nx, int(ask_grid[1]),
                               int(ask_grid[2]), kz, ky, kx,
                               *(int(s) for s in stride), *pad)
    return kz * ky * kx, geom


def neighbor_keys_plain(ask_keys, grid, ask_grid, kernel, stride=(1, 1, 1),
                        padding=(0, 0, 0), centered=True):
    """(B, Q) asking keys → (B, Q, K) int32 neighbour keys in ``grid``:
    the asking sites' coords times ``stride`` minus ``padding`` plus each
    z-major kernel offset, INVALID outside the grid or for an INVALID
    asking row."""
    dev = ask_keys.device
    coords = keys_to_coords(ask_keys, ask_grid)
    st = torch.tensor([int(s) for s in stride], dtype=torch.int32,
                      device=dev)
    pad = torch.tensor([int(p) for p in padding], dtype=torch.int32,
                       device=dev)
    nbr = (coords * st - pad)[:, :, None, :] + kernel_offsets(
        kernel, dev, centered)[None, None]
    return coords_to_keys(nbr, grid, (ask_keys != INVALID)[..., None])


def neighbor_table_plain(keys_sorted, ask_keys, grid, ask_grid, kernel,
                         stride=(1, 1, 1), padding=(0, 0, 0), centered=True):
    """Plain PyTorch version of :func:`neighbor_table`: the neighbour keys
    (:func:`neighbor_keys_plain`) and :func:`lookup_plain`."""
    nbr_keys = neighbor_keys_plain(ask_keys, grid, ask_grid, kernel, stride,
                                   padding, centered)
    b, q, k = nbr_keys.shape
    if keys_sorted.shape[1] == 0:
        return (torch.zeros((b, q, k), dtype=torch.int32,
                            device=ask_keys.device),
                torch.zeros((b, q, k), dtype=torch.bool,
                            device=ask_keys.device))
    idx, hit = lookup_plain(keys_sorted, nbr_keys.reshape(b, q * k))
    return idx.reshape(b, q, k), hit.reshape(b, q, k)


def neighbor_bytes(keys_sorted, ask_keys, k: int) -> int:
    """Bytes :func:`neighbor_table` must move: each table read once, the
    asking keys read once unless they are the table itself (a submanifold
    conv), (idx, hit) written once per (row, offset)."""
    b, v = keys_sorted.shape
    q = ask_keys.shape[1]
    same = (ask_keys.data_ptr() == keys_sorted.data_ptr()
            and ask_keys.shape == keys_sorted.shape)
    return b * v * 4 + (0 if same else b * q * 4) + b * q * k * (4 + 1)


def neighbor_table(keys_sorted, ask_keys, grid, ask_grid, kernel,
                   stride=(1, 1, 1), padding=(0, 0, 0), centered=True):
    """Neighbour table of a sparse conv: for each asking site (B, Q) int32
    keys in ``ask_grid`` (INVALID rows allowed anywhere) and each of the
    K = kz * ky * kx kernel offsets in z-major order, the site's neighbour
    at ``ask_coords * stride - padding + offset`` (offsets centered on 0
    when ``centered``) looked up in the (B, V) ascending tables of
    ``grid`` → (idx (B, Q, K) int32, hit (B, Q, K) bool), exactly as
    :func:`lookup` of those neighbour keys (INVALID outside the grid).

    CPU tensors take the plain version; CUDA tensors launch the kernel,
    which generates the neighbour keys itself.
    """
    if not _check_tables("neighbor_table", keys_sorted, ask_keys):
        return neighbor_table_plain(keys_sorted, ask_keys, grid, ask_grid,
                                    kernel, stride, padding, centered)
    b, v = keys_sorted.shape
    if v > MAX_TABLE:
        raise ValueError(f"neighbor_table: table of {v} keys")
    k, geom = _geometry(tuple(grid), tuple(ask_grid), tuple(kernel),
                        tuple(stride), tuple(padding), bool(centered))
    q = ask_keys.shape[1]
    dev = keys_sorted.device
    if v == 0:  # no table: no hit, idx 0
        return (torch.zeros((b, q, k), dtype=torch.int32, device=dev),
                torch.zeros((b, q, k), dtype=torch.bool, device=dev))
    idx = torch.empty((b, q, k), dtype=torch.int32, device=dev)
    hit = torch.empty((b, q, k), dtype=torch.bool, device=dev)
    if b and q:
        keys_sorted = keys_sorted.contiguous()
        ask_keys = ask_keys.contiguous()
        build.check(build.lib().de6d_neighbor_table(
            keys_sorted.data_ptr(), ask_keys.data_ptr(), idx.data_ptr(),
            hit.data_ptr(), b, v, q, geom,
            torch.cuda.current_stream(dev).cuda_stream),
            "neighbor_table")
        neighbor_table.launches += 1
    return idx, hit


neighbor_table.launches = 0


def transposed_keys_plain(keys_sorted, grid, out_grid, kernel, stride,
                          padding):
    """(B, V) input keys of a strided conv → (B, V, K) int32 output keys:
    input p's output site at z-major offset k (from 0) is ``(coords(p) +
    padding - d_k) / stride`` where that divides exactly on every axis and
    lies in ``out_grid``, else INVALID (and for an INVALID input row): the
    inverse of :func:`neighbor_keys_plain` with ``centered=False``."""
    dev = keys_sorted.device
    coords = keys_to_coords(keys_sorted, grid)
    st = torch.tensor([int(s) for s in stride], dtype=torch.int32,
                      device=dev)
    pad = torch.tensor([int(p) for p in padding], dtype=torch.int32,
                       device=dev)
    c = (coords + pad)[:, :, None, :] - kernel_offsets(
        kernel, dev, centered=False)[None, None]
    ok = (((c >= 0) & (torch.remainder(c, st) == 0)).all(-1)
          & (keys_sorted != INVALID)[..., None])
    return coords_to_keys(torch.div(c, st, rounding_mode="floor"), out_grid,
                          ok)


def transposed_table_plain(keys_sorted, out_keys_sorted, grid, out_grid,
                           kernel, stride, padding):
    """Plain PyTorch version of :func:`transposed_table`: the output keys
    of :func:`transposed_keys_plain` looked up by :func:`lookup_plain`."""
    keys = transposed_keys_plain(keys_sorted, grid, out_grid, kernel, stride,
                                 padding)
    b, v, k = keys.shape
    if out_keys_sorted.shape[1] == 0:
        thit = torch.zeros((b, v, k), dtype=torch.bool, device=keys.device)
        return torch.zeros_like(keys), thit, thit.any(-1)
    idx, hit = lookup_plain(out_keys_sorted, keys.reshape(b, v * k))
    thit = hit.reshape(b, v, k)
    return torch.where(thit, idx.reshape(b, v, k), 0), thit, thit.any(-1)


def transposed_bytes(keys_sorted, out_keys_sorted, k: int) -> int:
    """Bytes :func:`transposed_table` must move: both key tables read once,
    (tidx, thit) written once per (input row, offset) and tvalid once per
    input row."""
    b, v = keys_sorted.shape
    return b * v * 4 + out_keys_sorted.numel() * 4 + b * v * (k * 5 + 1)


def transposed_table(keys_sorted, out_keys_sorted, grid, out_grid, kernel,
                     stride, padding):
    """The transpose of a strided conv's neighbour table
    (:func:`neighbor_table` of ``out_keys_sorted`` asking ``keys_sorted``
    with ``centered=False``) onto its input rows, built from the geometry:
    (tidx (B, V, K) int32, thit (B, V, K) bool, tvalid (B, V) bool) with
    ``thit[b, p, k]`` iff input row p is output row q's neighbour at
    offset k (q a valid output row), then ``tidx[b, p, k] = q``, else 0;
    ``tvalid`` the rows with a hit. Equal to
    ``sparse_conv.sparse_conv_transpose_plain`` of that table when every
    key of ``keys_sorted`` occurs once (the site lists do). ``keys_sorted``
    (B, V) int32 in ``grid``, INVALID rows anywhere; ``out_keys_sorted``
    (B, Q) ascending with an INVALID tail, in ``out_grid``.

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/lookup.cu``'s ``transposed_table_kernel`` (a thread an input
    row: the offsets that divide, their output keys searched in the
    table; every entry written once, no memset), one launch counted in
    ``transposed_table.launches``."""
    if not _check_tables("transposed_table", out_keys_sorted, keys_sorted):
        return transposed_table_plain(keys_sorted, out_keys_sorted, grid,
                                      out_grid, kernel, stride, padding)
    b, q = out_keys_sorted.shape
    if q > MAX_TABLE:
        raise ValueError(f"transposed_table: table of {q} keys")
    if min(int(s) for s in stride) < 1:
        raise ValueError(f"transposed_table: stride {stride}")
    k, geom = _geometry(tuple(out_grid), tuple(grid), tuple(kernel),
                        tuple(stride), tuple(padding), False)
    v = keys_sorted.shape[1]
    dev = keys_sorted.device
    if q == 0:  # no output site: no hit, idx 0
        return (torch.zeros((b, v, k), dtype=torch.int32, device=dev),
                torch.zeros((b, v, k), dtype=torch.bool, device=dev),
                torch.zeros((b, v), dtype=torch.bool, device=dev))
    tidx = torch.empty((b, v, k), dtype=torch.int32, device=dev)
    thit = torch.empty((b, v, k), dtype=torch.bool, device=dev)
    tvalid = torch.empty((b, v), dtype=torch.bool, device=dev)
    if b and v:
        out_keys_sorted = out_keys_sorted.contiguous()
        keys_sorted = keys_sorted.contiguous()
        build.check(build.lib().de6d_transposed_table(
            out_keys_sorted.data_ptr(), keys_sorted.data_ptr(),
            tidx.data_ptr(), thit.data_ptr(), tvalid.data_ptr(), b, q, v,
            geom, torch.cuda.current_stream(dev).cuda_stream),
            "transposed_table")
        transposed_table.launches += 1
    return tidx, thit, tvalid


transposed_table.launches = 0


def empty_kernel(device, blocks: int = 1) -> None:
    """Launch an empty kernel of ``blocks`` blocks on ``device``'s current
    stream: what one launch costs, the latency floor of a short kernel.
    CUDA only; not counted."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"empty_kernel: unsupported device {dev}")
    build.check(build.lib().de6d_empty_kernel(
        int(blocks), torch.cuda.current_stream(dev).cuda_stream),
        "empty_kernel")
