"""Fixed-shape device voxelization and sorted-segment reductions
(counterpart of ``de6d_tpu/ops/voxelize.py``: ``voxelize``,
``compute_voxel_coords``, ``stable_cell_sort``, ``sorted_segment_sum``,
``sorted_segment_max``).

Batched over a leading B axis; every output equals the JAX function's
(vmapped over B) bit for bit. Voxel slots are assigned in ascending
linear-cell-key order with the unused slots as a tail; when a scan has
more than ``max_voxels`` voxels the LARGEST keys are dropped. Voxel
coords are (z, y, x). ``voxelize`` does not build the ``(V, P, C)``
voxel buffer: the fused pillar VFE reads the sorted point stream, and a
VFE that reads the buffer (``MeanVFE``) builds it with
:func:`voxel_buffer` from the sorted-order metadata.
"""

from __future__ import annotations

import numpy as np
import torch

BIG = 2**31 - 1  # int32 max: the invalid-key sentinel


def compute_voxel_coords(points, pc_range, voxel_size):
    """(..., N, 3+) points → (..., N, 3) int32 (x, y, z) cell indices
    plus the in-range mask. Under ``jit`` XLA turns the JAX function's
    division by the constant voxel size into a product with its fp32
    reciprocal, which floors differently at a cell boundary (a KITTI
    point at x = 14.099999 lands in cell 282 of 0.05 m, not 281); the
    port computes what the jitted JAX model computes."""
    lo = torch.tensor(pc_range[0:3], dtype=points.dtype, device=points.device)
    hi = torch.tensor(pc_range[3:6], dtype=points.dtype, device=points.device)
    vs = torch.tensor(voxel_size, dtype=points.dtype, device=points.device)
    ijk = torch.floor((points[..., :3] - lo) * torch.reciprocal(vs)).to(
        torch.int32)
    grid = torch.floor((hi - lo) / vs + 0.5).to(torch.int32)
    in_range = torch.all((ijk >= 0) & (ijk < grid), dim=-1)
    return ijk, in_range, grid


def grid_cells(pc_range, voxel_size) -> int:
    """Static cell count of the grid (float64 host arithmetic, as the
    JAX package's ``_stable_key_sort``)."""
    lo = np.asarray(pc_range[0:3], np.float64)
    hi = np.asarray(pc_range[3:6], np.float64)
    vs = np.asarray(voxel_size, np.float64)
    grid = np.floor((hi - lo) / vs + 0.5).astype(np.int64)
    return int(grid[0] * grid[1] * grid[2])


def stable_cell_sort(key, ok, n_cells: int):
    """Stable ``(order, sorted_keys)`` of (..., N) int32 cell keys, with
    invalid entries (``~ok``) last and reported as ``BIG``.

    The JAX function sorts ``(key << idx_bits) | idx`` packed into one
    uint32 (18 + 14 bits at KITTI size). Here the same packed value is
    sorted as int64, which always fits; the packed values are unique,
    so the order is the stable order.
    """
    n = key.shape[-1]
    idx_bits = max(1, (n - 1).bit_length())
    k64 = torch.where(ok, key.to(torch.int64), n_cells)
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    packed, _ = torch.sort((k64 << idx_bits) | idx, dim=-1)
    order = (packed & ((1 << idx_bits) - 1)).to(torch.int32)
    sk = packed >> idx_bits
    sorted_keys = torch.where(sk == n_cells, BIG, sk).to(torch.int32)
    return order, sorted_keys


def _scatter_drop(size: int, index, src, fill):
    """``full((..., size), fill).at[index].set(src, mode="drop")`` along
    the last axis (``fill`` a scalar or a (..., 1) tensor): out-of-range
    indices land in a trash slot."""
    shape = (*index.shape[:-1], size + 1)
    out = torch.empty(shape, dtype=src.dtype, device=src.device)
    out.copy_(torch.as_tensor(fill, dtype=src.dtype, device=src.device)
              .expand(shape))
    safe = torch.where((index >= 0) & (index < size), index, size)
    out.scatter_(-1, safe.to(torch.int64), src)
    return out[..., :size]


def voxelize(points, valid_mask, pc_range, voxel_size,
             max_voxels: int, max_points_per_voxel: int):
    """Hard voxelization with fixed-size outputs.

    Args:
        points: (B, N, 3+C) float.
        valid_mask: (B, N) bool.

    Returns dict of (B, ...) tensors: ``voxel_coords`` (V, 3) int32
    zyx (-1 for empty slots), ``voxel_num_points`` (V,) capped counts,
    ``num_voxels`` (), ``point_voxel_idx`` (N,) slot per point (-1 =
    dropped), and the sorted-order metadata ``order``, ``sorted_slot``,
    ``sorted_rank``, ``voxel_starts``.
    """
    pc_range = tuple(float(x) for x in pc_range)
    voxel_size = tuple(float(x) for x in voxel_size)
    n = points.shape[-2]
    v, p = int(max_voxels), int(max_points_per_voxel)
    dev = points.device
    i32 = torch.int32

    ijk, in_range, grid = compute_voxel_coords(points, pc_range, voxel_size)
    ok = in_range & valid_mask
    key = (ijk[..., 2] * grid[1] + ijk[..., 1]) * grid[0] + ijk[..., 0]
    order, sorted_keys = stable_cell_sort(
        key, ok, grid_cells(pc_range, voxel_size)
    )

    pos = torch.arange(n, dtype=i32, device=dev).expand_as(sorted_keys)
    first = sorted_keys[..., :1] != BIG
    is_start = torch.cat(
        [first, sorted_keys[..., 1:] != sorted_keys[..., :-1]], dim=-1
    ) & (sorted_keys != BIG)
    slot_sorted = (torch.cumsum(is_start.to(i32), dim=-1) - 1).to(i32)
    slot = torch.zeros_like(slot_sorted).scatter_(
        -1, order.to(torch.int64), slot_sorted
    )

    num_voxels = torch.clamp(is_start.to(i32).sum(-1), max=v).to(i32)
    uniq = _scatter_drop(
        v,
        torch.where(is_start, slot_sorted, v),
        torch.where(is_start, sorted_keys, BIG),
        BIG,
    )

    n_valid = ok.to(i32).sum(-1, keepdim=True)
    # starts_ext[s]: sorted position where voxel s begins; index v takes
    # the first overflowed voxel's start so the last kept count closes
    starts_ext = _scatter_drop(
        v + 1, torch.where(is_start, slot_sorted, v + 1), pos, n_valid
    )
    starts = starts_ext[..., :v]
    counts = torch.clamp(starts_ext[..., 1:] - starts, min=0)
    counts = torch.clamp(counts, max=p).to(i32)

    slot_ok = ok & (slot >= 0) & (slot < v)

    kz = torch.div(uniq, grid[1] * grid[0], rounding_mode="floor")
    rem = uniq - kz * grid[1] * grid[0]
    ky = torch.div(rem, grid[0], rounding_mode="floor")
    kx = rem - ky * grid[0]
    coords = torch.stack([kz, ky, kx], dim=-1).to(i32)
    coords = torch.where((uniq != BIG)[..., None], coords, -1)

    point_voxel_idx = torch.where(slot_ok, slot, -1).to(i32)
    starts_at = torch.gather(
        starts, -1, torch.clamp(slot_sorted, 0, v - 1).to(torch.int64)
    )
    rank_sorted = (pos - starts_at).to(i32)
    sorted_valid = (sorted_keys != BIG) & (slot_sorted >= 0) & (
        slot_sorted < v
    )
    return {
        "voxel_coords": coords,
        "voxel_num_points": counts,
        "num_voxels": num_voxels,
        "point_voxel_idx": point_voxel_idx,
        "order": order,
        "sorted_slot": torch.where(sorted_valid, slot_sorted, -1).to(i32),
        "sorted_rank": rank_sorted,
        "voxel_starts": starts.to(i32),
    }


def voxel_buffer(points, order, starts, counts, p: int):
    """The per-voxel point buffer ``voxels`` (B, V, P, C) of the JAX
    ``voxelize``: voxel v holds the sorted points ``starts[v] + (0..P-1)``
    (``order`` sorts the points by cell), rows past ``counts[v]`` zero."""
    n = points.shape[-2]
    c = points.shape[-1]
    pts_sorted = torch.gather(
        points, -2, order.long()[..., None].expand(*order.shape, c))
    ar = torch.arange(p, dtype=torch.int32, device=points.device)
    gather_idx = torch.clamp(starts[..., None] + ar, 0, n - 1).long()
    b, v = starts.shape
    rows = torch.gather(
        pts_sorted, -2, gather_idx.reshape(b, v * p, 1).expand(-1, -1, c)
    ).reshape(b, v, p, c)
    in_voxel = ar < counts[..., None]
    return torch.where(in_voxel[..., None], rows, 0.0).to(points.dtype)


def _segmented_prefix(values, ids, op, identity, window):
    """Hillis-Steele segmented inclusive prefix along dim -2 with
    contiguous shifts (the JAX package's ``_segmented_prefix``): after
    ceil(log2(window)) doubling passes row i holds ``op`` over the last
    min(depth, 2**passes) rows of its segment. The same passes in the
    same order give the same fp32 sums as the JAX function."""
    n = values.shape[-2]
    x = values
    passes = max(1, int(np.ceil(np.log2(max(2, window)))))
    for k in range(passes):
        sh = 1 << k
        if sh >= n:
            break
        pad_v = torch.full_like(x[..., :sh, :], identity)
        x_sh = torch.cat([pad_v, x[..., :-sh, :]], dim=-2)
        ids_sh = torch.cat(
            [torch.full_like(ids[..., :sh], -1), ids[..., :-sh]], dim=-1
        )
        same = (ids_sh == ids)[..., None]
        x = torch.where(same, op(x, x_sh), x)
    return x


def _gather_segment_ends(scanned, starts, counts, fill):
    n = scanned.shape[-2]
    ends = torch.clamp(starts + counts - 1, 0, n - 1).to(torch.int64)
    out = torch.gather(
        scanned, -2, ends[..., None].expand(*ends.shape, scanned.shape[-1])
    )
    return torch.where((counts > 0)[..., None], out, fill)


def sorted_segment_sum(values, ids, starts, counts, window=32):
    """Segment sums over a SORTED id stream: (..., N, C) values, (..., N)
    ids (-1 tail ok) → (..., V, C); segment v's window is
    [starts[v], starts[v] + counts[v]) with counts <= window."""
    scanned = _segmented_prefix(values, ids, torch.add, 0.0, window)
    return _gather_segment_ends(scanned, starts, counts, 0.0)


def sorted_segment_max(values, ids, starts, counts, fill=0.0, window=32):
    """Segmented max over a SORTED id stream; empty segments → ``fill``."""
    neg = torch.finfo(values.dtype).min
    scanned = _segmented_prefix(values, ids, torch.maximum, neg, window)
    return _gather_segment_ends(scanned, starts, counts, fill)
