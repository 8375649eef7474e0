"""Sorted-table key lookup, one launch per table for the whole batch.

Replaces the TPU kernel ``de6d_tpu/ops/pallas/lookup.py:lookup_pallas``.
The CUDA kernel is ``csrc/lookup.cu``: a block stages its sample's key
table in shared memory (a global-memory search where the table does not
fit) and each thread binary-searches its queries. Bound by bytes: each
query read once, (idx, hit) written once.
"""

from __future__ import annotations

import torch

from . import build

INVALID = 2**31 - 1  # int32 max: the invalid-key sentinel


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


def lookup(keys_sorted, query_keys):
    """(B, V) int32 key tables, ascending with an ``INVALID`` tail, and
    (B, Q) int32 queries → (idx (B, Q) int32, hit (B, Q) bool): ``hit``
    iff the query is in its sample's table and is not ``INVALID``, and
    then ``keys_sorted[b, idx] == query``; on a miss ``idx`` is the
    insertion point clipped to V - 1 (in range). V = 0 gives no hit.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if keys_sorted.dim() != 2 or query_keys.dim() != 2 or (
            keys_sorted.shape[0] != query_keys.shape[0]):
        raise ValueError(f"lookup: tables {tuple(keys_sorted.shape)}, "
                         f"queries {tuple(query_keys.shape)}")
    if keys_sorted.dtype != torch.int32 or query_keys.dtype != torch.int32:
        raise TypeError("lookup: keys must be int32")
    b, v = keys_sorted.shape
    q = query_keys.shape[1]
    dev = keys_sorted.device
    if v == 0:
        return (torch.zeros((b, q), dtype=torch.int32, device=dev),
                torch.zeros((b, q), dtype=torch.bool, device=dev))
    if dev.type == "cpu" and query_keys.device.type == "cpu":
        return lookup_plain(keys_sorted, query_keys)
    if dev.type != "cuda" or query_keys.device != dev:
        raise ValueError(f"lookup: unsupported devices {dev}, "
                         f"{query_keys.device}")
    idx = torch.empty((b, q), dtype=torch.int32, device=dev)
    hit = torch.empty((b, q), dtype=torch.bool, device=dev)
    if b == 0 or q == 0:
        return idx, hit
    keys_sorted = keys_sorted.contiguous()
    query_keys = query_keys.contiguous()
    err = build.lib().de6d_lookup(
        keys_sorted.data_ptr(), query_keys.data_ptr(), idx.data_ptr(),
        hit.data_ptr(), b, v, q, torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "lookup")
    lookup.launches += 1
    return idx, hit


lookup.launches = 0
