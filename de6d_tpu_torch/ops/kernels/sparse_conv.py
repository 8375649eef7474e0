"""Sparse 3D convolution from a neighbour table: a gather-GEMM in one
launch per layer for the whole batch.

Replaces the TPU kernel ``de6d_tpu/ops/pallas/sparse_gather.py:
subm_conv_slab`` and carries every submanifold and strided layer of the
voxel backbones. The CUDA kernels are in ``csrc/sparse_conv.cu``; the
(Q, K, Cin) gathered tensor is never formed. Any Cin and K, Cout <= 128.
bf16 runs on the tensor cores (``mma.sync``) in persistent blocks that
walk tiles of 128 output rows: each tile's neighbour table is read once,
the offsets without a hit are dropped, and the hit rows of the next step
are gathered by ``cp.async`` into a 2-stage shared-memory ring while the
current step's products run (a miss is masked in registers, not copied).
:func:`plan` gives the variant: weights resident in shared memory for the
block's life where that costs no block an SM ("resident"), else streamed
beside the rows ("streamed"); fp32 takes the SIMT kernel with exact fp32
FMAs ("simt"), the parity path. :func:`tile_stats` counts what the tiles
see on a table. Forward
only: the CUDA path raises on features or weights that require grad (the
JAX package trains through the plain ``subm_conv_table``; the port's
backward comes with training).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build

MAX_COUT = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/sparse_conv.cu's plan(): variant codes and the bf16 kernel's shapes
VARIANTS = {"simt": 1, "resident": 2, "streamed": 3}
TILE_ROWS = 128  # output rows per tile, 8 warps x 16
OFFSET_BLOCK = 32  # offsets whose table a tile holds at once
MAX_CHUNK = 64  # input channels per step
STAGES = 2  # ring stages of both bf16 variants
SMEM_LIMIT = 232_448  # shared memory a block may use on sm_90
SMEM_PER_SM = 228 * 1024  # an SM's shared memory, 1 KB reserved a block
RESIDENT_WEIGHT_BYTES = 32 * 1024  # the largest (padded) resident weights


def blocks_per_sm(cout: int) -> int:
    """Blocks an SM that the bf16 kernel's registers allow for Cout: its
    accumulators are 4 fp32 registers a thread per n8 tile of Cout,
    rounded up to 2, 4, 8 or 16 tiles (``__launch_bounds__``)."""
    nt = -(-cout // 8)
    return 4 if nt <= 4 else 3 if nt <= 8 else 2


def resident_limit(cout: int) -> int:
    """The most shared memory a resident-weights block may take without
    costing a block an SM."""
    return SMEM_PER_SM // blocks_per_sm(cout) - 1024


class Plan(NamedTuple):
    variant: str
    stages: int
    smem_bytes: int


def plan(cin: int, cout: int, k: int, dtype=torch.bfloat16,
         variant: str | None = None):
    """The kernel variant ``sparse_conv`` launches for (Cin, Cout, K) in
    ``dtype`` and its dynamic shared memory, as ``csrc/sparse_conv.cu:
    plan`` decides: fp32 → "simt"; bf16 → "resident" when the K·Cin16·
    (Cout8 + 8)·2 bytes of weights are at most
    :data:`RESIDENT_WEIGHT_BYTES` and, with a 2-stage ring of 128-row
    stages and the table, fit in :func:`resident_limit` (resident weights
    never cost a block an SM), else "streamed" (2 stages of rows and one
    64-channel weight chunk each). ``variant`` asks for one, which may use up to
    :data:`SMEM_LIMIT`; None where it does not take the shape."""
    if dtype == torch.float32:
        return Plan("simt", 0, 0) if variant in (None, "simt") else None
    cin_pad = -(-cin // 16) * 16
    kc = min(MAX_CHUNK, cin_pad)
    cout8 = -(-cout // 8) * 8
    astr, wstr = kc + 8, cout8 + 8
    kb = min(k, OFFSET_BLOCK)
    # padded source rows, live masks, hit counts, the offset list and its
    # length, the hit rows (bytes)
    table = (kb * (TILE_ROWS + 1) + 3 * OFFSET_BLOCK + 1) * 4 + kb * TILE_ROWS
    a_stage = TILE_ROWS * astr * 2
    resident = k * cin_pad * wstr * 2 + STAGES * a_stage + table
    streamed = STAGES * (a_stage + kc * wstr * 2) + table
    weights = k * cin_pad * wstr * 2
    if (variant is None and resident <= resident_limit(cout)
            and weights <= RESIDENT_WEIGHT_BYTES) or (
            variant == "resident" and resident <= SMEM_LIMIT):
        return Plan("resident", STAGES, resident)
    if variant == "resident":
        return None
    if variant in (None, "streamed") and streamed <= SMEM_LIMIT:
        return Plan("streamed", STAGES, streamed)
    return None


def sparse_conv_plain(features, idx, hit, weights, valid):
    """Plain PyTorch version (``subm_conv_table`` of the JAX package,
    batched): gather with an extra zero row, one (Q, K·Cin) × (K·Cin,
    Cout) product, zeros where not ``valid``."""
    b, v, cin = features.shape
    k, _, cout = weights.shape
    q = idx.shape[1]
    fz = torch.cat([features, features.new_zeros(b, 1, cin)], dim=1)
    rows = torch.where(hit, idx, v).long().reshape(b, q * k, 1)
    gathered = torch.gather(fz, 1, rows.expand(-1, -1, cin))
    out = torch.matmul(gathered.reshape(b, q, k * cin),
                       weights.reshape(k * cin, cout))
    return torch.where(valid[..., None], out, 0.0)


def _check(features, idx, hit, weights, valid):
    if features.dim() != 3 or weights.dim() != 3 or idx.dim() != 3:
        raise ValueError("sparse_conv: features (B, V, Cin), idx/hit "
                         "(B, Q, K), weights (K, Cin, Cout)")
    b, v, cin = features.shape
    k, wcin, cout = weights.shape
    q = idx.shape[1]
    if (wcin != cin or tuple(idx.shape) != (b, q, k)
            or tuple(hit.shape) != (b, q, k) or tuple(valid.shape) != (b, q)):
        raise ValueError(
            f"sparse_conv: features {tuple(features.shape)}, idx "
            f"{tuple(idx.shape)}, hit {tuple(hit.shape)}, weights "
            f"{tuple(weights.shape)}, valid {tuple(valid.shape)}")
    if weights.dtype != features.dtype:
        raise TypeError("sparse_conv: weights must have the features' dtype")


def _launch(features, idx, hit, weights, valid, variant):
    """Launch ``csrc/sparse_conv.cu`` on CUDA tensors: the variant of
    :func:`plan`, or the named one."""
    tensors = (features, idx, hit, weights, valid)
    b, v, cin = features.shape
    k, _, cout = weights.shape
    q = idx.shape[1]
    dev = features.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("sparse_conv: unsupported devices "
                         f"{[str(t.device) for t in tensors]}")
    if (features.dtype not in _DTYPE_CODE or idx.dtype != torch.int32
            or hit.dtype != torch.bool or valid.dtype != torch.bool):
        raise TypeError("sparse_conv: needs fp32/bf16 features and weights, "
                        "int32 idx, bool hit and valid")
    if not (v >= 1 and 1 <= cout <= MAX_COUT and k >= 1 and cin >= 1):
        raise ValueError(f"sparse_conv: V={v}, K={k}, Cin={cin}, Cout={cout} "
                         f"(Cout <= {MAX_COUT})")
    if variant is not None and plan(cin, cout, k, features.dtype,
                                    variant) is None:
        raise ValueError(f"sparse_conv: variant {variant!r} does not take "
                         f"{features.dtype}, Cin={cin}, Cout={cout}, K={k}")
    build.refuse_grad("sparse_conv", features, weights)
    out = torch.empty((b, q, cout), dtype=features.dtype, device=dev)
    if b == 0 or q == 0:
        return out
    features, idx, hit, weights, valid = (t.contiguous() for t in tensors)
    err = build.lib().de6d_sparse_conv(
        features.data_ptr(), idx.data_ptr(), hit.data_ptr(),
        weights.data_ptr(), valid.data_ptr(), out.data_ptr(), b, v, q, k,
        cin, cout, _DTYPE_CODE[features.dtype],
        0 if variant is None else VARIANTS[variant],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "sparse_conv")
    return out


def sparse_conv(features, idx, hit, weights, valid):
    """features (B, V, Cin) fp32 or bf16, neighbour table idx (B, Q, K)
    int32 / hit (B, Q, K) bool (rows of ``features``; ``idx`` is read
    only where ``hit``), weights (K, Cin, Cout) of the features' dtype,
    valid (B, Q) bool → out (B, Q, Cout):
    ``out[b, q] = Σ_k hit[b,q,k] · features[b, idx[b,q,k]] @ weights[k]``
    summed in fp32, cast to the features' dtype, zero where not valid.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    variant of :func:`plan`.
    """
    _check(features, idx, hit, weights, valid)
    tensors = (features, idx, hit, weights, valid)
    if all(t.device.type == "cpu" for t in tensors):
        return sparse_conv_plain(features, idx, hit, weights, valid)
    out = _launch(features, idx, hit, weights, valid, None)
    sparse_conv.launches += 1
    return out


sparse_conv.launches = 0


def sparse_conv_variant(features, idx, hit, weights, valid, *, variant: str):
    """The kernel forced to ``variant`` (a key of :data:`VARIANTS` that
    :func:`plan` allows for the shape), for checking and timing every
    variant; CUDA tensors only, and not counted in
    ``sparse_conv.launches``."""
    _check(features, idx, hit, weights, valid)
    return _launch(features, idx, hit, weights, valid, variant)


def launched_variant() -> str:
    """The variant of the last launch in this process, as the library
    reports it."""
    code = build.lib().de6d_sparse_conv_last_variant()
    return {c: n for n, c in VARIANTS.items()}[code]


def library_plan(cin: int, cout: int, k: int, dtype=torch.bfloat16,
                 variant: str | None = None):
    """:func:`plan` as the library computes it (for holding the two
    equal on the card)."""
    info = (ctypes.c_int * 3)()
    code = build.lib().de6d_sparse_conv_plan(
        int(cin), int(cout), int(k), _DTYPE_CODE[dtype],
        0 if variant is None else VARIANTS[variant],
        ctypes.cast(info, ctypes.c_void_p))
    if code < 0:
        return None
    name = {c: n for n, c in VARIANTS.items()}[code]
    return Plan(name, info[1], info[2])


def tile_stats(idx, hit, valid, tile_rows: int = TILE_ROWS):
    """What the bf16 kernel's tiles see on this table: ``hits`` of valid
    rows; ``live_groups``, the (16-row group, offset) pairs with a hit,
    whose warp runs the offset's products (``mma_rows`` = 16 per live
    group, ``dead_rows`` of them without a hit); ``steps``, the (tile,
    offset) pairs with a hit; ``dense_rows``, rows x offsets of the tiles
    that hold a valid row (what a dense tile would multiply)."""
    b, q, k = idx.shape
    live = hit & valid[..., None]
    pad = (-q) % tile_rows
    lp = torch.cat([live, live.new_zeros(b, pad, k)], dim=1)
    vp = torch.cat([valid, valid.new_zeros(b, pad)], dim=1)
    groups = int(lp.reshape(b, -1, 16, k).any(2).sum())
    hits = int(live.sum())
    tiles = int(vp.reshape(b, -1, tile_rows).any(2).sum())
    return {
        "hits": hits,
        "valid_rows": int(valid.sum()),
        "live_groups": groups,
        "mma_rows": 16 * groups,
        "dead_rows": 16 * groups - hits,
        "steps": int(lp.reshape(b, -1, tile_rows, k).any(2).sum()),
        "dense_rows": tiles * tile_rows * k,
    }


def work(features, idx, hit, weights, valid):
    """(bytes, operations) the function needs on these inputs: ``hit`` of
    every (q, k) of a valid output row, ``idx`` only where that hits, the
    feature rows those hits reference, the weights and ``valid`` once, and
    the output written once; 2·Cin·Cout operations per hit of a valid
    output row."""
    b, v, cin = features.shape
    k, _, cout = weights.shape
    q = idx.shape[1]
    s = features.element_size()
    live = hit & valid[..., None]
    hits = int(live.sum())
    rows = torch.zeros(b * v, dtype=torch.bool, device=features.device)
    sample = torch.arange(b, device=idx.device)[:, None, None] * v
    rows[(sample + idx.long())[live]] = True
    nbytes = (int(valid.sum()) * k + hits * 4 + int(rows.sum()) * cin * s
              + k * cin * cout * s + b * q + b * q * cout * s)
    return nbytes, 2 * hits * cin * cout
