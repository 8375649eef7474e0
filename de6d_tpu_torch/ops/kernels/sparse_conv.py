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
see on a table.

``sparse_conv`` is differentiable in the features and the weights (a
``torch.autograd.Function``), giving what ``jax.grad`` gives of the JAX
package's ``subm_conv_table`` / ``strided_conv``. On the card its
backward launches only hand kernels: the data gradient is this same
forward kernel on the table's transpose (:func:`sparse_conv_transpose`)
with transposed weights (:func:`sparse_conv_dgrad`), the weight gradient
is its own kernel
(:func:`sparse_conv_wgrad`, deterministic). CPU tensors take the plain
versions, forward and backward.
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


def _devices(what, *tensors):
    """Raise unless every tensor lies on the first one's CUDA device."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: unsupported devices "
                         f"{[str(t.device) for t in tensors]}")


def _launch(features, idx, hit, weights, valid, variant):
    """Launch ``csrc/sparse_conv.cu`` on CUDA tensors: the variant of
    :func:`plan`, or the named one."""
    tensors = (features, idx, hit, weights, valid)
    b, v, cin = features.shape
    k, _, cout = weights.shape
    q = idx.shape[1]
    dev = features.device
    _devices("sparse_conv", *tensors)
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


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


class _SparseConv(torch.autograd.Function):
    """The convolution with its backward: the plain versions on the CPU,
    the kernels on the card."""

    @staticmethod
    def forward(ctx, features, weights, idx, hit, valid):
        if _on_cpu(features, idx, hit, weights, valid):
            out = sparse_conv_plain(features, idx, hit, weights, valid)
        else:
            out = _launch(features, idx, hit, weights, valid, None)
            sparse_conv.launches += 1
        need_feat, need_w = ctx.needs_input_grad[:2]
        ctx.v = features.shape[1]
        ctx.save_for_backward(features if need_w else None,
                              weights if need_feat else None, idx, hit,
                              valid)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        features, weights, idx, hit, valid = ctx.saved_tensors
        d_feat = d_w = None
        if ctx.needs_input_grad[0]:
            d_feat = sparse_conv_dgrad(grad_out, idx, hit, weights, valid,
                                       ctx.v)
        if ctx.needs_input_grad[1]:
            d_w = sparse_conv_wgrad(features, grad_out, idx, hit, valid)
        return d_feat, d_w, None, None, None


def sparse_conv(features, idx, hit, weights, valid):
    """features (B, V, Cin) fp32 or bf16, neighbour table idx (B, Q, K)
    int32 / hit (B, Q, K) bool (rows of ``features``; ``idx`` is read
    only where ``hit``), weights (K, Cin, Cout) of the features' dtype,
    valid (B, Q) bool → out (B, Q, Cout):
    ``out[b, q] = Σ_k hit[b,q,k] · features[b, idx[b,q,k]] @ weights[k]``
    summed in fp32, cast to the features' dtype, zero where not valid.

    Differentiable in ``features`` and ``weights``.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    variant of :func:`plan`, and their backward the kernels.
    """
    _check(features, idx, hit, weights, valid)
    return _SparseConv.apply(features, weights, idx, hit, valid)


sparse_conv.launches = 0


# ---- backward --------------------------------------------------------

def sparse_conv_dgrad_plain(grad_out, idx, hit, weights, valid, v: int):
    """Plain version of the data gradient onto V input rows:
    ``d_feat[b, v] = Σ_{(q, k) live, idx[b,q,k] = v} grad_out[b, q] @
    weights[k]ᵀ`` with ``live = hit ∧ valid[b, q]``, summed in fp32 (or
    wider), cast to ``grad_out``'s dtype."""
    b, q, k = idx.shape
    cin = weights.shape[1]
    acc = torch.promote_types(grad_out.dtype, torch.float32)
    live = hit & valid[..., None]
    prod = torch.einsum("bqo,kco->bqkc", grad_out.to(acc), weights.to(acc))
    prod = torch.where(live[..., None], prod, 0.0)
    rows = torch.where(live, idx.long(), v).reshape(b, q * k, 1)
    out = prod.new_zeros((b, v + 1, cin))
    out.scatter_add_(1, rows.expand(-1, -1, cin), prod.reshape(b, q * k, cin))
    return out[:, :v].to(grad_out.dtype)


def sparse_conv_wgrad_plain(features, grad_out, idx, hit, valid):
    """Plain version of the weight gradient:
    ``dW[k] = Σ_{(b, q) live} features[b, idx[b,q,k]]ᵀ ⊗ grad_out[b, q]``
    (K, Cin, Cout), summed in fp32 (or wider), cast once to the features'
    dtype."""
    b, v, cin = features.shape
    q, k = idx.shape[1:]
    acc = torch.promote_types(features.dtype, torch.float32)
    live = hit & valid[..., None]
    fz = torch.cat([features, features.new_zeros(b, 1, cin)], dim=1)
    rows = torch.where(live, idx, v).long().reshape(b, q * k, 1)
    gathered = torch.gather(fz.to(acc), 1, rows.expand(-1, -1, cin))
    dw = torch.einsum("bqkc,bqo->kco", gathered.reshape(b, q, k, cin),
                      grad_out.to(acc))
    return dw.to(features.dtype)


def sparse_conv_transpose_plain(idx, hit, valid, v: int):
    """Plain version of :func:`sparse_conv_transpose`. Raises ValueError
    where two live pairs of one offset reference one input row (the
    table of a convolution never does)."""
    b, q, k = idx.shape
    live = hit & valid[..., None]
    rows = torch.where(live, idx.long(), v)  # dead pairs: a spare row v
    count = torch.zeros((b, v + 1, k), dtype=torch.int32, device=idx.device)
    count.scatter_add_(1, rows, live.to(torch.int32))
    if bool((count[:, :v] > 1).any()):
        raise ValueError("sparse_conv_transpose: two live pairs of one "
                         "offset reference one input row")
    src = torch.arange(q, dtype=torch.int32, device=idx.device)
    tidx = torch.zeros((b, v + 1, k), dtype=torch.int32, device=idx.device)
    tidx.scatter_(1, rows, src[None, :, None].expand(b, q, k).contiguous())
    thit = count[:, :v] > 0
    tidx = torch.where(thit, tidx[:, :v], 0)
    return tidx, thit, thit.any(-1)


def sparse_conv_transpose(idx, hit, valid, v: int):
    """The transpose of a convolution's table onto its V input rows:
    (tidx (B, V, K) int32, thit (B, V, K) bool, tvalid (B, V) bool) with
    ``tidx[b, idx[b,q,k], k] = q`` and ``thit`` there for every live pair
    (``hit ∧ valid[b, q]``), ``tidx`` 0 elsewhere, and ``tvalid`` the
    input rows some live pair references. For one offset the outputs
    reference distinct input rows, so the scatter has no collisions.

    CPU tensors take the plain version; CUDA tensors launch
    ``csrc/sparse_conv.cu``'s transpose kernel (one launch, counted)."""
    if _on_cpu(idx, hit, valid):
        return sparse_conv_transpose_plain(idx, hit, valid, v)
    b, q, k = idx.shape
    dev = idx.device
    _devices("sparse_conv_transpose", idx, hit, valid)
    tidx = torch.empty((b, v, k), dtype=torch.int32, device=dev)
    thit = torch.empty((b, v, k), dtype=torch.bool, device=dev)
    tvalid = torch.empty((b, v), dtype=torch.bool, device=dev)
    idx, hit, valid = (t.contiguous() for t in (idx, hit, valid))
    build.check(build.lib().de6d_sparse_conv_transpose(
        idx.data_ptr(), hit.data_ptr(), valid.data_ptr(), tidx.data_ptr(),
        thit.data_ptr(), tvalid.data_ptr(), b, v, q, k,
        torch.cuda.current_stream(dev).cuda_stream),
        "sparse_conv_transpose")
    sparse_conv_transpose.launches += 1
    return tidx, thit, tvalid


sparse_conv_transpose.launches = 0


def dgrad_operands(weights, idx, hit, valid, v: int):
    """(table idx, table hit, output rows, weights) on which the forward
    computes the data gradient onto V input rows: the table's
    :func:`sparse_conv_transpose` with ``weights`` transposed."""
    tidx, thit, tvalid = sparse_conv_transpose(idx, hit, valid, v)
    return tidx, thit, tvalid, weights.transpose(1, 2).contiguous()


def sparse_conv_dgrad(grad_out, idx, hit, weights, valid, v: int):
    """The data gradient of :func:`sparse_conv` onto its V input rows
    (``sparse_conv_dgrad_plain``'s function). CPU tensors take the plain
    version; CUDA tensors launch the forward kernel on
    :func:`dgrad_operands` (its width out is the forward's Cin, at most
    :data:`MAX_COUT`), counted in ``sparse_conv_dgrad.launches``."""
    if _on_cpu(grad_out, idx, hit, weights, valid):
        return sparse_conv_dgrad_plain(grad_out, idx, hit, weights, valid, v)
    t_idx, t_hit, rows, wt = dgrad_operands(weights, idx, hit, valid, v)
    _check(grad_out, t_idx, t_hit, wt, rows)
    out = _launch(grad_out, t_idx, t_hit, wt, rows, None)
    sparse_conv_dgrad.launches += 1
    return out


sparse_conv_dgrad.launches = 0

WGRAD_TILE = 64  # csrc/sparse_conv.cu: a block's Cin x Cout tile, each side
WGRAD_SCAN = 256  # candidate rows a block scans at once
WGRAD_WAVES = 4  # blocks an SM the slices aim at


def wgrad_slices(rows: int, k: int, cin: int, cout: int, sms: int):
    """(slices, rows a slice) of the weight-gradient kernel: enough blocks
    for :data:`WGRAD_WAVES` an SM, each slice a whole number of
    :data:`WGRAD_SCAN` rows and none empty."""
    tiles = -(-cin // WGRAD_TILE) * -(-cout // WGRAD_TILE)
    want = -(-WGRAD_WAVES * sms // (k * tiles))
    slices = max(1, min(want, -(-rows // WGRAD_SCAN), 65535))
    per = -(-(-(-rows // slices)) // WGRAD_SCAN) * WGRAD_SCAN
    return -(-rows // per), per


def sparse_conv_wgrad(features, grad_out, idx, hit, valid):
    """The weight gradient of :func:`sparse_conv` (K, Cin, Cout) in the
    features' dtype (``sparse_conv_wgrad_plain``'s function). CPU tensors
    take the plain version; CUDA tensors launch ``csrc/sparse_conv.cu``'s
    weight-gradient kernel (per (tile, offset, slice of rows) partial sums
    in fp32, added in a fixed order: deterministic), counted in
    ``sparse_conv_wgrad.launches``."""
    if _on_cpu(features, grad_out, idx, hit, valid):
        return sparse_conv_wgrad_plain(features, grad_out, idx, hit, valid)
    b, v, cin = features.shape
    q, k = idx.shape[1:]
    cout = grad_out.shape[-1]
    dev = features.device
    _devices("sparse_conv_wgrad", features, grad_out, idx, hit, valid)
    if (features.dtype not in _DTYPE_CODE or grad_out.dtype != features.dtype
            or idx.dtype != torch.int32 or hit.dtype != torch.bool
            or valid.dtype != torch.bool):
        raise TypeError("sparse_conv_wgrad: needs fp32/bf16 features and "
                        "gradient of one dtype, int32 idx, bool hit, valid")
    if (tuple(grad_out.shape) != (b, q, cout) or tuple(hit.shape) != (b, q, k)
            or tuple(valid.shape) != (b, q)):
        raise ValueError(f"sparse_conv_wgrad: features {tuple(features.shape)}"
                         f", grad_out {tuple(grad_out.shape)}, idx "
                         f"{tuple(idx.shape)}, valid {tuple(valid.shape)}")
    dw = torch.empty((k, cin, cout), dtype=features.dtype, device=dev)
    if b * q == 0 or v == 0:
        return dw.zero_()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    slices, per = wgrad_slices(b * q, k, cin, cout, sms)
    partial = torch.empty((slices, k, cin, cout), dtype=torch.float32,
                          device=dev)
    tensors = [t.contiguous() for t in (features, grad_out, idx, hit, valid)]
    build.check(build.lib().de6d_sparse_conv_wgrad(
        *(t.data_ptr() for t in tensors), partial.data_ptr(), dw.data_ptr(),
        b, v, q, k, cin, cout, slices, per, _DTYPE_CODE[features.dtype],
        torch.cuda.current_stream(dev).cuda_stream), "sparse_conv_wgrad")
    sparse_conv_wgrad.launches += 1
    return dw


sparse_conv_wgrad.launches = 0


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


def work_backward(features, idx, hit, weights, valid):
    """{"dgrad": (bytes, operations), "wgrad": (bytes, operations)}: what
    each gradient needs on these inputs, counted as :func:`work` counts
    the forward. Both read ``hit`` of every (q, k) of a valid output row,
    ``idx`` where that hits and ``valid`` once, and do 2·Cin·Cout
    operations per hit of a valid row; the data gradient reads the
    gradient rows of the outputs with a hit and the weights once and
    writes (B, V, Cin) once; the weight gradient reads those gradient
    rows and the feature rows the hits reference, and writes (K, Cin,
    Cout) once."""
    b, v, cin = features.shape
    k, _, cout = weights.shape
    q = idx.shape[1]
    s = features.element_size()
    live = hit & valid[..., None]
    hits = int(live.sum())
    rows = torch.zeros(b * v, dtype=torch.bool, device=features.device)
    sample = torch.arange(b, device=idx.device)[:, None, None] * v
    rows[(sample + idx.long())[live]] = True
    table = int(valid.sum()) * k + hits * 4 + b * q
    dy_rows = int(live.any(-1).sum()) * cout * s
    ops = 2 * hits * cin * cout
    return {
        "dgrad": (table + dy_rows + k * cin * cout * s + b * v * cin * s,
                  ops),
        "wgrad": (table + dy_rows + int(rows.sum()) * cin * s
                  + k * cin * cout * s, ops),
    }


def work_transpose(idx, hit, valid, v: int):
    """Bytes :func:`sparse_conv_transpose` needs on these inputs (it does
    no arithmetic): ``valid`` once, ``hit`` of every (q, k) of a valid
    row, ``idx`` only where that hits, and the (B, V, K) ``tidx`` /
    ``thit`` and (B, V) ``tvalid`` written once."""
    b, q, k = idx.shape
    hits = int((hit & valid[..., None]).sum())
    return (int(valid.sum()) * k + hits * 4 + b * q + b * v * k * (4 + 1)
            + b * v)
