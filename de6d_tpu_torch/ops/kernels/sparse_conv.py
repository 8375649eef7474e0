"""Sparse 3D convolution from a neighbour table: a gather-GEMM in one
launch per layer for the whole batch.

Replaces the TPU kernel ``de6d_tpu/ops/pallas/sparse_gather.py:
subm_conv_slab`` and carries every submanifold and strided layer of the
voxel backbones. The CUDA kernels are in ``csrc/sparse_conv.cu``; the
(Q, K, Cin) gathered tensor is never formed. Any Cin and K, Cout <= 128.
Both dtypes run one kernel in persistent blocks that walk tiles of 128
output rows: each tile's neighbour table is read once, the offsets
without a hit are dropped, and the hit rows of the next step are gathered
by ``cp.async`` into a 2-stage shared-memory ring while the current
step's products run. bf16 multiplies on the tensor cores (``mma.sync``; a
miss is masked in registers, not copied); fp32 on the SIMT cores with
exact fp32 FMAs in the order of a dense walk, skipping the rows without a
hit ("simt", the parity path). :func:`plan` gives the variant and whether
the weights stay resident in shared memory for the block's life (where
that costs no block an SM) or are streamed beside the rows. :func:`tile_stats`
counts what the tiles see on a table.

``sparse_conv`` is differentiable in the features and the weights (a
``torch.autograd.Function``), giving what ``jax.grad`` gives of the JAX
package's ``subm_conv_table`` / ``strided_conv``. On the card its
backward launches only hand kernels: the data gradient is this same
forward kernel on the table's transpose with transposed weights
(:func:`sparse_conv_dgrad`), the weight gradient is its own kernel
(:func:`sparse_conv_wgrad`, channel tiles sized by the layer's widths,
one offset a warp, deterministic). The caller says how the transpose is
had (:func:`dgrad_operands`): a submanifold table is its own transpose
through the mirrored offsets (:class:`Submanifold`: the kernel reads
column K-1-k at step k, no table is built, and a table that breaks the
contract raises at the next check, :func:`raise_mirror_fault`), a
strided layer's is built from its geometry (:class:`Strided`:
``lookup.transposed_table``, one launch that writes each entry once).
CPU tensors take the plain versions, forward and backward.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build
from .lookup import transposed_table

MAX_COUT = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/sparse_conv.cu's plan(): variant codes and the kernel's shapes
VARIANTS = {"simt": 1, "resident": 2, "streamed": 3}
TILE_ROWS = 128  # output rows per tile, 8 warps x 16
OFFSET_BLOCK = 32  # offsets whose table a tile holds at once
MAX_CHUNK = 64  # input channels per step, bf16
MAX_CHUNK_F32 = 32  # input channels per step, fp32
STAGES = 2  # ring stages, every variant
SMEM_LIMIT = 232_448  # shared memory a block may use on sm_90
SMEM_PER_SM = 228 * 1024  # an SM's shared memory, 1 KB reserved a block
RESIDENT_WEIGHT_BYTES = 32 * 1024  # the largest (padded) resident weights


def blocks_per_sm(cout: int, dtype=torch.bfloat16) -> int:
    """Blocks an SM that the kernel's registers allow for Cout
    (``__launch_bounds__``): its accumulators are 4 fp32 registers a
    thread per n8 tile of Cout, rounded up to 2, 4, 8 or 16 tiles; the
    fp32 back end also holds a quad's gathered values and its weights, so
    it takes a larger budget (3 blocks up to Cout 32, then 2)."""
    nt = -(-cout // 8)
    if dtype == torch.float32:
        return 3 if nt <= 4 else 2
    return 4 if nt <= 4 else 3 if nt <= 8 else 2


def resident_limit(cout: int, dtype=torch.bfloat16) -> int:
    """The most shared memory a resident-weights block may take without
    costing a block an SM."""
    return SMEM_PER_SM // blocks_per_sm(cout, dtype) - 1024


class Plan(NamedTuple):
    variant: str
    stages: int
    smem_bytes: int
    resident: bool  # the weights stay in shared memory for the block's life


def plan(cin: int, cout: int, k: int, dtype=torch.bfloat16,
         variant: str | None = None):
    """The kernel variant ``sparse_conv`` launches for (Cin, Cout, K) in
    ``dtype``, its dynamic shared memory and whether its weights stay
    resident, as ``csrc/sparse_conv.cu:plan`` decides. Both dtypes take
    the same rule: a 2-stage ring of 128-row stages (rows of Cin padded to
    16 and chunks of 64 channels for bf16; to 8 and 32 for fp32), the
    table (fp32 adds a 128-byte row of zeros), and the weights (rows of
    Cout8 + 8 bf16 or 8·NT fp32, NT the accumulator tiles of
    :func:`blocks_per_sm`) either resident (when they
    take at most :data:`RESIDENT_WEIGHT_BYTES` and the block fits in
    :func:`resident_limit`: resident weights never cost a block an SM) or
    streamed, one chunk a stage. bf16 names the two "resident" and
    "streamed" (``variant`` asks for one, which may use up to
    :data:`SMEM_LIMIT`); fp32 is "simt" either way. On an NVIDIA H100
    80GB HBM3 at 700 W (``sparse_conv_ab.py``, parent and change in turns
    in one call) the fp32 redesign took SECOND's 12 forwards at batch 8
    from 6.60–6.62 ms (the SIMT kernel that walked all K offsets of a
    64-row block) to 1.78–1.81 ms, bit-equal, every layer below its plain
    version; a train step's 11 data gradients with their transposes from
    5.70–5.74 to 1.73–1.74 ms in a CUDA graph. None where the variant does
    not take the shape."""
    f32 = dtype == torch.float32
    if (variant not in (None, "simt")) if f32 else variant == "simt":
        return None
    size = 4 if f32 else 2
    cin_pad = -(-cin // (8 if f32 else 16)) * (8 if f32 else 16)
    kc = min(MAX_CHUNK_F32 if f32 else MAX_CHUNK, cin_pad)
    nt = -(-cout // 8)
    nt = 2 if nt <= 2 else 4 if nt <= 4 else 8 if nt <= 8 else 16
    astr = kc + (4 if f32 else 8)
    wstr = 8 * nt if f32 else -(-cout // 8) * 8 + 8
    kb = min(k, OFFSET_BLOCK)
    # padded source rows, live masks, hit counts, the offset list and its
    # length, the hit rows (bytes); fp32 reads missed rows from a zero row
    table = ((kb * (TILE_ROWS + 1) + 3 * OFFSET_BLOCK + 1) * 4 + kb * TILE_ROWS
             + (MAX_CHUNK_F32 * 4 if f32 else 0))
    a_stage = TILE_ROWS * astr * size
    weights = k * cin_pad * wstr * size
    resident = weights + STAGES * a_stage + table
    streamed = STAGES * (a_stage + kc * wstr * size) + table
    fits = (resident <= resident_limit(cout, dtype)
            and weights <= RESIDENT_WEIGHT_BYTES)
    if f32:
        return Plan("simt", STAGES, resident if fits else streamed, fits)
    if (variant is None and fits) or (
            variant == "resident" and resident <= SMEM_LIMIT):
        return Plan("resident", STAGES, resident, True)
    if variant == "resident":
        return None
    if variant in (None, "streamed") and streamed <= SMEM_LIMIT:
        return Plan("streamed", STAGES, streamed, False)
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


def _launch(features, idx, hit, weights, valid, variant, mirror=False):
    """Launch ``csrc/sparse_conv.cu`` on CUDA tensors: the variant of
    :func:`plan`, or the named one; ``mirror``: step k reads the table's
    column K-1-k."""
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
        0 if variant is None else VARIANTS[variant], int(bool(mirror)),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "sparse_conv")
    return out


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


class Submanifold:
    """Marks the table as ``ops.sparse.subm_neighbor_table(keys, grid,
    kernel)`` of the sites for a centred kernel, odd in every axis, with
    every site asking, and ``valid`` as the sites: the table is its own
    transpose through the mirrored offsets (offset K-1-k is the negation
    of offset k), ``tidx[q, k] = idx[q, K-1-k]``, ``thit`` likewise,
    ``tvalid = valid``."""

    __slots__ = ()

    def __repr__(self):
        return "Submanifold()"


class Strided(NamedTuple):
    """The table is ``ops.sparse.strided_neighbor_table`` of this geometry
    (each input key once): its transpose is ``lookup.transposed_table``
    of the same arguments."""

    keys_sorted: torch.Tensor
    out_keys_sorted: torch.Tensor
    grid: tuple
    out_grid: tuple
    kernel: tuple
    stride: tuple
    padding: tuple


def _check_transpose(transpose, idx, hit, valid, v: int):
    """Raise unless ``transpose`` (None, :class:`Submanifold` or
    :class:`Strided`) fits the table (B, Q, K) over V input rows. A
    submanifold table is square with an odd K (a centred kernel odd in
    every axis, so offset K-1-k mirrors offset k); its rows are checked
    too: every valid row asks (hits itself at the centre), no other row
    hits, and every hit of a valid row is a valid row. On CPU tensors that
    is checked here; on the card the mirrored data gradient's kernel
    checks each entry it reads and raises a fault word with no host sync
    (:func:`raise_mirror_fault`)."""
    b, q, k = idx.shape
    if transpose is None:
        return
    if isinstance(transpose, Submanifold):
        if k % 2 == 0 or q != v:
            raise ValueError(
                f"sparse_conv: a submanifold table needs an odd number of "
                f"offsets (a centred kernel) and Q == V; got K = {k}, "
                f"Q = {q}, V = {v}")
        if _on_cpu(idx, hit, valid):
            live = hit & valid[..., None]
            to = torch.gather(valid, 1, torch.where(live, idx, 0).long()
                              .reshape(b, q * k)).reshape(b, q, k)
            if not (bool((hit[..., k // 2] | ~valid).all())
                    and not bool((hit.any(-1) & ~valid).any())
                    and bool((to | ~live).all())):
                raise ValueError(
                    "sparse_conv: not a submanifold table of its valid "
                    "rows (every valid row must ask and only they, every "
                    "hit a valid row): its transpose is not the mirrored "
                    "table")
    elif isinstance(transpose, Strided):
        kz, ky, kx = (int(n) for n in transpose.kernel)
        if (kz * ky * kx != k
                or tuple(transpose.keys_sorted.shape) != (b, v)
                or tuple(transpose.out_keys_sorted.shape) != (b, q)):
            shapes = (tuple(transpose.keys_sorted.shape),
                      tuple(transpose.out_keys_sorted.shape))
            raise ValueError(
                f"sparse_conv: strided geometry with kernel "
                f"{transpose.kernel}, keys {shapes[0]}, out keys {shapes[1]}"
                f" does not fit the table {tuple(idx.shape)} over V = {v}")
    else:
        raise TypeError("sparse_conv: transpose must be None, Submanifold "
                        f"or Strided, not {type(transpose)}")


class _SparseConv(torch.autograd.Function):
    """The convolution with its backward: the plain versions on the CPU,
    the kernels on the card."""

    @staticmethod
    def forward(ctx, features, weights, idx, hit, valid, transpose):
        if _on_cpu(features, idx, hit, weights, valid):
            out = sparse_conv_plain(features, idx, hit, weights, valid)
        else:
            out = _launch(features, idx, hit, weights, valid, None)
            sparse_conv.launches += 1
        need_feat, need_w = ctx.needs_input_grad[:2]
        ctx.v = features.shape[1]
        ctx.transpose = transpose
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
                                       ctx.v, ctx.transpose)
        if ctx.needs_input_grad[1]:
            d_w = sparse_conv_wgrad(features, grad_out, idx, hit, valid)
        return d_feat, d_w, None, None, None, None


def sparse_conv(features, idx, hit, weights, valid, transpose=None):
    """features (B, V, Cin) fp32 or bf16, neighbour table idx (B, Q, K)
    int32 / hit (B, Q, K) bool (rows of ``features``; ``idx`` is read
    only where ``hit``), weights (K, Cin, Cout) of the features' dtype,
    valid (B, Q) bool → out (B, Q, Cout):
    ``out[b, q] = Σ_k hit[b,q,k] · features[b, idx[b,q,k]] @ weights[k]``
    summed in fp32, cast to the features' dtype, zero where not valid.

    Differentiable in ``features`` and ``weights``; ``transpose`` says how
    the data gradient gets the table's transpose (:func:`dgrad_operands`),
    and the data gradient on the card raises without it.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    variant of :func:`plan`, and their backward the kernels.
    """
    _check(features, idx, hit, weights, valid)
    _check_transpose(transpose, idx, hit, valid, features.shape[1])
    return _SparseConv.apply(features, weights, idx, hit, valid, transpose)


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
    """The transpose of a convolution's table onto its V input rows, by a
    scatter: (tidx (B, V, K) int32, thit (B, V, K) bool, tvalid (B, V)
    bool) with ``tidx[b, idx[b,q,k], k] = q`` and ``thit`` there for every
    live pair (``hit ∧ valid[b, q]``), ``tidx`` 0 elsewhere, and
    ``tvalid`` the input rows some live pair references: the reference
    that the mirrored table and ``lookup.transposed_table`` are held
    against (the forward on it with transposed weights is the data
    gradient of any table). Raises ValueError where two live pairs of one
    offset reference one input row (the table of a convolution never
    does)."""
    b, q, k = idx.shape
    live = hit & valid[..., None]
    rows = torch.where(live, idx.long(), v)  # dead pairs: a spare row v
    count = torch.zeros((b, v + 1, k), dtype=torch.int32, device=idx.device)
    count.scatter_add_(1, rows, live.to(torch.int32))
    if bool((count[:, :v] > 1).any()):
        raise ValueError("sparse_conv_transpose_plain: two live pairs of one "
                         "offset reference one input row")
    src = torch.arange(q, dtype=torch.int32, device=idx.device)
    tidx = torch.zeros((b, v + 1, k), dtype=torch.int32, device=idx.device)
    tidx.scatter_(1, rows, src[None, :, None].expand(b, q, k).contiguous())
    thit = count[:, :v] > 0
    tidx = torch.where(thit, tidx[:, :v], 0)
    return tidx, thit, thit.any(-1)


def dgrad_operands(weights, idx, hit, valid, v: int, transpose):
    """(table idx, table hit, output rows, weights, mirror) on which the
    forward kernel computes the data gradient onto V input rows, with
    ``weights`` transposed: for :class:`Submanifold` the forward's own
    table and ``valid`` with ``mirror`` (step k reads column K-1-k; no
    table is built; the kernel checks the contract), for :class:`Strided`
    ``lookup.transposed_table`` of its geometry
    (``sparse_conv_transpose_plain`` of the table, built from the keys
    instead of scattered)."""
    wt = weights.transpose(1, 2).contiguous()
    if isinstance(transpose, Submanifold):
        return idx, hit, valid, wt, True
    if isinstance(transpose, Strided):
        return (*transposed_table(*transpose), wt, False)
    raise ValueError("sparse_conv_dgrad: the data gradient on the card needs "
                     "the table's transpose (Submanifold or Strided), not "
                     f"{transpose!r}")


def sparse_conv_dgrad(grad_out, idx, hit, weights, valid, v: int,
                      transpose=None):
    """The data gradient of :func:`sparse_conv` onto its V input rows
    (``sparse_conv_dgrad_plain``'s function). CPU tensors take the plain
    version; CUDA tensors launch the forward kernel on
    :func:`dgrad_operands` of ``transpose`` (its width out is the
    forward's Cin, at most :data:`MAX_COUT`), counted in
    ``sparse_conv_dgrad.launches``, and those on a mirrored table also in
    ``sparse_conv_dgrad.mirrored``. A card call first raises a fault that
    an earlier mirrored launch has left (:func:`raise_mirror_fault`)."""
    if _on_cpu(grad_out, idx, hit, weights, valid):
        return sparse_conv_dgrad_plain(grad_out, idx, hit, weights, valid, v)
    raise_mirror_fault()
    _check_transpose(transpose, idx, hit, valid, v)
    t_idx, t_hit, rows, wt, mirror = dgrad_operands(weights, idx, hit, valid,
                                                    v, transpose)
    _check(grad_out, t_idx, t_hit, wt, rows)
    out = _launch(grad_out, t_idx, t_hit, wt, rows, None, mirror)
    sparse_conv_dgrad.launches += 1
    sparse_conv_dgrad.mirrored += int(mirror)
    return out


sparse_conv_dgrad.launches = 0
sparse_conv_dgrad.mirrored = 0


def raise_mirror_fault():
    """Raise ValueError if a mirrored data gradient that has finished on
    the card read a table that is not the submanifold table of its valid
    rows (a valid row that does not hit itself at the centre, a row that
    is not valid and hits, or a hit of a valid row that is not valid):
    its result is not the data gradient. Reads the kernel's fault word
    without a sync, so a launch still in flight is seen at a later call
    (after a sync, at the next); clears the word. Does nothing before the
    kernels are loaded."""
    if build.loaded() and build.lib().de6d_sparse_conv_mirror_fault(1) > 0:
        raise ValueError(
            "sparse_conv_dgrad: a mirrored data gradient ran on a table "
            "that is not the submanifold table of its valid rows (every "
            "valid row must ask and only they, every hit a valid row); its "
            "result is wrong")


# csrc/sparse_conv.cu's wgrad_plan(): the channel tiles (Cin x Cout side)
WGRAD_TILES = ((16, 16), (16, 32), (32, 32), (32, 64))
WGRAD_ROWS = 128  # rows of a chunk: a slice is a whole number of them
WGRAD_OFFSETS = 8  # offsets of a block, one a warp
WGRAD_RING = 512  # elements of a warp's ring stage (512 / CI rows)
WGRAD_WAVES = 2  # the waves of resident blocks the slices aim at


class WgradPlan(NamedTuple):
    ci: int
    co: int
    smem_bytes: int
    blocks_per_sm: int


def wgrad_plan(cin: int, cout: int, dtype=torch.float32) -> WgradPlan:
    """The weight-gradient kernel's channel tile for (Cin, Cout), as
    ``csrc/sparse_conv.cu:wgrad_plan`` chooses it: of
    :data:`WGRAD_TILES`, the one that pads Cin x Cout least, the larger
    on a tie; its dynamic shared memory (a chunk's dy rows, 8 warps' 2-stage
    rings, the table block's source rows and hit lists) and the blocks an
    SM its registers allow (TI x TJ fp32 accumulators a lane)."""
    best = None
    for ci, co in WGRAD_TILES:
        area = -(-cin // ci) * ci * -(-cout // co) * co
        if best is None or area <= best[0]:
            best = (area, ci, co)
    _, ci, co = best
    size = 4 if dtype == torch.float32 else 2
    smem = ((WGRAD_ROWS * co + WGRAD_OFFSETS * 2 * WGRAD_RING) * size
            + WGRAD_OFFSETS * WGRAD_ROWS * 5)
    elems = ci * co
    return WgradPlan(ci, co, smem, 4 if elems <= 512 else 3 if elems <= 1024
                     else 2)


def wgrad_blocks(cin: int, cout: int, k: int) -> int:
    """Blocks of one slice: the channel tiles times the offset groups."""
    p = wgrad_plan(cin, cout)
    return (-(-cin // p.ci) * -(-cout // p.co)
            * -(-k // WGRAD_OFFSETS))


def wgrad_slices(rows: int, k: int, cin: int, cout: int, sms: int):
    """(slices, rows a slice) of the weight-gradient kernel over the B·Q
    rows. A block takes (a slice, a channel tile of :func:`wgrad_plan`, 8
    offsets, one a warp) and walks its slice in chunks of
    :data:`WGRAD_ROWS` rows: per chunk it reads the (rows × 8 offsets)
    table block once, each warp lists its offset's hit rows in order and
    gathers their feature rows by ``cp.async`` into a ring of its own,
    and multiplies them against the chunk's dy rows. The slices aim at
    :data:`WGRAD_WAVES` waves of resident blocks on ``sms`` SMs, each a
    whole number of chunks and none empty; every live (row, offset) pair
    falls in exactly one block per channel tile (:func:`wgrad_partition`).
    """
    want = -(-WGRAD_WAVES * sms * wgrad_plan(cin, cout).blocks_per_sm
             // wgrad_blocks(cin, cout, k))
    slices = max(1, min(want, -(-rows // WGRAD_ROWS)))
    per = -(-(-(-rows // slices)) // WGRAD_ROWS) * WGRAD_ROWS
    return -(-rows // per), per


def wgrad_partition(idx, hit, valid, cin: int, cout: int, sms: int):
    """What the weight-gradient kernel's blocks see on this table: a
    (slices, offset groups, warps) int64 array of the live (row, offset)
    pairs each warp of each block multiplies (the same for every channel
    tile), from :func:`wgrad_slices`'s partition of the B·Q rows."""
    b, q, k = idx.shape
    slices, per = wgrad_slices(b * q, k, cin, cout, sms)
    live = (hit & valid[..., None]).reshape(b * q, k).to(torch.int64)
    groups = -(-k // WGRAD_OFFSETS)
    pad_rows, pad_k = slices * per - b * q, groups * WGRAD_OFFSETS - k
    live = torch.nn.functional.pad(live, (0, pad_k, 0, pad_rows))
    return live.reshape(slices, per, groups, WGRAD_OFFSETS).sum(1)


def sparse_conv_wgrad(features, grad_out, idx, hit, valid):
    """The weight gradient of :func:`sparse_conv` (K, Cin, Cout) in the
    features' dtype (``sparse_conv_wgrad_plain``'s function). CPU tensors
    take the plain version; CUDA tensors launch ``csrc/sparse_conv.cu``'s
    weight-gradient kernel over :func:`wgrad_slices`' partition: fp32
    partial sums per (slice, offset, channel tile), each over its rows in
    order, then a second kernel adds the slices in a fixed order and
    rounds once, so two runs are bit-equal. Counted in
    ``sparse_conv_wgrad.launches``. On an NVIDIA H100 80GB HBM3 at 700 W
    (``sparse_conv_ab.py``, one call) the redesign (tiles by the widths,
    the table read once a chunk, one offset a warp) took SECOND's 12
    weight gradients of a train step from 2.92–2.97 ms in a CUDA graph (a
    64 × 64 tile whatever the widths, every offset rescanning the table)
    to 0.98 ms."""
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
    info = (ctypes.c_int * 4)()
    code = build.lib().de6d_sparse_conv_plan(
        int(cin), int(cout), int(k), _DTYPE_CODE[dtype],
        0 if variant is None else VARIANTS[variant],
        ctypes.cast(info, ctypes.c_void_p))
    if code < 0:
        return None
    name = {c: n for n, c in VARIANTS.items()}[code]
    return Plan(name, info[1], info[2], bool(info[3]))


def library_wgrad_plan(cin: int, cout: int, dtype=torch.float32):
    """:func:`wgrad_plan` as the library computes it."""
    info = (ctypes.c_int * 4)()
    code = build.lib().de6d_sparse_conv_wgrad_plan(
        int(cin), int(cout), _DTYPE_CODE[dtype],
        ctypes.cast(info, ctypes.c_void_p))
    if code < 0:
        return None
    return WgradPlan(info[0], info[1], info[2], info[3])


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
