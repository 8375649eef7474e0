"""Sparse 3D convolution from a neighbour table: a gather-GEMM in one
launch per layer for the whole batch.

Replaces the TPU kernel ``de6d_tpu/ops/pallas/sparse_gather.py:
subm_conv_slab`` and carries every submanifold and strided layer of the
voxel backbones. The CUDA kernels are in ``csrc/sparse_conv.cu``: per
tile of 64 output rows and per kernel offset they gather the neighbour
rows into shared memory (zeros on a miss), stage that offset's weights
and accumulate in fp32 registers, with fp32 FMAs for fp32 features and
tensor-core ``mma.sync`` for bf16; the (Q, K, Cin) gathered tensor is
never formed. Any Cin and K, Cout <= 128. Forward only: the CUDA path
raises on features or weights that require grad (the JAX package trains
through the plain ``subm_conv_table``; the port's backward comes with
training).
"""

from __future__ import annotations

import torch

from . import build

MAX_COUT = 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def sparse_conv(features, idx, hit, weights, valid):
    """features (B, V, Cin) fp32 or bf16, neighbour table idx (B, Q, K)
    int32 / hit (B, Q, K) bool (rows of ``features``; ``idx`` is read
    only where ``hit``), weights (K, Cin, Cout) of the features' dtype,
    valid (B, Q) bool → out (B, Q, Cout):
    ``out[b, q] = Σ_k hit[b,q,k] · features[b, idx[b,q,k]] @ weights[k]``
    summed in fp32, cast to the features' dtype, zero where not valid.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
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
    tensors = (features, idx, hit, weights, valid)
    if all(t.device.type == "cpu" for t in tensors):
        return sparse_conv_plain(features, idx, hit, weights, valid)
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
    build.refuse_grad("sparse_conv", features, weights)
    out = torch.empty((b, q, cout), dtype=features.dtype, device=dev)
    if b == 0 or q == 0:
        return out
    features, idx, hit, weights, valid = (t.contiguous() for t in tensors)
    err = build.lib().de6d_sparse_conv(
        features.data_ptr(), idx.data_ptr(), hit.data_ptr(),
        weights.data_ptr(), valid.data_ptr(), out.data_ptr(), b, v, q, k,
        cin, cout, _DTYPE_CODE[features.dtype],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    build.check(err, "sparse_conv")
    sparse_conv.launches += 1
    return out


sparse_conv.launches = 0


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
