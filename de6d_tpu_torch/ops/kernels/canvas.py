"""BEV canvas scatter: key-sorted pillar rows → dense (B, ny, nx, C).

Replaces the TPU kernel ``de6d_tpu/ops/pallas/canvas.py:scatter_canvas``
(forward; the backward comes with the training slice, and until then
the CUDA path raises on a feature tensor that requires grad). The CUDA kernel
is ``csrc/canvas.cu``: one block per tile of consecutive cells; since
``lin`` is ascending, the tile's pillars are one contiguous range found
by binary search, and every cell of the tile is written exactly once
(its pillar's row or zeros) with 16-byte vector stores. It is bound by
bytes: at KITTI size it writes 8 x 214,272 x 64 x 2 B = 219 MB of bf16
canvas and reads 16 MB of features.
"""

from __future__ import annotations

import torch

from . import build


def scatter_canvas_plain(feat, lin, ny: int, nx: int):
    """Plain PyTorch version: scatter slot ids into the grid, then gather
    one feature row per cell (the JAX package's non-Pallas path)."""
    bsz, v, c = feat.shape
    g = ny * nx
    lin = torch.where(lin < g, lin, g).long()
    ids = torch.full((bsz, g + 1), v, dtype=torch.long, device=feat.device)
    ids.scatter_(1, lin, torch.arange(v, device=feat.device).expand(bsz, v))
    fpad = torch.cat([feat, feat.new_zeros(bsz, 1, c)], dim=1)
    rows = torch.gather(fpad, 1, ids[:, :g, None].expand(-1, -1, c))
    return rows.reshape(bsz, ny, nx, c)


def scatter_canvas(feat, lin, ny: int, nx: int):
    """(B, V, C) pillar features + (B, V) int32 linear cell ids →
    (B, ny, nx, C) canvas; cells with no pillar are 0.

    ``lin`` must hold unique ascending ids for the valid slots followed
    by an invalid suffix of ids >= ny*nx (the voxelizer's slot order).
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if feat.device.type == "cpu":
        return scatter_canvas_plain(feat, lin, ny, nx)
    if feat.device.type != "cuda" or lin.device != feat.device:
        raise ValueError(f"scatter_canvas: unsupported devices "
                         f"{feat.device}, {lin.device}")
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"scatter_canvas: feat dtype {feat.dtype}")
    if lin.dtype != torch.int32:
        raise TypeError(f"scatter_canvas: lin dtype {lin.dtype}")
    bsz, v, c = feat.shape
    if lin.shape != (bsz, v):
        raise ValueError(f"scatter_canvas: lin {tuple(lin.shape)} vs "
                         f"feat {tuple(feat.shape)}")
    row_bytes = c * feat.element_size()
    if row_bytes % 16:
        raise ValueError("scatter_canvas: C * itemsize must be a multiple "
                         "of 16 bytes")
    build.refuse_grad("scatter_canvas", feat)
    feat = feat.contiguous()
    lin = lin.contiguous()
    if feat.data_ptr() % 16:
        raise ValueError("scatter_canvas: feat must be 16-byte aligned")
    out = torch.empty((bsz, ny, nx, c), dtype=feat.dtype, device=feat.device)
    if out.numel() == 0:
        return out
    err = build.lib().de6d_scatter_canvas(
        feat.data_ptr(), lin.data_ptr(), out.data_ptr(),
        bsz, v, ny * nx, row_bytes,
        torch.cuda.current_stream(feat.device).cuda_stream,
    )
    build.check(err, "scatter_canvas")
    scatter_canvas.launches += 1
    return out


scatter_canvas.launches = 0
