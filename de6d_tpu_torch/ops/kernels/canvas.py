"""BEV canvas scatter: key-sorted pillar rows → dense (B, ny, nx, C), and
its gradient.

Replaces the TPU kernel ``de6d_tpu/ops/pallas/canvas.py:scatter_canvas``
and its custom VJP (``_scatter_canvas_bwd``). Both CUDA kernels are in
``csrc/canvas.cu``. The forward: one block per tile of consecutive cells;
since ``lin`` is ascending, the tile's pillars are one contiguous range
found by binary search, and every cell of the tile is written exactly
once (its pillar's row or zeros) with 16-byte vector stores. It is bound
by bytes: at KITTI size it writes 8 x 214,272 x 64 x 2 B = 219 MB of bf16
canvas and reads 16 MB of features. The backward is the row gather
``d_feat[b, v] = d_canvas[b, lin[b, v]]`` (zeros at the invalid suffix),
one 16-byte vector a thread; on CUDA tensors :func:`scatter_canvas` is a
``torch.autograd.Function`` whose backward launches it.
"""

from __future__ import annotations

import torch

from . import build


def scatter_canvas_plain(feat, lin, ny: int, nx: int):
    """Plain PyTorch version: scatter slot ids into the grid, then gather
    one feature row per cell (the JAX package's non-Pallas path). Its
    autograd backward is the cell gather of
    :func:`scatter_canvas_grad_plain`."""
    bsz, v, c = feat.shape
    g = ny * nx
    lin = torch.where(lin < g, lin, g).long()
    ids = torch.full((bsz, g + 1), v, dtype=torch.long, device=feat.device)
    ids.scatter_(1, lin, torch.arange(v, device=feat.device).expand(bsz, v))
    fpad = torch.cat([feat, feat.new_zeros(bsz, 1, c)], dim=1)
    rows = torch.gather(fpad, 1, ids[:, :g, None].expand(-1, -1, c))
    return rows.reshape(bsz, ny, nx, c)


def scatter_canvas_grad_plain(d_canvas, lin):
    """Plain version of the backward: (B, ny, nx, C) cotangent + (B, V)
    cell ids → (B, V, C) in the cotangent's dtype, each valid slot's cell
    row, zeros where ``lin`` is not a cell."""
    bsz, ny, nx, c = d_canvas.shape
    g = ny * nx
    valid = (lin >= 0) & (lin < g)
    safe = torch.where(valid, lin, 0).long()
    rows = torch.gather(d_canvas.reshape(bsz, g, c), 1,
                        safe[..., None].expand(-1, -1, c))
    return torch.where(valid[..., None], rows, rows.new_zeros(()))


def _check(feat, lin, what):
    if feat.device.type != "cuda" or lin.device != feat.device:
        raise ValueError(f"{what}: unsupported devices "
                         f"{feat.device}, {lin.device}")
    if feat.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what}: dtype {feat.dtype}")
    if lin.dtype != torch.int32:
        raise TypeError(f"{what}: lin dtype {lin.dtype}")
    if (feat.shape[-1] * feat.element_size()) % 16:
        raise ValueError(f"{what}: C * itemsize must be a multiple of 16 "
                         "bytes")


def _launch_forward(feat, lin, ny, nx):
    bsz, v, c = feat.shape
    feat = feat.contiguous()
    lin = lin.contiguous()
    if feat.data_ptr() % 16:
        raise ValueError("scatter_canvas: feat must be 16-byte aligned")
    out = torch.empty((bsz, ny, nx, c), dtype=feat.dtype, device=feat.device)
    if out.numel() == 0:
        return out
    err = build.lib().de6d_scatter_canvas(
        feat.data_ptr(), lin.data_ptr(), out.data_ptr(),
        bsz, v, ny * nx, c * feat.element_size(),
        torch.cuda.current_stream(feat.device).cuda_stream,
    )
    build.check(err, "scatter_canvas")
    scatter_canvas.launches += 1
    return out


def scatter_canvas_grad(d_canvas, lin):
    """(B, ny, nx, C) cotangent + (B, V) int32 cell ids → (B, V, C)
    gradient of the pillar features: the kernel on CUDA tensors, the plain
    version on CPU tensors. A non-contiguous cotangent (the 2D backbone's
    channels-last views) is made contiguous in (B, ny, nx, C) order first."""
    if d_canvas.device.type == "cpu":
        return scatter_canvas_grad_plain(d_canvas, lin)
    _check(d_canvas, lin, "scatter_canvas_grad")
    bsz, ny, nx, c = d_canvas.shape
    if lin.ndim != 2 or lin.shape[0] != bsz:
        raise ValueError(f"scatter_canvas_grad: lin {tuple(lin.shape)} vs "
                         f"cotangent {tuple(d_canvas.shape)}")
    v = lin.shape[1]
    d_canvas = d_canvas.contiguous()
    lin = lin.contiguous()
    if d_canvas.data_ptr() % 16:
        raise ValueError("scatter_canvas_grad: cotangent must be 16-byte "
                         "aligned")
    out = torch.empty((bsz, v, c), dtype=d_canvas.dtype,
                      device=d_canvas.device)
    if out.numel() == 0:
        return out
    err = build.lib().de6d_scatter_canvas_grad(
        d_canvas.data_ptr(), lin.data_ptr(), out.data_ptr(),
        bsz, v, ny * nx, c * d_canvas.element_size(),
        torch.cuda.current_stream(d_canvas.device).cuda_stream,
    )
    build.check(err, "scatter_canvas_grad")
    scatter_canvas_grad.launches += 1
    return out


class _ScatterCanvas(torch.autograd.Function):
    """The CUDA forward with the CUDA cell gather as its backward."""

    @staticmethod
    def forward(ctx, feat, lin, ny, nx):
        ctx.save_for_backward(lin)
        return _launch_forward(feat, lin, ny, nx)

    @staticmethod
    def backward(ctx, d_canvas):
        (lin,) = ctx.saved_tensors
        d_feat = None
        if ctx.needs_input_grad[0]:
            d_feat = scatter_canvas_grad(d_canvas, lin)
        return d_feat, None, None, None


def scatter_canvas(feat, lin, ny: int, nx: int):
    """(B, V, C) pillar features + (B, V) int32 linear cell ids →
    (B, ny, nx, C) canvas; cells with no pillar are 0. Differentiable in
    ``feat``.

    ``lin`` must hold unique ascending ids for the valid slots followed
    by an invalid suffix of ids >= ny*nx (the voxelizer's slot order).
    CPU tensors take the plain version; CUDA tensors launch the kernel,
    and its gradient launches the backward kernel.
    """
    if feat.device.type == "cpu":
        return scatter_canvas_plain(feat, lin, ny, nx)
    _check(feat, lin, "scatter_canvas")
    bsz, v, _ = feat.shape
    if lin.shape != (bsz, v):
        raise ValueError(f"scatter_canvas: lin {tuple(lin.shape)} vs "
                         f"feat {tuple(feat.shape)}")
    return _ScatterCanvas.apply(feat, lin, ny, nx)


scatter_canvas.launches = 0
scatter_canvas_grad.launches = 0
