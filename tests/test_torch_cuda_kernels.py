"""The hand-written CUDA kernels against their plain PyTorch versions,
on the card at the main path's shapes. This file imports no JAX, so it
runs where the card is:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Elsewhere every test skips (no card). Both kernels are exact copies of
their plain versions' arithmetic: canvas rows are copied bytes, and the
NMS kernel's IoU is built with -fmad=false, so the comparisons have no
tolerance."""

import numpy as np
import pytest
import torch

from de6d_tpu_torch.ops.kernels import canvas, nms_fused
from torch_fixtures import canvas_inputs, cuda_device, nms_boxes  # noqa: F401


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_canvas_kernel_equals_plain(cuda_device, dtype):  # noqa: F811
    ny, nx, v = 496, 432, 16000
    feats, lins = canvas_inputs(np.random.RandomState(5), 3, v, ny * nx,
                                (12000, 16000, 0))
    f = torch.from_numpy(feats).to(cuda_device, dtype)
    lin = torch.from_numpy(lins).to(cuda_device)
    before = canvas.scatter_canvas.launches
    got = canvas.scatter_canvas(f, lin, ny, nx)
    torch.cuda.synchronize()
    assert canvas.scatter_canvas.launches == before + 1
    assert torch.equal(got, canvas.scatter_canvas_plain(f, lin, ny, nx))


@pytest.mark.cuda
@pytest.mark.parametrize("p,post_k,spread", [(1024, 500, 40.0),
                                             (4096, 500, 80.0),
                                             (512, 512, 12.0)])
def test_nms_kernel_equals_plain(cuda_device, p, post_k, spread):  # noqa: F811
    rng = np.random.RandomState(4)
    boxes = torch.from_numpy(nms_boxes(rng, 8, p, spread=spread)).to(
        cuda_device)
    counts = torch.tensor([p, p // 2, 3, 0, p, 129, 128, p - 1],
                          dtype=torch.int32, device=cuda_device)
    before = nms_fused.nms_keep_batched.launches
    got = nms_fused.nms_keep_batched(boxes, counts, 0.01, post_k=post_k)
    torch.cuda.synchronize()
    assert nms_fused.nms_keep_batched.launches == before + 1
    ref = nms_fused.nms_keep_batched_plain(boxes, counts, 0.01, post_k)
    assert torch.equal(got, ref)
    assert got[:, :p // 2].any(), "test needs keeps"


@pytest.mark.cuda
def test_wrappers_reject_bad_input(cuda_device):  # noqa: F811
    f = torch.zeros(1, 4, 6, device=cuda_device)  # 24-byte rows
    lin = torch.zeros(1, 4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        canvas.scatter_canvas(f, lin, 2, 2)
    with pytest.raises(ValueError):
        nms_fused.nms_keep_batched(
            torch.zeros(1, 100, 7, device=cuda_device),
            torch.zeros(1, dtype=torch.int32, device=cuda_device), 0.1)
