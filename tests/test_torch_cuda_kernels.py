"""The hand-written CUDA kernels against their plain PyTorch versions,
on the card at the main paths' shapes. This file imports no JAX, so it
runs where the card is:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Elsewhere every test skips (no card). Every kernel is an exact copy of
its plain version's arithmetic: canvas rows are copied bytes, the NMS
IoU and the FPS distances are built with -fmad=false, and FPS picks are
indices (the f-fps kernel reads its keys from a matrix and only takes
minima), so the comparisons have no tolerance (the suppression mask is
compared whole, bit for bit). The key lookup returns indices (equal
everywhere). The sparse convolution sums in fp32 in another order than
the plain version's matmul: fp32 within 1e-5 absolute + 1e-5 relative,
bf16 within 1e-2 + 1e-2 (one bf16 rounding can move by 2^-7)."""

import numpy as np
import pytest
import torch

from de6d_tpu_torch.ops import iou3d, nms, sampling, sparse
from de6d_tpu_torch.ops.kernels import (
    canvas, fps, lookup, matrix_fps, nms_fused, nms_mask, sparse_conv,
)
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
                                             (512, 512, 12.0),
                                             (256, 256, 20.0)])  # Det6D
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
@pytest.mark.parametrize("p,thresh,spread", [
    (9000, 0.85, 40.0), (100, 0.1, 12.0), (1, 0.1, 12.0), (63, 0.1, 12.0),
    (64, 0.1, 12.0), (65, 0.1, 12.0), (130, 0.01, 12.0),
])
def test_nms_mask_kernel_equals_plain(cuda_device, p, thresh, spread):  # noqa: F811
    """Whole bit mask and the resolve's selections, ragged counts with
    0, 1 and P; one launch each for the batch."""
    rng = np.random.RandomState(p)
    b = 4
    boxes = torch.from_numpy(nms_boxes(rng, b, p, spread=spread)).to(
        cuda_device)
    counts = torch.tensor([p, p // 2, min(1, p - 1), 0], dtype=torch.int32,
                          device=cuda_device)
    packed = iou3d.pack_bev(boxes).contiguous()
    before = (nms_mask.nms_suppression_mask.launches,
              nms_mask.nms_resolve.launches)
    got = nms_mask.nms_suppression_mask(packed, counts, thresh)
    post = min(100, p)
    sel, nsel = nms_mask.nms_resolve(got, counts, post)
    torch.cuda.synchronize()
    assert (nms_mask.nms_suppression_mask.launches,
            nms_mask.nms_resolve.launches) == (before[0] + 1, before[1] + 1)
    ref = nms_mask.nms_suppression_mask_plain(packed, counts, thresh)
    assert torch.equal(got, ref)
    rsel, rnsel = nms_mask.nms_resolve_plain(ref, counts, post)
    assert torch.equal(sel, rsel) and torch.equal(nsel, rnsel)
    assert int(nsel[0]) > 0 and int(nsel[3]) == 0
    if p >= 63:
        assert bool((got[0] != 0).any()), "test needs overlaps"


@pytest.mark.cuda
def test_nms_on_the_card_equals_cpu(cuda_device):  # noqa: F811
    """``nms()`` batched on the card (kernels) against the CPU (plain
    versions) on the same boxes and scores."""
    rng = np.random.RandomState(11)
    boxes = torch.from_numpy(nms_boxes(rng, 3, 700, spread=20.0))
    scores = torch.from_numpy(rng.uniform(0, 1, (3, 700)).astype(np.float32))
    want = nms.nms(boxes, scores, 0.3, pre_maxsize=650, post_maxsize=100)
    got = nms.nms(boxes.to(cuda_device), scores.to(cuda_device), 0.3,
                  pre_maxsize=650, post_maxsize=100)
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(),
                                                              want[1])


@pytest.mark.cuda
def test_fps_kernel_on_roi_point_sets(cuda_device):  # noqa: F811
    """N = 512 < 1024 threads, 800 samples, every fifth one empty (an
    empty RoI): the kernel and the plain loop pick index 0 throughout."""
    rng = np.random.RandomState(12)
    xyz = torch.from_numpy(rng.uniform(-2, 2, (800, 512, 3)).astype(
        np.float32)).to(cuda_device)
    valid = (torch.arange(800, device=cuda_device) % 5 != 0)[:, None].expand(
        800, 512).contiguous()
    got = fps.fps(xyz, valid, 128)
    torch.cuda.synchronize()
    assert torch.equal(got, fps.fps_plain(xyz, valid, 128))
    assert not got[::5].any() and got[1].unique().numel() == 128


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 4096, 16384])
@pytest.mark.parametrize("weighted", [False, True], ids=["d-fps", "s-fps"])
def test_fps_kernel_equals_plain(cuda_device, weighted, n):  # noqa: F811
    """Clustered points (near-equal keys), a ragged valid mask with one
    empty sample, npoint above the valid count of another."""
    rng = np.random.RandomState(n)
    b, npoint = 4, n // 4
    xyz = rng.uniform(-40, 70, (b, n, 3)).astype(np.float32)
    xyz[:, : n // 2] = xyz[:, :1] + rng.normal(0, 0.5, (b, n // 2, 3))
    valid = np.ones((b, n), bool)
    valid[1, n // 8:] = False  # fewer valid points than picks
    valid[2] = False
    xyz_t = torch.from_numpy(xyz).to(cuda_device)
    valid_t = torch.from_numpy(valid).to(cuda_device)
    w = (torch.from_numpy(rng.random_sample((b, n)).astype(np.float32))
         .to(cuda_device) if weighted else None)
    before = fps.fps.launches
    got = fps.fps(xyz_t, valid_t, npoint, weights=w)
    torch.cuda.synchronize()
    assert fps.fps.launches == before + 1
    assert torch.equal(got, fps.fps_plain(xyz_t, valid_t, npoint, w))
    assert (got[2] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n,npoint", [(1, 4), (130, 64), (1000, 333),
                                      (2047, 256), (4096, 512), (5000, 64),
                                      (9000, 32)])
@pytest.mark.parametrize("ties", [False, True], ids=["real", "ties"])
def test_matrix_fps_kernel_equals_plain(cuda_device, n, npoint, ties):  # noqa: F811
    """An xyz-plus-feature matrix (or, with ``ties``, a lattice's matrix
    of many equal distances), a ragged valid mask with one empty sample
    and one with fewer valid points than picks; every register tiling of
    the kernel (N up to 1024, 2048, 4096, 8192, 16384)."""
    rng = np.random.RandomState(n)
    b = 4
    xyz = rng.uniform(-40, 70, (b, n, 3)).astype(np.float32)
    feats = None
    if ties:
        xyz = np.round(xyz / 4) * 4
    else:
        feats = torch.from_numpy(np.abs(rng.normal(0, 1, (b, n, 32))).astype(
            np.float32)).to(cuda_device)
    dm = sampling.calc_dist_matrix_for_sampling(
        torch.from_numpy(xyz).to(cuda_device), feats)
    counts = torch.tensor([n, max(n // 2, 1), min(n, npoint // 2), 0],
                          device=cuda_device)
    valid = torch.arange(n, device=cuda_device)[None] < counts[:, None]
    before = matrix_fps.matrix_fps.launches
    got = matrix_fps.matrix_fps(dm, valid, npoint)
    torch.cuda.synchronize()
    assert matrix_fps.matrix_fps.launches == before + 1
    assert torch.equal(got, matrix_fps.matrix_fps_plain(dm, valid, npoint))
    assert (got[3] == 0).all() and (got[:, 0] == 0).all()
    if n >= npoint:
        assert got[0].unique().numel() == npoint


@pytest.mark.cuda
def test_ffps_on_the_card_equals_cpu_on_the_same_matrix(cuda_device):  # noqa: F811
    """``matrix_farthest_point_sample`` on the card (kernel) against the
    CPU (plain loop) on one matrix; the matrix built on the card lies
    within twice the stated tolerance of the CPU's."""
    from chip_smoke import matrix_tolerance

    rng = np.random.RandomState(3)
    xyz = torch.from_numpy(rng.uniform(-40, 70, (2, 600, 3)).astype(
        np.float32))
    feats = torch.from_numpy(np.abs(rng.normal(0, 1, (2, 600, 64))).astype(
        np.float32))
    dm = sampling.calc_dist_matrix_for_sampling(xyz, feats)
    want = sampling.matrix_farthest_point_sample(dm, 200)
    got = sampling.matrix_farthest_point_sample(dm.to(cuda_device), 200)
    assert torch.equal(got.cpu(), want)
    on_card = sampling.calc_dist_matrix_for_sampling(
        xyz.to(cuda_device), feats.to(cuda_device)).cpu()
    norm = (xyz * xyz).sum(-1) + (feats * feats).sum(-1)
    tol = matrix_tolerance(norm[:, :, None] + norm[:, None, :])
    assert bool(((on_card - dm).abs() <= 2 * tol).all())


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
    with pytest.raises(ValueError):
        fps.fps(torch.zeros(1, 16385, 3, device=cuda_device),
                torch.ones(1, 16385, dtype=torch.bool, device=cuda_device), 4)
    with pytest.raises(TypeError):
        fps.fps(torch.zeros(1, 8, 3, device=cuda_device, dtype=torch.float64),
                torch.ones(1, 8, dtype=torch.bool, device=cuda_device), 4)
    with pytest.raises(TypeError):
        matrix_fps.matrix_fps(
            torch.zeros(1, 8, 8, device=cuda_device, dtype=torch.float64),
            torch.ones(1, 8, dtype=torch.bool, device=cuda_device), 4)
    with pytest.raises(ValueError):  # the mask on another device
        matrix_fps.matrix_fps(torch.zeros(1, 8, 8, device=cuda_device),
                              torch.ones(1, 8, dtype=torch.bool), 4)
    counts = torch.ones(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # fp64 corners
        nms_mask.nms_suppression_mask(
            torch.zeros(2, 9, 8, device=cuda_device, dtype=torch.float64),
            counts, 0.1)
    with pytest.raises(ValueError):  # counts on another device
        nms_mask.nms_suppression_mask(
            torch.zeros(2, 9, 8, device=cuda_device), counts.cpu(), 0.1)
    with pytest.raises(ValueError):  # counts of another batch
        nms_mask.nms_resolve(
            torch.zeros(2, 8, 1, dtype=torch.int64, device=cuda_device),
            counts[:1], 4)


def lookup_inputs(rng, b, v, q, fill):
    """(tables (b, v) with ``fill`` keys each, ascending, INVALID tail;
    queries (b, q), half of them present)."""
    tables = np.full((b, v), sparse.INVALID, np.int32)
    queries = np.empty((b, q), np.int32)
    for i in range(b):
        u = np.unique(rng.randint(0, 41 * 1600 * 1408, fill + fill // 8 + 1))
        u = u[:fill]
        tables[i, :len(u)] = u
        present = u[rng.randint(0, max(len(u), 1), q)] if len(u) else 0
        queries[i] = np.where(rng.random_sample(q) < 0.5, present,
                              rng.randint(-5, 41 * 1600 * 1408, q))
    queries[:, :7] = sparse.INVALID
    return tables, queries


@pytest.mark.cuda
@pytest.mark.parametrize("v,q,fill", [
    (16000, 432000, 12500),   # a served submanifold table
    (4000, 12000, 4000),      # full table, the z-conv's queries
    (16000, 5000, 0),         # empty table
    (40000, 100000, 40000),   # beyond the TPU kernel's 16384 cap
    (120000, 200000, 90000),  # searched in global memory
    (1, 10, 1),
])
def test_lookup_kernel_equals_plain(cuda_device, v, q, fill):  # noqa: F811
    tables, queries = lookup_inputs(np.random.RandomState(v), 3, v, q, fill)
    t = torch.from_numpy(tables).to(cuda_device)
    qk = torch.from_numpy(queries).to(cuda_device)
    before = lookup.lookup.launches
    idx, hit = lookup.lookup(t, qk)
    torch.cuda.synchronize()
    assert lookup.lookup.launches == before + 1
    ridx, rhit = lookup.lookup_plain(t, qk)
    assert torch.equal(hit, rhit) and torch.equal(idx, ridx)
    assert bool(hit.any()) == (fill > 0)
    cidx, chit = lookup.lookup(t.cpu(), qk.cpu())
    assert torch.equal(chit, hit.cpu()) and torch.equal(cidx, idx.cpu())


def conv_inputs(rng, b, v, q, k, cin, cout, dtype, device):
    """Random features, a random neighbour table with ~20 % hits and a
    ragged valid prefix per sample."""
    f = torch.from_numpy(rng.randn(b, v, cin).astype(np.float32))
    idx = torch.from_numpy(rng.randint(0, v, (b, q, k)).astype(np.int32))
    hit = torch.from_numpy(rng.random_sample((b, q, k)) < 0.2)
    w = torch.from_numpy((rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(
        np.float32))
    valid = torch.arange(q)[None] < torch.tensor([q, q // 2, 0][:b])[:, None]
    return (f.to(device, dtype), idx.to(device), hit.to(device),
            w.to(device, dtype), valid.to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v,q,k,cin,cout", [
    (16000, 16000, 27, 4, 16),   # conv_input
    (16000, 8000, 27, 32, 64),   # a strided layer
    (8000, 8000, 27, 64, 64),
    (4000, 4000, 3, 64, 128),    # the (3, 1, 1) z-conv
    (3000, 1000, 27, 48, 40),    # Cin the TPU kernel refuses
    (100, 70, 5, 1, 1),
])
def test_sparse_conv_kernel_equals_plain(cuda_device, dtype, v, q, k, cin,  # noqa: F811
                                         cout):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    args = conv_inputs(np.random.RandomState(q + cin), 3, v, q, k, cin, cout,
                       dtype, cuda_device)
    before = sparse_conv.sparse_conv.launches
    got = sparse_conv.sparse_conv(*args)
    torch.cuda.synchronize()
    assert sparse_conv.sparse_conv.launches == before + 1
    ref = sparse_conv.sparse_conv_plain(*args)
    assert got.dtype == dtype and got.shape == (3, q, cout)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    d = (got.float() - ref.float()).abs()
    assert bool((d <= tol * (1 + ref.float().abs())).all()), float(d.max())
    assert not got[2].any() and not got[1, q // 2:].any()


@pytest.mark.cuda
def test_sparse_wrappers_reject_bad_input(cuda_device):  # noqa: F811
    t = torch.zeros(2, 8, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):  # queries on another device
        lookup.lookup(t, t.cpu())
    with pytest.raises(TypeError):
        lookup.lookup(t.long(), t.long())
    args = conv_inputs(np.random.RandomState(0), 2, 10, 10, 27, 8, 129,
                       torch.float32, cuda_device)
    with pytest.raises(ValueError):  # Cout above 128
        sparse_conv.sparse_conv(*args)
    f, idx, hit, w, valid = conv_inputs(np.random.RandomState(0), 2, 10, 10,
                                        27, 8, 16, torch.float32, cuda_device)
    with pytest.raises(TypeError):  # fp16 features
        sparse_conv.sparse_conv(f.half(), idx, hit, w.half(), valid)
    with pytest.raises(ValueError):  # valid on another device
        sparse_conv.sparse_conv(f, idx, hit, w, valid.cpu())
