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

import copy

import numpy as np
import pytest
import torch

from de6d_tpu_torch.ops import iou3d, nms, sampling, sparse
from de6d_tpu_torch.ops.kernels import (
    canvas, fps, lookup, matrix_fps, nms_fused, nms_mask, sparse_conv,
)
from torch_fixtures import (  # noqa: F401
    adversarial_boxes, canvas_inputs, cuda_device, nms_boxes,
    sparse_site_keys,
)


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
@pytest.mark.parametrize("p,post_k,spread,thresh", [
    (1024, 500, 40.0, 0.01),   # PointPillars' and SECOND's prefix
    (4096, 500, 80.0, 0.01),
    (4096, 4096, 80.0, 0.01),  # no truncation
    (512, 512, 12.0, 0.85),
    (256, 256, 20.0, 0.01),    # Det6D, 3DSSD, IA-SSD
    (256, 256, 4.0, 1e-3),     # everything overlaps
    (384, 100, 20.0, 0.0),     # below the pre-test's floor
])
def test_nms_kernel_equals_plain(cuda_device, p, post_k, spread,  # noqa: F811
                                 thresh):
    """Keep flags identical to the plain version, ragged counts with 0."""
    rng = np.random.RandomState(4)
    boxes = torch.from_numpy(nms_boxes(rng, 8, p, spread=spread)).to(
        cuda_device)
    counts = torch.tensor([p, p // 2, 3, 0, p, 129, 128, p - 1],
                          dtype=torch.int32, device=cuda_device)
    before = nms_fused.nms_keep_batched.launches
    got = nms_fused.nms_keep_batched(boxes, counts, thresh, post_k=post_k)
    torch.cuda.synchronize()
    assert nms_fused.nms_keep_batched.launches == before + 1
    ref = nms_fused.nms_keep_batched_plain(boxes, counts, thresh, post_k)
    assert torch.equal(got, ref)
    assert got[:, :p // 2].any(), "test needs keeps"
    assert not got[3].any()


@pytest.mark.cuda
@pytest.mark.parametrize("width", [7, 9])
def test_nms_corners_equal_pack_bev(cuda_device, width):  # noqa: F811
    """The corners the NMS kernel builds equal ``iou3d.pack_bev``'s bit
    for bit: random, adversarial and far-off boxes, yaw up to +-100."""
    rng = np.random.RandomState(width)
    boxes = np.concatenate([
        nms_boxes(rng, 1, 1000, spread=80.0)[0],
        adversarial_boxes(rng, far=(0.0, 70.0, 1e3), n_random=20)], axis=0)
    boxes[::7, 6] = rng.uniform(-100, 100, len(boxes[::7]))
    extra = rng.randn(len(boxes), width - 7).astype(np.float32)
    t = torch.from_numpy(np.concatenate([boxes, extra], 1)[None]).to(
        cuda_device).repeat(2, 1, 1)
    got = nms_fused.pack_bev(t)
    want = iou3d.pack_bev(t[..., :7]).contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


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
def test_sfps_weights_with_a_graph(cuda_device):  # noqa: F811
    """s-fps at Det6D's SA2 shape with weights from requires-grad logits
    under ``enable_grad`` (the train step's case): the kernel's picks equal
    the plain version's, carry no graph, and a backward through the
    weights at the picks reaches the logits only there."""
    rng = np.random.RandomState(21)
    xyz = torch.from_numpy(rng.uniform(-40, 70, (8, 4096, 3)).astype(
        np.float32)).to(cuda_device)
    valid = torch.ones(8, 4096, dtype=torch.bool, device=cuda_device)
    logits = torch.nn.Parameter(torch.from_numpy(
        rng.normal(0, 2, (8, 4096)).astype(np.float32)).to(cuda_device))
    before = fps.fps.launches
    with torch.enable_grad():
        w = torch.sigmoid(logits)
        got = sampling.weighted_farthest_point_sample(xyz, w, 1024, valid)
        assert got.grad_fn is None and not got.requires_grad
        torch.gather(w, 1, got.long()).sum().backward()
    torch.cuda.synchronize()
    assert fps.fps.launches == before + 1
    assert torch.equal(got, fps.fps_plain(xyz, valid, 1024, w.detach()))
    picked = torch.zeros_like(valid).scatter_(1, got.long(), True)
    assert torch.equal(logits.grad != 0, picked)


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
    (120000, 200000, 90000),  # windows beyond shared memory
    (1, 10, 1),
    (16000, 432000, -12500),  # sorted runs: a submanifold table's keys
])
def test_lookup_kernel_equals_plain(cuda_device, v, q, fill):  # noqa: F811
    if fill < 0:  # the neighbour keys of a submanifold table
        grid = (41, 1600, 1408)
        tables = sparse_site_keys(np.random.RandomState(v), grid, v,
                                  (-fill, -fill // 2, 0))
        t = torch.from_numpy(tables).to(cuda_device)
        coords = lookup.keys_to_coords(t, grid)
        nbr = coords[:, :, None] + lookup.kernel_offsets(
            (3, 3, 3), cuda_device)[None, None]
        qk = lookup.coords_to_keys(nbr, grid, (t != sparse.INVALID)[
            ..., None]).reshape(3, -1)
    else:
        tables, queries = lookup_inputs(np.random.RandomState(v), 3, v, q,
                                        fill)
        t = torch.from_numpy(tables).to(cuda_device)
        qk = torch.from_numpy(queries).to(cuda_device)
    before = lookup.lookup.launches
    idx, hit = lookup.lookup(t, qk)
    torch.cuda.synchronize()
    assert lookup.lookup.launches == before + 1
    ridx, rhit = lookup.lookup_plain(t, qk)
    assert torch.equal(hit, rhit) and torch.equal(idx, ridx)
    assert bool(hit.any()) == (fill != 0)
    cidx, chit = lookup.lookup(t.cpu(), qk.cpu())
    assert torch.equal(chit, hit.cpu()) and torch.equal(cidx, idx.cpu())


NBR_CASES = {
    # (grid, V, counts, ask: "self" or (ask grid, counts), kernel, stride,
    #  padding, centered)
    "subm_s1": ((41, 1600, 1408), 16000, (12500, 16000, 0), "self",
                (3, 3, 3), (1, 1, 1), (0, 0, 0), True),
    "subm_s4": ((5, 200, 176), 4000, (4000, 2500, 1), "self", (3, 3, 3),
                (1, 1, 1), (0, 0, 0), True),
    "down_s2": ((41, 1600, 1408), 16000, (12500, 900, 0),
                ((21, 800, 704), (16000, 700, 30)), (3, 3, 3), (2, 2, 2),
                (1, 1, 1), False),
    "down_s4": ((11, 400, 352), 8000, (8000, 5000, 0),
                ((5, 200, 176), (4000, 4000, 9)), (3, 3, 3), (2, 2, 2),
                (0, 1, 1), False),
    "down_z": ((5, 200, 176), 4000, (4000, 3000, 0),
               ((2, 200, 176), (4000, 1000, 0)), (3, 1, 1), (2, 1, 1),
               (0, 0, 0), False),
    # a table whose windows outgrow shared memory, and a 1 x 1 x 5 kernel
    "v40000_k5": ((41, 1600, 1408), 40000, (40000, 20000, 0), "self",
                  (1, 1, 5), (1, 1, 1), (0, 0, 0), True),
    "tiny_grid": ((3, 4, 5), 60, (60, 17, 0), "self", (3, 3, 3), (1, 1, 1),
                  (0, 0, 0), True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("order", ["sorted", "invalid_rows", "shuffled"])
@pytest.mark.parametrize("case", sorted(NBR_CASES))
def test_neighbor_table_kernel_equals_plain(cuda_device, case, order):  # noqa: F811
    """``idx`` and ``hit`` identical to ``neighbor_table_plain`` everywhere
    (misses, out-of-grid neighbours and INVALID rows included): sites on
    every grid face, INVALID tails, a sample without sites; asking rows
    sorted (the served order), with INVALID rows inside, or shuffled."""
    grid, v, counts, ask, kernel, stride, padding, centered = \
        NBR_CASES[case]
    rng = np.random.RandomState(len(case))
    keys = torch.from_numpy(sparse_site_keys(rng, grid, v, counts)).to(
        cuda_device)
    if ask == "self":
        ask_grid, ask_keys = grid, keys.clone()
    else:
        ask_grid, ask_counts = ask
        ask_keys = torch.from_numpy(sparse_site_keys(
            rng, ask_grid, max(ask_counts), ask_counts)).to(cuda_device)
    if order == "invalid_rows":
        drop = torch.from_numpy(rng.rand(*ask_keys.shape) < 0.3).to(
            cuda_device)
        ask_keys = torch.where(drop, sparse.INVALID, ask_keys)
    elif order == "shuffled":
        ask_keys = ask_keys[:, torch.randperm(ask_keys.shape[1],
                                              device=cuda_device)]
    ask_keys = ask_keys.contiguous()
    before = lookup.neighbor_table.launches
    idx, hit = lookup.neighbor_table(keys, ask_keys, grid, ask_grid, kernel,
                                     stride, padding, centered)
    torch.cuda.synchronize()
    assert lookup.neighbor_table.launches == before + 1
    ridx, rhit = lookup.neighbor_table_plain(keys, ask_keys, grid, ask_grid,
                                             kernel, stride, padding,
                                             centered)
    assert torch.equal(hit, rhit) and torch.equal(idx, ridx)
    assert bool(hit.any())


@pytest.mark.cuda
def test_neighbor_table_without_table_launches_nothing(cuda_device):  # noqa: F811
    """A (B, 0) table on the card gives the plain version's all-miss
    answer with no launch and no plain path run there."""
    grid = (41, 1600, 1408)
    keys = torch.zeros((2, 0), dtype=torch.int32, device=cuda_device)
    ask_keys = torch.from_numpy(sparse_site_keys(
        np.random.RandomState(0), grid, 300, (300, 7))).to(cuda_device)
    before = lookup.neighbor_table.launches
    idx, hit = lookup.neighbor_table(keys, ask_keys, grid, grid, (3, 3, 3))
    assert lookup.neighbor_table.launches == before
    ridx, rhit = lookup.neighbor_table_plain(keys.cpu(), ask_keys.cpu(),
                                             grid, grid, (3, 3, 3))
    assert idx.is_cuda and hit.is_cuda
    assert torch.equal(idx.cpu(), ridx) and torch.equal(hit.cpu(), rhit)


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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 1023, 1024, 1025, 4096, 16384])
@pytest.mark.parametrize("weighted", [False, True], ids=["d-fps", "s-fps"])
def test_fps_every_cluster_size_equals_plain(cuda_device, weighted, n):  # noqa: F811
    """Every cluster size the kernel takes for N, and the dispatched one:
    npoint up to N, an all-invalid sample, fewer valid points than picks
    and an integer lattice (exact ties) with integer weights."""
    rng = np.random.RandomState(n + 7)
    xyz = rng.uniform(-40, 70, (4, n, 3)).astype(np.float32)
    side = int(round(n ** (1 / 3))) + 1
    lattice = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                       -1).reshape(-1, 3)[:n]
    xyz[3] = lattice
    valid = np.ones((4, n), bool)
    valid[1] = False
    valid[2, max(1, n // 3):] = False
    xyz_t = torch.from_numpy(xyz).to(cuda_device)
    valid_t = torch.from_numpy(valid).to(cuda_device)
    w = (torch.from_numpy(np.floor(rng.uniform(0, 4, (4, n))).astype(
        np.float32)).to(cuda_device) if weighted else None)
    npoint = min(n, 4096)
    ref = fps.fps_plain(xyz_t, valid_t, npoint, w)
    assert (ref[1] == 0).all()
    before = fps.fps.launches
    assert torch.equal(fps.fps(xyz_t, valid_t, npoint, weights=w), ref)
    assert fps.fps.launches == before + 1
    for c in fps.cluster_sizes(n):
        got = fps.fps_cluster(xyz_t, valid_t, npoint, w, cluster=c)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), c
    assert fps.fps.launches == before + 1  # forced variants do not count


@pytest.mark.cuda
def test_fps_dispatch_takes_a_cluster_at_the_served_shape(cuda_device):  # noqa: F811
    """Batch 8 x 16384 runs on clusters; 800 RoI point sets of 512 points
    and N <= 1024 on one CTA per sample; the floor kernels launch."""
    assert fps.dispatch(8, 16384, False) >= 2
    assert fps.dispatch(8, 16384, True) >= 2
    assert fps.dispatch(800, 512, False) == 1
    assert fps.dispatch(8, 1024, True) == 1
    assert fps.cluster_sizes(16384) == (2, 4, 8, 16)
    c = fps.dispatch(8, 16384, False)
    out = fps.cluster_rounds(16, 8, c, fps.threads(16384, c), cuda_device)
    single = fps.argmax_rounds(16, 8, cuda_device)
    torch.cuda.synchronize()
    assert out.shape == (8 * c,) and single.shape == (8,)
    with pytest.raises(ValueError):
        fps.fps_cluster(torch.zeros(1, 9000, 3, device=cuda_device),
                        torch.ones(1, 9000, dtype=torch.bool,
                                   device=cuda_device), 4, cluster=1)


@pytest.mark.cuda
@pytest.mark.parametrize("thresh", [-0.1, 0.0, 0.1, 0.85])
def test_nms_mask_kernel_on_adversarial_boxes(cuda_device, thresh):  # noqa: F811
    """Touching, 1e-6 m-apart and parallel-edge pairs, 1e-3 m and 1e4 m
    boxes, identical, zero-size and mirrored boxes: the whole mask equals
    the plain version's, with and without the pre-test."""
    rng = np.random.RandomState(13)
    boxes = adversarial_boxes(rng, far=(0.0, 5e3), n_random=300)
    boxes = np.stack([boxes, boxes[rng.permutation(len(boxes))]])
    packed = iou3d.pack_bev(torch.from_numpy(boxes).to(cuda_device)
                            ).contiguous()
    p = packed.shape[-1]
    counts = torch.tensor([p, p - 5], dtype=torch.int32, device=cuda_device)
    got = nms_mask.nms_suppression_mask(packed, counts, thresh)
    torch.cuda.synchronize()
    ref = nms_mask.nms_suppression_mask_plain(packed, counts, thresh)
    assert torch.equal(got, ref)
    live = sum(c * (c - 1) // 2 for c in counts.tolist())
    survivors = int(nms_mask.survivors_plain(packed, counts, thresh).sum())
    assert survivors == live if thresh < nms_mask.MIN_THRESH else \
        survivors < live


@pytest.mark.cuda
def test_grad_guard_on_the_card(cuda_device):  # noqa: F811
    """scatter_canvas on a requires-grad input returns a tensor with a
    grad_fn whose gradient (the backward kernel) equals the CPU plain
    version's bit for bit; sparse_conv under enable_grad has a grad_fn
    and its gradients come from its backward kernels (the data gradient
    by the forward kernel, the weight gradient by its own), within 1e-5
    of the CPU plain autograd's."""
    feats, lins = canvas_inputs(np.random.RandomState(1), 1, 32, 48, (20,))
    ct = torch.from_numpy(np.random.RandomState(2).standard_normal(
        (1, 6, 8, 64)).astype(np.float32))
    cpu = torch.from_numpy(feats).requires_grad_(True)
    canvas.scatter_canvas(cpu, torch.from_numpy(lins), 6, 8).backward(ct)
    f = torch.from_numpy(feats).to(cuda_device).requires_grad_(True)
    lin = torch.from_numpy(lins).to(cuda_device)
    before = canvas.scatter_canvas_grad.launches
    with torch.enable_grad():
        out = canvas.scatter_canvas(f, lin, 6, 8)
        assert out.grad_fn is not None
        out.backward(ct.to(cuda_device))
    torch.cuda.synchronize()
    assert canvas.scatter_canvas_grad.launches == before + 1
    assert torch.equal(out.detach().cpu(), canvas.scatter_canvas_plain(
        cpu.detach(), torch.from_numpy(lins), 6, 8))
    assert torch.equal(f.grad.cpu(), cpu.grad)

    keys = torch.from_numpy(sparse_site_keys(
        np.random.RandomState(3), (9, 14, 12), 300, (300, 200)))
    feats = torch.from_numpy(np.random.RandomState(4).standard_normal(
        (2, 300, 8)).astype(np.float32))
    w = torch.from_numpy(np.random.RandomState(5).standard_normal(
        (27, 8, 16)).astype(np.float32) * 0.2)
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        k = keys.to(dev)
        fd = feats.to(dev).clone().requires_grad_(True)
        wd = w.to(dev).clone().requires_grad_(True)
        before = (sparse_conv.sparse_conv_dgrad.launches,
                  sparse_conv.sparse_conv_wgrad.launches)
        with torch.enable_grad():
            y = sparse.subm_conv_table(fd, *sparse.subm_neighbor_table(
                k, (9, 14, 12)), wd, k != sparse.INVALID)
            assert y.grad_fn is not None
            y.square().sum().backward()
        grads.append((fd.grad.cpu(), wd.grad.cpu()))
        launched = (sparse_conv.sparse_conv_dgrad.launches - before[0],
                    sparse_conv.sparse_conv_wgrad.launches - before[1])
        assert launched == ((1, 1) if dev.type == "cuda" else (0, 0))
    for got, want in zip(*grads):
        assert float((got - want).abs().max()) <= 1e-5 * float(
            want.abs().max())


def on_scattered(dy, w, scattered):
    """The forward kernel on the scattered transpose with transposed
    weights: the data gradient of any table (kernel 7 as the data gradient
    runs it, without the mirrored read)."""
    return sparse_conv.sparse_conv(dy, scattered[0], scattered[1],
                                   w.transpose(1, 2).contiguous(),
                                   scattered[2])


def conv_grad_inputs(rng, strided, dtype, device, cin=16, cout=32):
    """A SECOND-like layer on sites of a (21, 80, 70) grid: (features,
    idx, hit, weights, valid, grad_out, V, the transpose its conv hands
    the backward: ``Strided`` geometry or ``Submanifold``)."""
    grid = (21, 80, 70)
    keys = torch.from_numpy(sparse_site_keys(rng, grid, 8000,
                                             (8000, 5000, 0)))
    v = keys.shape[1]
    if strided:
        out_keys, out_grid = sparse.downsample_coords(keys, grid, (2, 2, 2),
                                                      (1, 1, 1), 4000)
        idx, hit = sparse.strided_neighbor_table(
            keys, out_keys, grid, out_grid, (3, 3, 3), (2, 2, 2), (1, 1, 1))
        valid = out_keys != sparse.INVALID
        transpose = sparse_conv.Strided(
            keys.to(device), out_keys.to(device), grid, out_grid, (3, 3, 3),
            (2, 2, 2), (1, 1, 1))
    else:
        idx, hit = sparse.subm_neighbor_table(keys, grid)
        valid = keys != sparse.INVALID
        transpose = sparse_conv.Submanifold()
    q = idx.shape[1]
    f = torch.from_numpy(rng.standard_normal((3, v, cin)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((27, cin, cout))
                          / np.sqrt(27 * cin)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((3, q, cout)).astype(
        np.float32))
    return (f.to(device, dtype), idx.to(device), hit.to(device),
            w.to(device, dtype), valid.to(device), dy.to(device, dtype), v,
            transpose)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("strided", [False, True], ids=["subm", "strided"])
def test_sparse_conv_backward_kernels_equal_plain(cuda_device, dtype,  # noqa: F811
                                                  strided):
    """The data gradient (the forward kernel on the table's transpose:
    the submanifold table itself through the mirrored offsets, or the
    strided layer's transposed table built from its geometry), the
    weight-gradient kernel (bit-equal over two runs) and the transposed
    table's kernel (equal to its plain version and to the scatter of the
    forward table) against their plain versions; each launch counted
    once, a mirrored data gradient also in ``sparse_conv_dgrad.mirrored``
    and no transposed table for it; fp32 within 1e-5 and bf16 within 1e-2
    of each result's largest |entry|."""
    torch.backends.cuda.matmul.allow_tf32 = False
    f, idx, hit, w, valid, dy, v, transpose = conv_grad_inputs(
        np.random.RandomState(7), strided, dtype, cuda_device)
    counts = (sparse_conv.sparse_conv_dgrad.launches,
              sparse_conv.sparse_conv_dgrad.mirrored,
              sparse_conv.sparse_conv_wgrad.launches,
              lookup.transposed_table.launches)
    dg = sparse_conv.sparse_conv_dgrad(dy, idx, hit, w, valid, v, transpose)
    wg = sparse_conv.sparse_conv_wgrad(f, dy, idx, hit, valid)
    wg2 = sparse_conv.sparse_conv_wgrad(f, dy, idx, hit, valid)
    torch.cuda.synchronize()
    assert (sparse_conv.sparse_conv_dgrad.launches - counts[0],
            sparse_conv.sparse_conv_dgrad.mirrored - counts[1],
            sparse_conv.sparse_conv_wgrad.launches - counts[2],
            lookup.transposed_table.launches - counts[3]) == (
        (1, 0, 2, 1) if strided else (1, 1, 2, 0))
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want in (
            (dg, sparse_conv.sparse_conv_dgrad_plain(dy, idx, hit, w, valid,
                                                     v)),
            (wg, sparse_conv.sparse_conv_wgrad_plain(f, dy, idx, hit,
                                                     valid))):
        assert got.dtype == dtype and got.shape == want.shape
        d = float((got.float() - want.float()).abs().max())
        assert d <= tol * float(want.float().abs().max()), d
    assert torch.equal(wg, wg2)
    assert not dg[2].any()  # the empty sample
    scattered = sparse_conv.sparse_conv_transpose_plain(idx, hit, valid, v)
    if strided:
        tr = lookup.transposed_table(*transpose)
        for a, b in zip(tr, scattered):
            assert torch.equal(a, b)
    else:
        assert torch.equal(scattered[1], hit.flip(-1))
    assert torch.equal(dg, on_scattered(dy, w, scattered))


# a SECOND train step's 7 submanifold data gradients: (V at batch 4, the
# data gradient's Cin, Cout: the layer's Cout, Cin), then edges
SUBM_DGRAD = {
    "subm_s1": (16000, 16, 16, (3, 3, 3)),
    "subm_s2a": (16000, 32, 32, (3, 3, 3)),
    "subm_s2b": (16000, 32, 32, (3, 3, 3)),
    "subm_s3a": (8000, 64, 64, (3, 3, 3)),
    "subm_s3b": (8000, 64, 64, (3, 3, 3)),
    "subm_s4a": (4000, 64, 64, (3, 3, 3)),
    "subm_s4b": (4000, 64, 64, (3, 3, 3)),
    "k1": (16000, 16, 16, (1, 1, 1)),
    "v1": (1, 16, 32, (3, 3, 3)),
    "empty_sample": (8000, 64, 64, (3, 3, 3)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(SUBM_DGRAD))
def test_mirrored_dgrad_equals_the_kernel_on_the_scattered_transpose(  # noqa: F811
        cuda_device, dtype, case):
    """A submanifold layer's data gradient on its own table through the
    mirrored offsets (one launch, counted as mirrored, no transposed
    table) is bit-equal to the same kernel on the scattered transpose
    (``sparse_conv_transpose_plain`` on the card), at SECOND's 7
    submanifold shapes, K = 1, V = 1 and a sample without sites; within
    1e-5 (fp32) / 1e-2 (bf16) of the plain data gradient."""
    torch.backends.cuda.matmul.allow_tf32 = False
    v, cin, cout, kernel = SUBM_DGRAD[case]
    counts = {"v1": (1, 1, 0, 1),
              "empty_sample": (v // 2, 0, v, v // 3)}.get(
        case, (v * 9 // 10, v // 2, v, v // 4))
    grid = (41, 400, 352)
    rng = np.random.RandomState(sum(map(ord, case)))
    keys = torch.from_numpy(sparse_site_keys(rng, grid, v, counts)).to(
        cuda_device)
    idx, hit = sparse.subm_neighbor_table(keys, grid, kernel)
    valid = keys != sparse.INVALID
    k = idx.shape[2]
    w = torch.from_numpy((rng.standard_normal((k, cout, cin))
                          / np.sqrt(k * cout)).astype(np.float32)).to(
        cuda_device, dtype)  # the forward's (K, Cin, Cout) is (k, cout, cin)
    dy = torch.from_numpy(rng.standard_normal((4, v, cin)).astype(
        np.float32)).to(cuda_device, dtype)
    before = (sparse_conv.sparse_conv_dgrad.launches,
              sparse_conv.sparse_conv_dgrad.mirrored,
              lookup.transposed_table.launches)
    got = sparse_conv.sparse_conv_dgrad(dy, idx, hit, w, valid, v,
                                        sparse_conv.Submanifold())
    torch.cuda.synchronize()
    assert (sparse_conv.sparse_conv_dgrad.launches - before[0],
            sparse_conv.sparse_conv_dgrad.mirrored - before[1],
            lookup.transposed_table.launches - before[2]) == (1, 1, 0)
    scattered = sparse_conv.sparse_conv_transpose_plain(idx, hit, valid, v)
    assert torch.equal(scattered[1], hit.flip(-1))
    want = on_scattered(dy, w, scattered)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)
    plain = sparse_conv.sparse_conv_dgrad_plain(dy, idx, hit, w, valid, v)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    d = float((got.float() - plain.float()).abs().max())
    assert d <= tol * max(1.0, float(plain.float().abs().max())), d
    if case == "empty_sample":
        assert not got[1].any()
    sparse_conv.raise_mirror_fault()  # the table keeps the contract


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["valid_subset", "partial_ask"])
def test_mirrored_dgrad_raises_on_a_table_that_breaks_the_contract(  # noqa: F811
        cuda_device, dtype, case):
    """A submanifold table whose ``valid`` is a strict subset of the rows
    that asked, or whose valid rows did not all ask, is not its own
    transpose through the mirrored offsets: the kernel sets its fault
    word, and once the launch has finished the check raises (directly,
    and at the next data gradient's entry), then is clear again."""
    grid, v = (21, 80, 70), 4000
    rng = np.random.RandomState(11)
    keys = torch.from_numpy(sparse_site_keys(rng, grid, v, (v, v // 2))).to(
        cuda_device)
    sites = keys != sparse.INVALID
    if case == "valid_subset":
        idx, hit = sparse.subm_neighbor_table(keys, grid)
        valid = sites.clone()
        valid[:, 1::4] = False
    else:
        ask = sites.clone()
        ask[:, ::3] = False
        idx, hit = sparse.subm_neighbor_table(keys, grid, valid=ask)
        valid = sites
    w = torch.from_numpy(rng.standard_normal((27, 32, 16)).astype(
        np.float32)).to(cuda_device, dtype)
    dy = torch.from_numpy(rng.standard_normal((2, v, 16)).astype(
        np.float32)).to(cuda_device, dtype)
    good = (*sparse.subm_neighbor_table(keys, grid), sites)
    sparse_conv.raise_mirror_fault()

    def dgrad(table):
        return sparse_conv.sparse_conv_dgrad(dy, table[0], table[1], w,
                                             table[2], v,
                                             sparse_conv.Submanifold())

    dgrad((idx, hit, valid))
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="submanifold table"):
        sparse_conv.raise_mirror_fault()
    sparse_conv.raise_mirror_fault()  # cleared
    dgrad((idx, hit, valid))
    torch.cuda.synchronize()
    with pytest.raises(ValueError, match="submanifold table"):
        dgrad(good)
    dgrad(good)
    torch.cuda.synchronize()
    sparse_conv.raise_mirror_fault()


# a SECOND train step's 4 strided layers (input V at batch 4, input grid,
# kernel, stride, padding, output cap), then edges
STRIDED_TABLES = {
    "down_s2": (16000, (41, 1600, 1408), (3, 3, 3), (2, 2, 2), (1, 1, 1),
                16000),
    "down_s3": (16000, (21, 800, 704), (3, 3, 3), (2, 2, 2), (1, 1, 1),
                8000),
    "down_s4": (8000, (11, 400, 352), (3, 3, 3), (2, 2, 2), (0, 1, 1), 4000),
    "down_z": (4000, (5, 200, 176), (3, 1, 1), (2, 1, 1), (0, 0, 0), 4000),
    "z_layer_2": (4000, (5, 200, 176), (2, 1, 1), (2, 1, 1), (0, 0, 0),
                  4000),
    "capped": (16000, (21, 80, 70), (3, 3, 3), (2, 2, 2), (1, 1, 1), 500),
    "large": (120000, (41, 1600, 1408), (3, 3, 3), (2, 2, 2), (1, 1, 1),
              60000),
    "empty_sample": (8000, (11, 400, 352), (3, 3, 3), (2, 2, 2), (1, 1, 1),
                     4000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(STRIDED_TABLES))
def test_transposed_table_kernel_equals_plain(cuda_device, case):  # noqa: F811
    """The strided layer's transposed table on the card (one launch,
    every entry written) equals its plain version
    (``lookup.transposed_table_plain``) and the scatter of the forward
    table (``sparse_conv_transpose_plain``) exactly, at SECOND's 4 strided
    shapes, a (2, 1, 1) z-layer, outputs dropped by the cap, a
    120,000-key table and a sample without sites; with INVALID rows
    among the asking keys it equals its plain version."""
    v, grid, kernel, stride, padding, cap = STRIDED_TABLES[case]
    rng = np.random.RandomState(sum(map(ord, case)))
    counts = (v * 9 // 10, 0, v, v // 3) if case == "empty_sample" else (
        v * 9 // 10, v // 2, v, v // 4)
    keys = torch.from_numpy(sparse_site_keys(rng, grid, v, counts)).to(
        cuda_device)
    out_keys, out_grid = sparse.downsample_coords(keys, grid, stride,
                                                  padding, cap, kernel)
    geometry = sparse_conv.Strided(keys, out_keys, grid, out_grid, kernel,
                                   stride, padding)
    idx, hit = sparse.strided_neighbor_table(*geometry)
    valid = out_keys != sparse.INVALID
    before = lookup.transposed_table.launches
    got = lookup.transposed_table(*geometry)
    torch.cuda.synchronize()
    assert lookup.transposed_table.launches == before + 1
    scattered = sparse_conv.sparse_conv_transpose_plain(idx, hit, valid, v)
    for a, b, c in zip(got, lookup.transposed_table_plain(*geometry),
                       scattered):
        assert a.dtype == b.dtype and torch.equal(a, b) and torch.equal(a, c)
    assert int(got[1].sum()) == int((hit & valid[..., None]).sum()) > 0
    masked = keys.clone()
    masked[:, 5::7] = sparse.INVALID
    shuffled = geometry._replace(keys_sorted=masked)
    for a, b in zip(lookup.transposed_table(*shuffled),
                    lookup.transposed_table_plain(*shuffled)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_second_backbone_backward_launches(cuda_device):  # noqa: F811
    """A train-mode VoxelBackBone8x forward and backward on the card (fp32,
    SECOND's widths and grid depth, 4 samples, the voxel features needing
    no gradient, as MeanVFE's): 8 neighbour tables, 12 convs, 11 data
    gradients of which the 7 submanifold ones run on their own tables
    (mirrored), 4 transposed tables (the strided layers) and 12 weight
    gradients; every weight's gradient within 1e-4 of its largest |entry|
    of the CPU plain autograd's."""
    from de6d_tpu_torch.models.backbones_3d.spconv_backbone import (
        VoxelBackBone8x,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {"NUM_FILTERS": [16, 16, 32, 64, 64], "OUT_CHANNELS": 128,
           "MAX_VOXELS_PER_STAGE": [3000, 3000, 1500, 750]}
    torch.manual_seed(0)
    model = VoxelBackBone8x(cfg, 4, (176, 200, 40)).train()
    rng = np.random.RandomState(9)
    keys = sparse_site_keys(rng, (40, 200, 176), 3000, (3000, 2500, 0, 900))
    coords = np.stack(np.unravel_index(np.where(
        keys == sparse.INVALID, 0, keys), (40, 200, 176)), -1)
    coords[keys == sparse.INVALID] = -1
    feats = rng.standard_normal((4, 3000, 4)).astype(np.float32)
    kernels = (lookup.neighbor_table, sparse_conv.sparse_conv,
               sparse_conv.sparse_conv_dgrad, sparse_conv.sparse_conv_wgrad,
               lookup.transposed_table)
    grads = {}
    for dev in (cuda_device, torch.device("cpu")):
        m = copy.deepcopy(model).to(dev)
        before = [fn.launches for fn in kernels] + [
            sparse_conv.sparse_conv_dgrad.mirrored]
        with torch.enable_grad():
            out = m({"voxel_features": torch.from_numpy(feats).to(dev),
                     "voxel_coords": torch.from_numpy(coords).to(dev)})
            out["encoded_spconv_tensor"].square().sum().backward()
        grads[dev.type] = {n: p.grad.cpu() for n, p in m.named_parameters()
                           if n.endswith("weight") and p.dim() == 3}
        after = [fn.launches for fn in kernels] + [
            sparse_conv.sparse_conv_dgrad.mirrored]
        launched = [a - b for a, b in zip(after, before)]
        assert launched == ([8, 12, 11, 12, 4, 7] if dev.type == "cuda"
                            else [0] * 6), launched
    assert len(grads["cpu"]) == 12
    for name, want in grads["cpu"].items():
        assert float(want.abs().max()) > 0, name
        d = float((grads["cuda"][name] - want).abs().max())
        assert d <= 1e-4 * float(want.abs().max()), (name, d)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["train_batch", "all_invalid", "one_slot",
                                  "nchw_view"])
def test_canvas_grad_kernel_equals_plain(cuda_device, dtype,  # noqa: F811
                                         case):
    """The backward kernel against ``scatter_canvas_grad_plain``, bit for
    bit: PointPillars' training shape (4 x 16000 x 64 with an invalid
    suffix), every slot invalid, V = 1, and a non-contiguous cotangent
    (the NHWC view of an NCHW tensor)."""
    ny, nx = 496, 432
    v, counts = {"train_batch": (16000, (12000, 16000, 9000, 0)),
                 "all_invalid": (16000, (0, 0, 0, 0)),
                 "one_slot": (1, (1, 0, 1, 1)),
                 "nchw_view": (16000, (15000, 7000, 16000, 1))}[case]
    rng = np.random.RandomState(6)
    _, lins = canvas_inputs(rng, 4, v, ny * nx, counts, c=1)
    ct = torch.from_numpy(rng.standard_normal((4, ny, nx, 64)).astype(
        np.float32)).to(cuda_device, dtype)
    if case == "nchw_view":
        ct = ct.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        assert not ct.is_contiguous()
    lin = torch.from_numpy(lins).to(cuda_device)
    before = canvas.scatter_canvas_grad.launches
    got = canvas.scatter_canvas_grad(ct, lin)
    torch.cuda.synchronize()
    assert canvas.scatter_canvas_grad.launches == before + 1
    assert got.dtype == dtype and got.shape == (4, v, 64)
    assert torch.equal(got, canvas.scatter_canvas_grad_plain(ct, lin))


@pytest.mark.cuda
def test_tiny_train_step_on_the_card(cuda_device):  # noqa: F811
    """Three fp32 train steps of the tiny PointPillars (TF32 off) on the
    card against the same steps on the CPU: each loss within 1e-4
    relative, one canvas forward and one backward launch a step."""
    import copy
    from pathlib import Path

    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models import build_network
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        DatasetSpec,
    )
    from de6d_tpu_torch.train import (
        build_optimizer_and_schedule, create_train_state, make_train_step,
    )
    from torch_fixtures import spec_kwargs

    cfg = cfg_from_yaml_file(str(Path(__file__).resolve().parents[1]
                                 / "configs/kitti_models/pointpillar_tiny.yaml"))
    spec = DatasetSpec(**spec_kwargs(cfg))
    torch.manual_seed(0)
    model = build_network(copy.deepcopy(cfg.MODEL), 1, spec, device="cpu")
    rng = np.random.RandomState(7)
    pts = np.zeros((2, 2048, 4), np.float32)
    for i in range(3):
        pts[..., i] = rng.uniform(spec.point_cloud_range[i],
                                  spec.point_cloud_range[i + 3], (2, 2048))
    gt = np.zeros((2, 4, 8), np.float32)
    gt[:, :3] = [10.0, 2.0, -1.0, 3.9, 1.6, 1.5, 0.3, 1.0]
    gt[:, 1, :2] = [30.0, -8.0]
    gt[:, 2, :2] = [5.0, 12.0]
    batch = {"points": torch.from_numpy(pts),
             "points_mask": torch.ones(2, 2048, dtype=torch.bool),
             "gt_boxes": torch.from_numpy(gt)}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        losses = {}
        for dev in ("cpu", cuda_device):
            m = copy.deepcopy(model).to(dev)
            opt, _ = build_optimizer_and_schedule(dict(cfg.OPTIMIZATION), m, 1)
            state = create_train_state(m, opt)
            step = make_train_step(m, opt)
            fwd, bwd = canvas.scatter_canvas.launches, \
                canvas.scatter_canvas_grad.launches
            b = {k: v.to(dev) for k, v in batch.items()}
            losses[str(dev)] = [float(step(state, b)[1]["loss"])
                                for _ in range(3)]
            if dev != "cpu":
                assert canvas.scatter_canvas.launches - fwd == 3
                assert canvas.scatter_canvas_grad.launches - bwd == 3
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    np.testing.assert_allclose(losses[str(cuda_device)], losses["cpu"],
                               rtol=1e-4)


def sorted_key_conv_inputs(rng, b, n_keys, cin, cout, k, dtype, device):
    """Features over ``n_keys`` sorted voxel keys per sample in a small
    grid (dense enough that most offsets hit), the submanifold table
    that ``sparse.subm_neighbor_table`` builds from them (27 offsets) or
    its first ``k`` offsets, and seeded weights."""
    grid = (8, 40, 40)
    keys = np.full((b, n_keys + 37), sparse.INVALID, np.int32)
    for i in range(b):  # sample i holds n_keys / (i + 1) keys
        u = np.unique(rng.randint(0, int(np.prod(grid)), 2 * n_keys))
        keys[i, :n_keys // (i + 1)] = u[:n_keys // (i + 1)]
    keys_t = torch.from_numpy(keys).to(device)
    idx, hit = sparse.subm_neighbor_table(keys_t, grid)
    idx, hit = idx[..., :k].contiguous(), hit[..., :k].contiguous()
    f = torch.from_numpy(rng.randn(b, keys.shape[1], cin).astype(np.float32))
    w = torch.from_numpy((rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(
        np.float32))
    return (f.to(device, dtype), idx, hit, w.to(device, dtype),
            keys_t != sparse.INVALID)


@pytest.mark.cuda
@pytest.mark.parametrize("table", ["sorted_keys", "random"])
@pytest.mark.parametrize("cin,cout,k", [
    (4, 16, 27), (16, 32, 27), (32, 64, 27), (64, 64, 27), (64, 128, 3),
    (48, 40, 27), (1, 1, 5), (3, 40, 27), (6, 8, 27), (64, 128, 27),
    (160, 24, 7),
])
def test_sparse_conv_every_variant_equals_plain(cuda_device, table, cin,  # noqa: F811
                                                cout, k):
    """Every bf16 variant that takes the shape (resident and streamed
    weights) within 1e-2 + 1e-2 of the plain version, on a sorted-key
    table and a random one; the dispatched launch is counted and reports
    the planned variant."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    rng = np.random.RandomState(cin * 131 + cout + k)
    if table == "random":
        args = conv_inputs(rng, 3, 3000, 2000, k, cin, cout, torch.bfloat16,
                           cuda_device)
    else:
        args = sorted_key_conv_inputs(rng, 3, 2000, cin, cout, k,
                                      torch.bfloat16, cuda_device)
    ref = sparse_conv.sparse_conv_plain(*args).float()
    ran = []
    for name in ("resident", "streamed"):
        if sparse_conv.plan(cin, cout, k, variant=name) is None:
            continue
        got = sparse_conv.sparse_conv_variant(*args, variant=name)
        torch.cuda.synchronize()
        assert sparse_conv.launched_variant() == name
        d = (got.float() - ref).abs()
        assert bool((d <= 1e-2 * (1 + ref.abs())).all()), (name, float(d.max()))
        assert not got[~args[4]].any()
        ran.append(name)
    assert "streamed" in ran
    before = sparse_conv.sparse_conv.launches
    got = sparse_conv.sparse_conv(*args)
    torch.cuda.synchronize()
    assert sparse_conv.sparse_conv.launches == before + 1
    assert sparse_conv.launched_variant() == sparse_conv.plan(cin, cout,
                                                              k).variant


@pytest.mark.cuda
def test_sparse_conv_plan_equals_the_library(cuda_device):  # noqa: F811
    """The Python mirrors of the variant rule (fp32 "simt" with its
    weights resident or streamed, bf16 "resident" / "streamed") and of the
    weight gradient's tile give what the library computes, for every
    variant, both dtypes and edge shapes."""
    for cin in (1, 3, 4, 16, 32, 48, 64, 65, 128, 160, 512):
        for cout in (1, 8, 16, 40, 64, 127, 128):
            for k in (1, 3, 5, 27, 33, 125):
                for dtype in (torch.float32, torch.bfloat16):
                    for variant in (None, "simt", "resident", "streamed"):
                        assert sparse_conv.library_plan(
                            cin, cout, k, dtype, variant) == sparse_conv.plan(
                            cin, cout, k, dtype, variant), (
                            cin, cout, k, dtype, variant)
            for dtype in (torch.float32, torch.bfloat16):
                assert sparse_conv.library_wgrad_plan(
                    cin, cout, dtype) == sparse_conv.wgrad_plan(
                    cin, cout, dtype), (cin, cout, dtype)


@pytest.mark.cuda
def test_sparse_conv_edge_tiles(cuda_device):  # noqa: F811
    """A tile with no hit, a tile with a single hit, K > 32 (two offset
    blocks) and Cin over 64 (two channel chunks), both variants."""
    rng = np.random.RandomState(9)
    f, idx, hit, w, valid = conv_inputs(rng, 2, 500, 400, 40, 96, 32,
                                        torch.bfloat16, cuda_device)
    hit[:, :128] = False  # the first tile: no hit
    hit[:, 128:256] = False
    hit[:, 130, 35] = True  # the second: one hit, in the second block
    ref = sparse_conv.sparse_conv_plain(f, idx, hit, w, valid).float()
    for name in ("resident", "streamed"):
        if sparse_conv.plan(96, 32, 40, variant=name) is None:
            continue
        got = sparse_conv.sparse_conv_variant(f, idx, hit, w, valid,
                                              variant=name).float()
        torch.cuda.synchronize()
        assert not got[:, :128].any() and not got[:, 131:256].any()
        d = (got - ref).abs()
        assert bool((d <= 1e-2 * (1 + ref.abs())).all()), (name, float(d.max()))


# (Cin, Cout, K) of SECOND's 12 layers (7 distinct shapes), and edge
# shapes: Cin 1, 4, 48, 65; Cout 1, 40, 128; K 1, 3, 5, 27
SECOND_CONV_SHAPES = [(4, 16, 27), (16, 16, 27), (16, 32, 27), (32, 32, 27),
                      (32, 64, 27), (64, 64, 27), (64, 128, 3)]
CONV_EDGE_SHAPES = [(1, 16, 27), (4, 1, 27), (48, 40, 27), (65, 128, 27),
                    (16, 40, 1), (48, 1, 3), (65, 40, 5), (1, 128, 5)]


def fma32(a, w, acc):
    """fp32 ``fma(a, w, acc)`` (one rounding) from float64 operations: the
    product of two fp32 values is exact in float64, the sum's rounding
    error is recovered exactly (TwoSum), and a float64 sum that lies
    exactly halfway between two fp32 values is moved to the side of its
    error before the tie would be broken to even."""
    s = a.double() * w.double()
    t = acc.double()
    total = s + t
    bb = total - s
    err = (s - (total - bb)) + (t - bb)
    r = total.float()
    back = r.double()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.full_like(r, float("-inf")))
    tie_up = (total - back) * 2 == up.double() - back
    tie_down = (back - total) * 2 == back - down.double()
    r = torch.where(tie_up & (err > 0), up, r)
    return torch.where(tie_down & (err < 0), down, r)


def fma_chain(features, idx, hit, weights, valid):
    """What the fp32 kernel computes, exactly: each output element's sum as
    one sequence of fp32 FMAs, live offsets ascending, then input channels
    ascending (a dense walk that multiplies misses by zero adds nothing)."""
    cin = features.shape[2]
    acc = features.new_zeros((*idx.shape[:2], weights.shape[2]))
    rows = torch.where(hit, idx, 0).long()
    for k in range(idx.shape[2]):
        g = torch.gather(features, 1,
                         rows[:, :, k, None].expand(-1, -1, cin))
        live = (hit[:, :, k] & valid)[..., None]
        for c in range(cin):
            acc = torch.where(live, fma32(g[..., c, None], weights[k, c],
                                          acc), acc)
    return torch.where(valid[..., None], acc, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout,k", SECOND_CONV_SHAPES + CONV_EDGE_SHAPES)
def test_sparse_conv_fp32_is_the_dense_fma_chain(cuda_device, cin, cout,  # noqa: F811
                                                 k):
    """The fp32 kernel skips the rows without a hit, and still rounds every
    output element as the dense walk of the first SIMT kernel did: equal,
    bit for bit, to :func:`fma_chain`; within 1e-5 of the plain version;
    one counted launch of the planned variant, with a misaligned feature
    view (4-byte copies) giving the same bits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(cin * 1009 + cout * 31 + k)
    args = sorted_key_conv_inputs(rng, 3, 600, cin, cout, k, torch.float32,
                                  cuda_device)
    before = sparse_conv.sparse_conv.launches
    got = sparse_conv.sparse_conv(*args)
    torch.cuda.synchronize()
    assert sparse_conv.sparse_conv.launches == before + 1
    assert sparse_conv.launched_variant() == "simt"
    want = fma_chain(*args)
    assert torch.equal(got, want), float((got - want).abs().max())
    ref = sparse_conv.sparse_conv_plain(*args)
    assert bool(((got - ref).abs() <= 1e-5 * (1 + ref.abs())).all())
    f = args[0]
    spare = torch.empty(f.numel() + 1, device=cuda_device)[1:]
    shifted = spare.view(f.shape).copy_(f)
    assert shifted.data_ptr() % 8 == 4
    got2 = sparse_conv.sparse_conv(shifted, *args[1:])
    assert torch.equal(got2, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cin,cout,k", SECOND_CONV_SHAPES + CONV_EDGE_SHAPES)
def test_sparse_conv_gradients_at_every_tile(cuda_device, dtype, cin, cout,  # noqa: F811
                                             k):
    """The data gradient (the forward kernel on the table's transpose: the
    mirrored table at K = 27, the scattered transpose for the first k < 27
    offsets, which are no layer's) and
    the weight gradient (the tile of ``wgrad_plan`` for the widths) within
    1e-5 (fp32) / 1e-2 (bf16) of each plain version's largest |entry|, on
    a non-contiguous cotangent; the weight gradient bit-equal over two
    runs and its plan the library's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(cin * 7 + cout * 3 + k)
    f, idx, hit, w, valid = sorted_key_conv_inputs(rng, 3, 600, cin, cout,
                                                   k, dtype, cuda_device)
    dy = torch.from_numpy(rng.standard_normal(
        (3, idx.shape[1], 2 * cout)).astype(np.float32)).to(
        cuda_device, dtype)[..., ::2]
    assert not dy.is_contiguous()
    v = f.shape[1]
    # the first k of 27 offsets: a submanifold table only at k = 27
    dg = sparse_conv.sparse_conv_dgrad(
        dy, idx, hit, w, valid, v, sparse_conv.Submanifold()) if k == 27 \
        else on_scattered(dy, w, sparse_conv.sparse_conv_transpose_plain(
            idx, hit, valid, v))
    wg = sparse_conv.sparse_conv_wgrad(f, dy, idx, hit, valid)
    wg2 = sparse_conv.sparse_conv_wgrad(f, dy, idx, hit, valid)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for got, want in (
            (dg, sparse_conv.sparse_conv_dgrad_plain(dy, idx, hit, w, valid,
                                                     v)),
            (wg, sparse_conv.sparse_conv_wgrad_plain(f, dy, idx, hit,
                                                     valid))):
        assert got.dtype == dtype and got.shape == want.shape
        d = float((got.float() - want.float()).abs().max())
        assert d <= tol * float(want.float().abs().max()), d
    assert torch.equal(wg, wg2)
    assert sparse_conv.library_wgrad_plan(cin, cout, dtype) == \
        sparse_conv.wgrad_plan(cin, cout, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sparse_conv_edge_cases_forward_and_gradients(cuda_device, dtype):  # noqa: F811
    """A tile without a hit next to one with a single hit, every row
    invalid, V = 1, a misaligned feature view and a non-contiguous
    cotangent: the forward (every variant of the dtype), the data gradient
    (on the scattered transpose: these tables are no layer's) and the
    weight gradient against their plain versions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(21)
    f, idx, hit, w, valid = sorted_key_conv_inputs(rng, 2, 1000, 16, 32, 27,
                                                   dtype, cuda_device)
    no_hit = hit.clone()
    no_hit[:, :256] = False
    no_hit[:, 130, 13] = True
    idx_one = idx.clone()
    idx_one[:, 130, 13] = 0
    spare = torch.empty(f.numel() + 1, dtype=dtype, device=cuda_device)[1:]
    shifted = spare.view(f.shape).copy_(f)
    one = (torch.from_numpy(rng.standard_normal((2, 1, 16)).astype(
        np.float32)).to(cuda_device, dtype),
        torch.zeros((2, 1, 27), dtype=torch.int32, device=cuda_device),
        torch.zeros((2, 1, 27), dtype=torch.bool, device=cuda_device), w,
        torch.ones((2, 1), dtype=torch.bool, device=cuda_device))
    one[2][:, :, 13] = True
    cases = {
        "no_hit_tile": (f, idx_one, no_hit, w, valid),
        "all_invalid": (f, idx, hit, w, torch.zeros_like(valid)),
        "v1": one,
        "misaligned": (shifted, idx, hit, w, valid),
    }
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    names = ["simt"] if dtype == torch.float32 else ["resident", "streamed"]
    for label, args in cases.items():
        ref = sparse_conv.sparse_conv_plain(*args).float()
        for name in names:
            got = sparse_conv.sparse_conv_variant(*args, variant=name).float()
            torch.cuda.synchronize()
            d = (got - ref).abs()
            assert bool((d <= tol * (1 + ref.abs())).all()), (label, name)
        if label == "no_hit_tile":
            assert not got[:, :128].any() and not got[:, 131:256].any()
        if label == "all_invalid":
            assert not got.any()
        fz, iz, hz, wz, vz = args
        dy = torch.from_numpy(rng.standard_normal(
            (iz.shape[0], iz.shape[1], 2 * wz.shape[2])).astype(
            np.float32)).to(cuda_device, dtype)[..., ::2]
        v = fz.shape[1]
        dg = on_scattered(dy, wz, sparse_conv.sparse_conv_transpose_plain(
            iz, hz, vz, v))
        wg = sparse_conv.sparse_conv_wgrad(fz, dy, iz, hz, vz)
        torch.cuda.synchronize()
        for got, want in (
                (dg, sparse_conv.sparse_conv_dgrad_plain(dy, iz, hz, wz, vz,
                                                         v)),
                (wg, sparse_conv.sparse_conv_wgrad_plain(fz, dy, iz, hz,
                                                         vz))):
            d = float((got.float() - want.float()).abs().max())
            assert d <= tol * max(1.0, float(want.float().abs().max())), (
                label, d)
        if label == "all_invalid":
            assert not dg.any() and not wg.any()


def tied_matrix(rng, b, n):
    """A symmetric matrix of small integers: many equal maxima, in every
    CTA's slice of the columns."""
    dm = rng.randint(0, 4, (b, n, n)).astype(np.float32)
    dm = np.maximum(dm, dm.transpose(0, 2, 1))
    dm[:, np.arange(n), np.arange(n)] = 0.0
    return dm


@pytest.mark.cuda
@pytest.mark.parametrize("n,npoint", [(1, 3), (512, 256), (1000, 333),
                                      (4095, 512), (4096, 512), (4100, 300),
                                      (16384, 64)])
@pytest.mark.parametrize("ties", [False, True], ids=["real", "ties"])
def test_matrix_fps_every_cluster_size_equals_plain(cuda_device, n, npoint,  # noqa: F811
                                                    ties):
    """Every cluster size and the dispatched launch: picks identical to
    the plain loop on a ragged mask (an empty sample, fewer valid points
    than picks)."""
    rng = np.random.RandomState(n + 3)
    b = 3 if n <= 4100 else 2
    if ties:
        dm = torch.from_numpy(tied_matrix(rng, b, n)).to(cuda_device)
    else:
        xyz = torch.from_numpy(rng.uniform(-40, 70, (b, n, 3)).astype(
            np.float32)).to(cuda_device)
        dm = sampling.calc_dist_matrix_for_sampling(xyz)
    counts = torch.tensor([n, min(n, npoint // 2), 0][:b],
                          device=cuda_device)
    valid = torch.arange(n, device=cuda_device)[None] < counts[:, None]
    ref = matrix_fps.matrix_fps_plain(dm, valid, npoint)
    before = matrix_fps.matrix_fps.launches
    assert torch.equal(matrix_fps.matrix_fps(dm, valid, npoint), ref)
    assert matrix_fps.matrix_fps.launches == before + 1
    for c in matrix_fps.CLUSTER_SIZES:
        got = matrix_fps.matrix_fps_cluster(dm, valid, npoint, cluster=c)
        torch.cuda.synchronize()
        assert torch.equal(got, ref), c
    assert matrix_fps.matrix_fps.launches == before + 1


@pytest.mark.cuda
def test_matrix_fps_dispatch(cuda_device):  # noqa: F811
    """SA2 (8 x 4096) runs on clusters, SA3 (8 x 512) on one CTA per
    sample; every variant's threads are a floor kernel's block size."""
    assert matrix_fps.dispatch(8, 4096) >= 2
    assert matrix_fps.dispatch(8, 512) == 1
    for n in (1, 512, 4096, 16384):
        for c in matrix_fps.CLUSTER_SIZES:
            assert matrix_fps.threads(n, c) in (256, 512, 1024)
    with pytest.raises(ValueError):
        matrix_fps.matrix_fps_cluster(
            torch.zeros(1, 8, 8, device=cuda_device),
            torch.ones(1, 8, dtype=torch.bool, device=cuda_device), 4,
            cluster=3)


@pytest.mark.cuda
def test_fps_kernel_at_pvrcnn_keypoints(cuda_device):  # noqa: F811
    """PV-RCNN's keypoints: 8 x 16384 -> 2048 d-fps, clustered points,
    ragged valid counts (one sample below 2048 valid points, one empty);
    one launch, the plain loop's picks."""
    rng = np.random.RandomState(2048)
    b, n = 8, 16384
    xyz = rng.uniform(-40, 70, (b, n, 3)).astype(np.float32)
    xyz[:, : n // 2] = xyz[:, :1] + rng.normal(0, 0.5, (b, n // 2, 3))
    valid = np.ones((b, n), bool)
    valid[1, 1500:] = False
    valid[2] = False
    valid[3, 12000:] = False
    xyz_t = torch.from_numpy(xyz).to(cuda_device)
    valid_t = torch.from_numpy(valid).to(cuda_device)
    before = fps.fps.launches
    got = fps.fps(xyz_t, valid_t, 2048)
    torch.cuda.synchronize()
    assert fps.fps.launches == before + 1
    assert torch.equal(got, fps.fps_plain(xyz_t, valid_t, 2048))
    assert (got[2] == 0).all() and got[0].unique().numel() == 2048


@pytest.mark.cuda
@pytest.mark.parametrize("p,thresh,post,spread", [
    (1024, 0.7, 100, 40.0),  # PV-RCNN's proposals: 8 x 1024 -> 100 RoIs
    (100, 0.1, 100, 12.0),   # its final NMS over the 100 RoIs
])
def test_nms_mask_kernel_at_pvrcnn_shapes(cuda_device, p, thresh, post,  # noqa: F811
                                          spread):
    """Batch 8, every candidate live but in one ragged sample; the whole
    bit mask and the resolve's selections equal the plain versions'."""
    rng = np.random.RandomState(p + 1)
    boxes = torch.from_numpy(nms_boxes(rng, 8, p, spread=spread)).to(
        cuda_device)
    counts = torch.full((8,), p, dtype=torch.int32, device=cuda_device)
    counts[5] = p // 3
    packed = iou3d.pack_bev(boxes).contiguous()
    before = (nms_mask.nms_suppression_mask.launches,
              nms_mask.nms_resolve.launches)
    got = nms_mask.nms_suppression_mask(packed, counts, thresh)
    sel, nsel = nms_mask.nms_resolve(got, counts, post)
    torch.cuda.synchronize()
    assert (nms_mask.nms_suppression_mask.launches,
            nms_mask.nms_resolve.launches) == (before[0] + 1, before[1] + 1)
    ref = nms_mask.nms_suppression_mask_plain(packed, counts, thresh)
    assert torch.equal(got, ref) and bool((got != 0).any())
    rsel, rnsel = nms_mask.nms_resolve_plain(ref, counts, post)
    assert torch.equal(sel, rsel) and torch.equal(nsel, rnsel)


@pytest.mark.cuda
def test_full_decode_anchor_head_on_the_card_equals_cpu(cuda_device):  # noqa: F811
    """PV-RCNN's anchor head decodes every anchor (a RoI head follows): on
    the card its (B, A, 7) boxes equal the CPU's within 1e-4 (exp and sqrt
    may round otherwise), and it writes no lazy decode. Inputs and
    weights are small multiples of powers of two, so the 1x1 convolutions
    are exact in any order and no yaw sits on a direction-bin edge in one
    run and off it in the other."""
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models.dense_heads.anchor_head import (
        AnchorHeadSingle,
    )

    cfg = cfg_from_yaml_file("configs/kitti_models/pv_rcnn.yaml")
    head = AnchorHeadSingle(dict(cfg.MODEL.DENSE_HEAD), 64, 3,
                            ("Car", "Pedestrian", "Cyclist"),
                            (1408, 1600, 40), (0, -40, -3, 70.4, 40, 1),
                            predict_boxes_when_training=True).eval()
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randint(-2, 3, p.shape, generator=gen) / 64.0)
    x = torch.randint(-2, 3, (2, 200, 176, 64), generator=gen).float()
    with torch.no_grad():
        want = head({"spatial_features_2d": x})
        got = head.to(cuda_device)({"spatial_features_2d": x.to(cuda_device)})
    assert "lazy_box_decode" not in got
    assert tuple(got["batch_box_preds"].shape) == (2, 211200, 7)
    assert torch.equal(got["batch_cls_preds"].cpu(), want["batch_cls_preds"])
    torch.testing.assert_close(got["batch_box_preds"].cpu(),
                               want["batch_box_preds"], rtol=1e-4, atol=1e-4)
