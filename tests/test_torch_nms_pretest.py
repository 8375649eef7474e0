"""The NMS kernels' bound pre-test (``csrc/nms_pretest.cuh``, shared by
``csrc/nms_mask.cu`` and ``csrc/nms_fused.cu``) by its plain twin
``ops/kernels/nms_pretest.py:skippable_plain``: a pair it
skips must have a bit of 0, so its overlap must be exactly 0 in the
port's plain IoU (the kernel's arithmetic) and its IoU not above
``thresh`` in the JAX package's ``iou3d.boxes_iou_bev`` too, on boxes
that touch, lie 1e-6 m apart, have parallel edges, sit at the pre-test's
own margin, or measure 1e-2 m to 1e4 m far from the origin. The fused
NMS's plain version with the pre-test applied to its kept-vs-column and
diagonal pairs keeps the same boxes as without it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from de6d_tpu.ops import iou3d as jax_iou3d
from de6d_tpu_torch.ops import iou3d
from de6d_tpu_torch.ops.kernels import nms_fused
from de6d_tpu_torch.ops.kernels import nms_mask as nm
from torch_fixtures import adversarial_boxes, nms_boxes

THRESHOLDS = (1e-3, 0.1, 0.85)


def _aabb(box):
    """float64 BEV bounds of one (7,) box."""
    c, s = np.cos(box[6]), np.sin(box[6])
    hx, hy = box[3] / 2, box[4] / 2
    xs = box[0] + np.array([hx, hx, -hx, -hx]) * c - np.array(
        [hy, -hy, -hy, hy]) * s
    ys = box[1] + np.array([hx, hx, -hx, -hx]) * s + np.array(
        [hy, -hy, -hy, hy]) * c
    return xs.min(), xs.max(), ys.min(), ys.max()


def pair_boxes(rng, n_pairs, size, offset):
    """2 * n_pairs boxes: box 2k random around ``offset``, box 2k + 1
    beside it along x or y with bounds ``gap`` apart, the gap drawn from
    touching, 1e-6 m, overlapping, and the pre-test's margin delta times
    0.5 ... 10, with the same yaw, a right angle more, or another yaw."""
    boxes = []
    for _ in range(n_pairs):
        a = np.array([offset + rng.uniform(-3, 3) * size,
                      -offset + rng.uniform(-3, 3) * size, 0.0,
                      size * rng.uniform(0.5, 2), size * rng.uniform(0.5, 2),
                      1.5, rng.choice([0.0, np.pi / 2, rng.uniform(-3, 3)])])
        b = a.copy()
        b[3:5] = size * rng.uniform(0.5, 2, 2)
        b[6] = rng.choice([a[6], a[6] + np.pi / 2, rng.uniform(-3, 3)])
        s_max = abs(offset) + 8 * size
        delta = nm.GAP_ABS + nm.GAP_REL * s_max
        gap = rng.choice([0.0, 1e-6, -0.1 * size, 0.5 * delta, 0.99 * delta,
                          1.01 * delta, 2 * delta, 10 * delta])
        ax0, ax1, ay0, ay1 = _aabb(a)
        bx0, bx1, by0, by1 = _aabb(b)
        if rng.rand() < 0.5:
            b[0] += ax1 + gap - bx0
            b[1] += rng.uniform(ay0 - by1, ay1 - by0)
        else:
            b[1] += ay1 + gap - by0
            b[0] += rng.uniform(ax0 - bx1, ax1 - bx0)
        boxes += [a, b]
    return np.asarray(boxes, np.float32)


def _check(boxes, thresh):
    """Every skipped pair has overlap exactly 0 in the plain IoU and IoU
    <= thresh in both packages; returns the number of skipped pairs."""
    t = torch.from_numpy(boxes)
    packed = iou3d.pack_bev(t)[None]
    skip = nm.skippable_plain(packed, thresh)[0].numpy()
    overlap = iou3d.pairwise_overlap_packed(packed, packed)[0].numpy()
    iou = iou3d.pairwise_iou_packed(packed, packed)[0].numpy()
    assert not (overlap[skip] != 0).any()
    assert not (iou[skip] > thresh).any()
    jiou = np.asarray(jax_iou3d.boxes_iou_bev(jnp.asarray(boxes),
                                              jnp.asarray(boxes)))
    assert not (jiou[skip] > thresh).any()
    return int(skip.sum())


@pytest.mark.parametrize("thresh", THRESHOLDS)
@pytest.mark.parametrize("size,offset", [
    (1e-2, 0.0), (0.1, 0.0), (1.0, 0.0), (4.0, 70.0), (4.0, 1e3),
    (100.0, 0.0), (1e4, 0.0), (1.0, 1e4),
])
def test_skipped_pairs_have_no_overlap(size, offset, thresh):
    rng = np.random.RandomState(int(size * 1000 + offset) % 2**31)
    boxes = pair_boxes(rng, 60, size, offset)
    assert _check(boxes, thresh) > 0, "test needs skipped pairs"


def test_adversarial_set():
    """Touching, 1e-6 m-apart and parallel-edge pairs, 1e-3 m and 1e4 m
    boxes, identical, zero-size and mirrored boxes, in one set."""
    boxes = adversarial_boxes(np.random.RandomState(5))
    for thresh in THRESHOLDS:
        _check(boxes, thresh)
    packed = iou3d.pack_bev(torch.from_numpy(boxes))[None]
    skip = nm.skippable_plain(packed, 0.1)[0]
    # the 1e-3 m, zero-size and mirrored boxes are never skipped
    n = len(boxes)
    for k in list(range(n - 16, n - 10)) + [n - 2, n - 1]:
        assert not skip[k].any() and not skip[:, k].any()


@settings(max_examples=150, deadline=None, derandomize=True, database=None)
@given(size=st.floats(1e-2, 50.0), offset=st.floats(-1e4, 1e4),
       yaw_a=st.floats(-np.pi, np.pi), yaw_b=st.floats(-np.pi, np.pi),
       gap=st.floats(0.0, 0.05), along_x=st.booleans())
def test_skipped_pair_has_no_overlap_hypothesis(size, offset, yaw_a, yaw_b,
                                                gap, along_x):
    a = np.array([offset, offset, 0, size, size * 0.4, 1.5, yaw_a])
    b = np.array([offset, offset, 0, size * 0.7, size, 1.5, yaw_b])
    ax0, ax1, ay0, ay1 = _aabb(a)
    bx0, bx1, by0, by1 = _aabb(b)
    if along_x:
        b[0] += ax1 + gap - bx0
    else:
        b[1] += ay1 + gap - by0
    packed = iou3d.pack_bev(torch.from_numpy(np.stack([a, b]).astype(
        np.float32)))[None]
    for thresh in THRESHOLDS:
        if bool(nm.skippable_plain(packed, thresh)[0, 0, 1]):
            assert float(iou3d.pairwise_overlap_packed(
                packed[..., :1], packed[..., 1:])) == 0.0


@pytest.mark.parametrize("thresh", [-0.1, 0.0, 5e-4])
def test_no_pair_is_skipped_below_the_threshold_floor(thresh):
    boxes = pair_boxes(np.random.RandomState(2), 20, 1.0, 0.0)
    packed = iou3d.pack_bev(torch.from_numpy(boxes))[None]
    assert not nm.skippable_plain(packed, thresh).any()
    counts = torch.tensor([40])
    assert int(nm.survivors_plain(packed, counts, thresh)) == 40 * 39 // 2


@pytest.mark.parametrize("p,counts", [(130, [130, 64, 0]), (300, [300, 1,
                                                                   299])])
def test_survivors_count_the_unskipped_live_pairs(p, counts):
    boxes = torch.from_numpy(nms_boxes(np.random.RandomState(p), 3, p,
                                       spread=30.0))
    packed = iou3d.pack_bev(boxes)
    skip = nm.skippable_plain(packed, 0.1)
    i = torch.arange(p)[:, None]
    j = torch.arange(p)[None]
    c = torch.tensor(counts)
    live = (i < j)[None] & (j[None] < c[:, None, None])
    want = (live & ~skip).sum(dim=(1, 2))
    assert torch.equal(nm.survivors_plain(packed, c, 0.1), want)
    assert int(want.sum()) < int(live.sum()), "test needs skipped pairs"


@pytest.mark.parametrize("thresh", (1e-3, 0.01, 0.1, 0.85))
@pytest.mark.parametrize("boxes", ["adversarial", "clustered"])
def test_fused_nms_flags_are_the_same_with_the_pretest(boxes, thresh):
    """``nms_keep_batched_plain`` with the pre-test skipping pairs (as the
    kernel does for kept-vs-column and diagonal pairs) keeps exactly the
    boxes it keeps without it, at every served threshold and around it."""
    rng = np.random.RandomState(int(thresh * 1000))
    if boxes == "adversarial":
        adv = adversarial_boxes(rng, far=(0.0, 70.0), n_random=40)
        p = -(-len(adv) // nms_fused.BLK) * nms_fused.BLK
        t = np.concatenate([adv, nms_boxes(rng, 1, p - len(adv))[0]])[None]
        counts = torch.tensor([len(adv)], dtype=torch.int32)
    else:
        # one sample: its (1, 128, 128) pair tiles stay below PyTorch's
        # intra-op grain, so the loop runs no thread pool (under parallel
        # test workers a pool's barriers cost ~0.5 s a column block)
        t = nms_boxes(rng, 1, 384, spread=25.0)
        counts = torch.tensor([300], dtype=torch.int32)
    t = torch.from_numpy(t)
    packed = iou3d.pack_bev(t)
    assert bool(nm.skippable_plain(packed, thresh).any()), \
        "test needs skipped pairs"
    for post_k in (t.shape[1], 100):
        want = nms_fused.nms_keep_batched_plain(t, counts, thresh, post_k)
        got = nms_fused.nms_keep_batched_plain(t, counts, thresh, post_k,
                                               pretest=True)
        assert torch.equal(got, want)
        assert want.any()
