"""The suppression-mask NMS path of the PyTorch port against the JAX
package on the same boxes and scores, on the CPU (the CUDA kernels are
held against these plain versions in ``test_torch_cuda_kernels.py``).

Masks are compared bit for bit: corners round differently in XLA and
PyTorch (IoUs agree to ~1e-5), so a flipped bit needs an IoU within that
of the threshold, which these seeded boxes do not have. Selections and
counts of ``nms`` / ``nms_candidates`` must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.ops import nms as jnms
from de6d_tpu.ops.pallas.nms_mask import nms_suppression_mask as jax_mask
from de6d_tpu_torch.ops import iou3d, nms
from de6d_tpu_torch.ops.kernels import nms_mask as nm
from torch_fixtures import nms_boxes

THRESH = 0.2


def _plain_mask(boxes, counts, thresh=THRESH):
    packed = iou3d.pack_bev(torch.from_numpy(boxes))
    words = nm.nms_suppression_mask(packed, torch.as_tensor(counts), thresh)
    assert words.dtype == torch.int64
    assert words.shape == (*boxes.shape[:2], nm.n_words(boxes.shape[1]))
    return words, nm.unpack_bits(words, boxes.shape[1]).numpy()


@pytest.mark.parametrize("p,count,br,bc", [
    (96, 96, 32, 32), (96, 40, 32, 32), (96, 0, 32, 32), (96, 70, 16, 64),
    (100, 100, 32, 32), (100, 37, 32, 32), (130, 129, 128, 256),
    (65, 65, 65, 65), (63, 1, 63, 63),
])
def test_plain_mask_equals_pallas_interpret(p, count, br, bc):
    """Equal to the TPU kernel (interpret mode) on the region greedy NMS
    reads, ``i < j < count``; zero everywhere else."""
    boxes = nms_boxes(np.random.RandomState(p + count), 1, p)
    ref = np.asarray(jax_mask(jnp.asarray(boxes[0]), THRESH,
                              valid_count=count, block_r=br, block_c=bc,
                              interpret=True)) > 0.5
    _, got = _plain_mask(boxes, [count])
    i, j = np.arange(p)[:, None], np.arange(p)[None, :]
    region = (i < j) & (j < count)
    np.testing.assert_array_equal(got[0][region], ref[region])
    assert not got[0][~region].any()
    if count > 40:
        assert got[0].sum() > 20, "test needs overlaps"


def test_mask_is_batched_and_ragged():
    rng = np.random.RandomState(0)
    boxes = nms_boxes(rng, 4, 130)
    counts = [130, 64, 0, 77]
    words, got = _plain_mask(boxes, counts)
    for b, c in enumerate(counts):
        w1, one = _plain_mask(boxes[b:b + 1], [c])
        np.testing.assert_array_equal(got[b], one[0])
        assert torch.equal(words[b], w1[0])
        assert not got[b][c:].any() and not got[b][:, c:].any()


@pytest.mark.parametrize("p", [1, 63, 64, 65, 200])
def test_bits_round_trip(p):
    flags = torch.from_numpy(np.random.RandomState(p).rand(3, 5, p) < 0.5)
    words = nm.pack_bits(flags)
    assert words.shape == (3, 5, nm.n_words(p))
    assert torch.equal(nm.unpack_bits(words, p), flags)
    if p >= 64:  # bit 63 is the sign bit of the word
        assert bool((words[..., 0] < 0).eq(flags[..., 63]).all())


def _greedy_oracle(mask, count, post):
    keep, removed = [], np.zeros(mask.shape[0], bool)
    for i in range(count):
        if removed[i] or len(keep) == post:
            continue
        keep.append(i)
        removed |= mask[i]
    return keep


@pytest.mark.parametrize("p,post", [(130, 130), (130, 7), (64, 500), (200, 50)])
def test_resolve_equals_sequential_greedy(p, post):
    rng = np.random.RandomState(p + post)
    boxes = nms_boxes(rng, 3, p)
    counts = [p, p // 2, 0]
    words, bits = _plain_mask(boxes, counts)
    post = min(post, p)
    sel, nsel = nm.nms_resolve(words, torch.as_tensor(counts), post)
    assert sel.dtype == torch.int32 and sel.shape == (3, post)
    for b, c in enumerate(counts):
        want = _greedy_oracle(bits[b], c, post)
        assert int(nsel[b]) == len(want)
        np.testing.assert_array_equal(sel[b, :len(want)].numpy(), want)
        assert not sel[b, len(want):].any()
    assert 0 < int(nsel[0]) < p or post < p, "test needs suppression"


def _scores(rng, n, tied):
    s = rng.uniform(0.05, 1, n).astype(np.float32)
    if tied:  # quantized: many exact ties, broken by the lower index
        s = np.round(s * 16) / 16
    return s


@pytest.mark.parametrize("tied", [False, True], ids=["distinct", "tied"])
@pytest.mark.parametrize("n,pre,post", [
    (300, 128, 40), (300, 200, 500), (150, 9000, 100), (65, 64, 64),
])
def test_nms_equals_jax(n, pre, post, tied):
    """``nms()``: score gate, stable top-``pre``, then the mask path, at
    P % 64 == 0 and != 0; indices (padding included) and counts."""
    rng = np.random.RandomState(n + pre)
    boxes = nms_boxes(rng, 3, n)
    scores = np.stack([_scores(rng, n, tied) for _ in range(3)])
    valid = scores > 0.3
    valid[2] = False
    got = nms.nms(torch.from_numpy(boxes), torch.from_numpy(scores), THRESH,
                  pre_maxsize=pre, post_maxsize=post,
                  valid_mask=torch.from_numpy(valid))
    ungated = nms.nms(torch.from_numpy(boxes[:1]), torch.from_numpy(scores[:1]),
                      THRESH, pre_maxsize=pre, post_maxsize=post)
    for b in range(3):
        ref_idx, ref_cnt = jnms.nms(
            jnp.asarray(boxes[b]), jnp.asarray(scores[b]), THRESH,
            pre_maxsize=pre, post_maxsize=post,
            valid_mask=jnp.asarray(valid[b]))
        assert int(got[1][b]) == int(ref_cnt)
        np.testing.assert_array_equal(got[0][b].numpy(), np.asarray(ref_idx))
    assert int(got[1][2]) == 0 and int(got[1][0]) > 0
    ref_idx, ref_cnt = jnms.nms(jnp.asarray(boxes[0]), jnp.asarray(scores[0]),
                                THRESH, pre_maxsize=pre, post_maxsize=post)
    assert int(ungated[1][0]) == int(ref_cnt)
    np.testing.assert_array_equal(ungated[0][0].numpy(), np.asarray(ref_idx))


@pytest.mark.parametrize("p,counts,post", [
    (128, (128, 50, 0), 500), (100, (100, 99, 1), 100), (192, (192, 70), 30),
])
def test_nms_candidates_equals_jax(p, counts, post):
    rng = np.random.RandomState(p)
    b = len(counts)
    boxes = nms_boxes(rng, b, p)
    scores = -np.sort(-rng.uniform(0.1, 1, (b, p)).astype(np.float32), axis=1)
    for i, c in enumerate(counts):
        scores[i, c:] = nms.NEG_INF
    sel, cnt = nms.nms_candidates(torch.from_numpy(boxes),
                                  torch.from_numpy(scores), THRESH, post)
    bsel, bcnt = nms.nms_candidates_batched(
        torch.from_numpy(boxes), torch.from_numpy(scores), THRESH, post)
    for i in range(b):
        ref_sel, ref_cnt = jnms.nms_candidates(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]), thresh=THRESH,
            post_maxsize=post)
        c = int(ref_cnt)
        assert int(cnt[i]) == c == int(bcnt[i])
        np.testing.assert_array_equal(sel[i].numpy(), np.asarray(ref_sel))
        np.testing.assert_array_equal(bsel[i, :c].numpy(),
                                      np.asarray(ref_sel)[:c])
        one = nms.nms_candidates(torch.from_numpy(boxes[i:i + 1]),
                                 torch.from_numpy(scores[i:i + 1]), THRESH,
                                 post)
        assert torch.equal(one[0][0], sel[i]) and int(one[1][0]) == c


def test_wrappers_reject_bad_input():
    packed = torch.zeros(2, 9, 10)
    with pytest.raises(ValueError):
        nm.nms_suppression_mask(torch.zeros(2, 8, 10), torch.zeros(2), 0.1)
    words = nm.nms_suppression_mask(packed, torch.tensor([10, 3]), 0.1)
    with pytest.raises(ValueError):
        nm.nms_resolve(words, torch.tensor([10, 3]), 0)
    with pytest.raises(ValueError):
        nm.nms_resolve(words.to(torch.int32), torch.tensor([10, 3]), 4)
    with pytest.raises(NotImplementedError):
        nms.nms_candidates(torch.zeros(1, 4, 7), torch.zeros(1, 4), 0.1,
                           iou_kind="aligned")
