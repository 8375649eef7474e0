"""Rotated BEV IoU, top-k and NMS: the PyTorch port against the JAX
package on the same boxes and scores (the CUDA kernel is held against
its plain version in ``test_torch_cuda_kernels.py``).

IoU: cos/sin and the corner products round differently in XLA and
PyTorch, so IoUs agree to rtol/atol 1e-5. Top-k indices and NMS
selections/counts must be identical."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.ops import iou3d as jiou
from de6d_tpu.ops import nms as jnms
from de6d_tpu_torch.ops import iou3d, nms
from de6d_tpu_torch.ops.kernels import nms_fused
from torch_fixtures import nms_boxes


def _scores(rng, b, p, counts):
    s = -np.sort(-rng.uniform(0.1, 1, (b, p)).astype(np.float32), axis=1)
    for i, c in enumerate(counts):
        s[i, c:] = nms.NEG_INF
    return s


def test_iou_bev_matches_jax():
    rng = np.random.RandomState(0)
    a = nms_boxes(rng, 1, 96)[0]
    b = nms_boxes(rng, 1, 64)[0]
    b[:8] = a[:8]  # identical boxes share edges (second-pass epsilon)
    ref = np.asarray(jiou.boxes_iou_bev(jnp.asarray(a), jnp.asarray(b)))
    got = iou3d.boxes_iou_bev(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert (np.diag(got.numpy()[:8, :8]) > 0.999).all()


def test_box_geometry_and_coder_match_jax():
    from de6d_tpu.ops import geometry as jgeo
    from de6d_tpu.utils.box_coder_utils import ResidualCoder as JaxCoder
    from de6d_tpu_torch.ops import geometry
    from de6d_tpu_torch.utils.box_coder_utils import ResidualCoder

    rng = np.random.RandomState(5)
    boxes = nms_boxes(rng, 1, 64)[0]
    anchors = nms_boxes(rng, 1, 64)[0]
    pts = rng.randn(2, 50, 4).astype(np.float32) * 10
    yaw = rng.uniform(-np.pi, np.pi, 2).astype(np.float32)
    tb, ta = torch.from_numpy(boxes), torch.from_numpy(anchors)
    pairs = [
        (geometry.boxes_to_corners_bev(tb), jgeo.boxes_to_corners_bev(boxes)),
        (geometry.rotate_points_along_z(torch.from_numpy(pts),
                                        torch.from_numpy(yaw)),
         jgeo.rotate_points_along_z(jnp.asarray(pts), jnp.asarray(yaw))),
        (geometry.limit_period(tb[:, 6] * 3, 0.5, np.pi),
         jgeo.limit_period(jnp.asarray(boxes[:, 6] * 3), 0.5, np.pi)),
    ]
    for sincos in (False, True):
        coder, jcoder = ResidualCoder(encode_angle_by_sincos=sincos), \
            JaxCoder(encode_angle_by_sincos=sincos)
        enc = coder.encode(tb, ta)
        pairs += [(enc, jcoder.encode(jnp.asarray(boxes), jnp.asarray(anchors))),
                  (coder.decode(enc, ta),
                   jcoder.decode(jnp.asarray(enc.numpy()), jnp.asarray(anchors)))]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bsz,ncells,group,pre", [
    (4, 64, 6, 16), (2, 128, 2, 32), (1, 96, 6, 24), (3, 50, 4, 200),
])
def test_top_k_two_stage_ties_match_lax_top_k(bsz, ncells, group, pre):
    rng = np.random.RandomState(1)
    a = ncells * group
    # quantized scores force many exact ties across cells
    s = np.round(rng.random((bsz, a)).astype(np.float32) * 8) / 8
    s[rng.random((bsz, a)) < 0.3] = nms.NEG_INF
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(s), min(pre, a))
    got_v, got_i = nms.top_k_two_stage(torch.from_numpy(s), min(pre, a), group)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(ref_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))
    got_v, got_i = nms.stable_top_k(torch.from_numpy(s), min(pre, a))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(ref_i))


def _jax_batched(boxes, scores, thresh, post):
    sel, cnt = jnms.nms_candidates_batched(
        jnp.asarray(boxes), jnp.asarray(scores), thresh=thresh,
        post_maxsize=post, iou_kind="rotated",
    )
    return np.asarray(sel), np.asarray(cnt)


def _assert_same_selection(got, ref):
    (gsel, gcnt), (rsel, rcnt) = got, ref
    np.testing.assert_array_equal(gcnt, rcnt)
    for i, c in enumerate(rcnt.tolist()):
        np.testing.assert_array_equal(gsel[i, :c], rsel[i, :c])


NMS_CASES = {
    # P, counts, post, spread: P=2048 runs the k0=1024 prefix cascade
    "p256": (256, (256, 130, 0), 64, 12.0),
    "p192_unfused": (192, (192, 70, 5), 500, 12.0),  # P % 128 != 0
    "p2048_prefix_done": (2048, (2048, 900), 40, 40.0),
    "p2048_full_pass": (2048, (2048, 1500), 500, 20.0),
}


# the widths nms_keep_batched is called with, per case
NMS_WIDTHS = {"p256": [256], "p192_unfused": [],
              "p2048_prefix_done": [1024], "p2048_full_pass": [1024, 2048]}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_nms_candidates_batched_matches_jax(case, monkeypatch):
    p, counts, post, spread = NMS_CASES[case]
    rng = np.random.RandomState(2)
    boxes = nms_boxes(rng, len(counts), p, spread=spread)
    scores = _scores(rng, len(counts), p, counts)
    ref = _jax_batched(boxes, scores, 0.2, post)
    widths = []

    def spy(bx, *args, **kwargs):
        widths.append(bx.shape[1])
        return nms_fused.nms_keep_batched(bx, *args, **kwargs)

    monkeypatch.setattr(nms, "nms_keep_batched", spy)
    sel, cnt = nms.nms_candidates_batched(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.2, post
    )
    assert sel.dtype == torch.int32 and sel.shape == (len(counts), min(post, p))
    _assert_same_selection((sel.numpy(), cnt.numpy()), ref)
    assert widths == NMS_WIDTHS[case]


def test_plain_keep_equals_pallas_interpret_first_post_k():
    from de6d_tpu.ops.pallas.nms_fused import nms_keep_batched

    rng = np.random.RandomState(3)
    b, p, post_k = 2, 384, 40
    boxes = nms_boxes(rng, b, p, spread=40.0)
    counts = np.array([p, 300], np.int32)
    ref = np.asarray(nms_keep_batched(
        jnp.asarray(boxes), jnp.asarray(counts), 0.3, post_k=post_k,
        interpret=True,
    ))
    got = nms_fused.nms_keep_batched(
        torch.from_numpy(boxes), torch.from_numpy(counts), 0.3, post_k=post_k
    ).numpy()
    for i in range(b):
        assert np.flatnonzero(ref[i]).size >= post_k
        np.testing.assert_array_equal(
            np.flatnonzero(got[i])[:post_k], np.flatnonzero(ref[i])[:post_k]
        )
    # the truncated flags themselves agree too
    np.testing.assert_array_equal(got, ref)
