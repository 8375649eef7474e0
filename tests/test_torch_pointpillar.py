"""PointPillars end to end: the PyTorch port against the JAX package on
the same points and the same weights (flax variables carried across by
``de6d_tpu_torch.weights.flax_to_torch``), fp32 on the CPU.

Tolerances: conv/matmul sums run in another order in XLA and PyTorch,
so fp32 activations differ by a few ulps and box parameters after
decode by ~1e-5 relative; boxes and scores are compared with
rtol 1e-4 / atol 1e-4 (coordinates are metres, scores in [0, 1]).
Counts and labels must be equal.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from de6d_tpu.models.detectors.detector3d_template import (
    post_processing as jax_post_processing,
)
from de6d_tpu_torch import weights
from de6d_tpu_torch.models.detectors.detector3d_template import (
    post_processing,
)
from torch_fixtures import build_pair, flatten_variables, perturb, \
    random_points, unflatten

ROOT = Path(__file__).resolve().parents[1]
TINY = str(ROOT / "configs/kitti_models/pointpillar_tiny.yaml")
FULL = str(ROOT / "configs/kitti_models/pointpillar.yaml")
FIXTURE = ROOT / "de6d_tpu_torch/testdata/pointpillar_jax_ref.npz"
OUT_KEYS = ("pred_boxes", "pred_scores", "pred_labels", "pred_count")
RTOL = ATOL = 1e-4


def run_jax(jmodel, variables, post_cfg, num_class, pts, mask):
    @jax.jit
    def infer(v, p, m):
        out = jmodel.apply(v, {"points": p, "points_mask": m}, train=False)
        post = jax_post_processing(out, post_cfg, num_class)
        return {k: post[k] for k in OUT_KEYS}, {
            k: out[k] for k in ("pillar_features", "spatial_features",
                                "batch_cls_preds")
        }

    post, mid = infer(variables, jnp.asarray(pts), jnp.asarray(mask))
    return ({k: np.asarray(v) for k, v in post.items()},
            {k: np.asarray(v) for k, v in mid.items()})


def run_torch(tmodel, post_cfg, num_class, pts, mask):
    with torch.no_grad():
        out = tmodel({"points": torch.from_numpy(pts),
                      "points_mask": torch.from_numpy(mask)})
        post = post_processing(out, post_cfg, num_class)
    return ({k: v.numpy() for k, v in post.items()},
            {k: out[k].float().numpy() for k in
             ("pillar_features", "spatial_features", "batch_cls_preds")})


def assert_detections_match(got, ref):
    np.testing.assert_array_equal(got["pred_count"], ref["pred_count"])
    for b, c in enumerate(ref["pred_count"].tolist()):
        np.testing.assert_array_equal(
            got["pred_labels"][b, :c], ref["pred_labels"][b, :c]
        )
        np.testing.assert_allclose(
            got["pred_scores"][b, :c], ref["pred_scores"][b, :c],
            rtol=RTOL, atol=ATOL,
        )
        np.testing.assert_allclose(
            got["pred_boxes"][b, :c], ref["pred_boxes"][b, :c],
            rtol=RTOL, atol=ATOL,
        )


@pytest.fixture(scope="module")
def tiny():
    jmodel, tmodel, mc, nc, spec = build_pair(TINY)
    pts, mask = random_points(0, spec, 2, 4096, 3900)
    init = jax.jit(lambda r, b: jmodel.init(r, b, train=False))(
        jax.random.PRNGKey(0),
        {"points": jnp.asarray(pts), "points_mask": jnp.asarray(mask)},
    )
    flat = perturb(flatten_variables(init), seed=1)
    weights.load_into(tmodel, flat)
    post_cfg = mc["POST_PROCESSING"]
    ref = run_jax(jmodel, unflatten(flat), post_cfg, nc, pts, mask)
    got = run_torch(tmodel, post_cfg, nc, pts, mask)
    return ref, got


def test_tiny_intermediates_match(tiny):
    (_, ref), (_, got) = tiny
    for k in ("pillar_features", "spatial_features", "batch_cls_preds"):
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_tiny_end_to_end_matches_jax(tiny):
    (ref, _), (got, _) = tiny
    assert ref["pred_count"].min() > 0, "test needs detections"
    assert_detections_match(got, ref)


# --------------------------------------------------------------------
# full-width reference for the card (which has no JAX)
# --------------------------------------------------------------------

def jax_reference(n_scans=2):
    """The JAX model, fp32, bench_assets weights, the first ``n_scans``
    real scans (zero padding rows masked, as bench.py does) → post
    outputs. Rewrite the stored fixture with
    ``python -c "import sys; sys.path.insert(0, 'tests');
    import test_torch_pointpillar as t; t.write_fixture()"``."""
    jmodel, _, mc, nc, _ = build_pair(FULL, compute_dtype="float32")
    flat = weights.load_flax_npz(ROOT / "bench_assets/pointpillar_params.npz")
    pts = np.load(ROOT / "bench_assets/scans.npz")["points"][:n_scans]
    mask = ~np.all(pts == 0, axis=-1)
    post, _ = run_jax(jmodel, unflatten(flat), mc["POST_PROCESSING"], nc,
                      pts, mask)
    return post


def write_fixture():
    FIXTURE.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(FIXTURE, **jax_reference())


@pytest.mark.slow
def test_fixture_equals_fresh_jax_run():
    ref = jax_reference()
    with np.load(FIXTURE) as stored:
        for k in OUT_KEYS:
            np.testing.assert_array_equal(stored[k], ref[k], err_msg=k)


@pytest.mark.slow
def test_full_width_port_matches_fixture_on_cpu():
    """The parity phase of chip_smoke.py, here on the CPU."""
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models import build_network
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        DatasetSpec,
    )
    from torch_fixtures import spec_kwargs

    cfg = cfg_from_yaml_file(FULL)
    mc = cfg.MODEL
    mc["COMPUTE_DTYPE"] = "float32"
    model = build_network(mc, 3, DatasetSpec(**spec_kwargs(cfg)),
                          device="cpu")
    weights.load_into(model, weights.load_flax_npz(
        ROOT / "bench_assets/pointpillar_params.npz"))
    pts = np.load(ROOT / "bench_assets/scans.npz")["points"][:2]
    mask = ~np.all(pts == 0, axis=-1)
    got, _ = run_torch(model, mc["POST_PROCESSING"], 3, pts, mask)
    with np.load(FIXTURE) as stored:
        assert_detections_match(got, dict(stored))

