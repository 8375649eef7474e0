"""Shared helpers for the PyTorch-port parity tests: build the same
PointPillars model in both packages from a yaml, carry the JAX
variables across as numpy, and run the JAX package's single-stage point
detectors with their sampling calls recorded."""

import copy

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The test's CUDA device; skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def spec_kwargs(cfg):
    """DatasetSpec fields from a KITTI-style yaml."""
    vox = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
           if p["NAME"] == "transform_points_to_voxels"][0]
    return dict(
        class_names=tuple(cfg.CLASS_NAMES),
        point_feature_dim=4,
        point_cloud_range=tuple(float(x) for x in
                                cfg.DATA_CONFIG.POINT_CLOUD_RANGE),
        voxel_size=tuple(float(x) for x in vox["VOXEL_SIZE"]),
        max_voxels=int(vox["MAX_NUMBER_OF_VOXELS"]["test"]),
        max_points_per_voxel=int(vox["MAX_POINTS_PER_VOXEL"]),
    )


def build_pair(cfg_path, compute_dtype="float32"):
    """(jax_model, torch_model (CPU), model_cfg dict, num_class, jax spec)
    for one yaml."""
    from de6d_tpu.config import cfg_from_yaml_file as jax_cfg_from_yaml
    from de6d_tpu.models import build_network as jax_build
    from de6d_tpu.models.detectors.detector3d_template import (
        DatasetSpec as JaxSpec,
    )
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models import build_network
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        DatasetSpec,
    )

    jcfg = jax_cfg_from_yaml(cfg_path)
    tcfg = cfg_from_yaml_file(cfg_path)
    num_class = len(jcfg.CLASS_NAMES)
    jmc = copy.deepcopy(dict(jcfg.MODEL))
    tmc = copy.deepcopy(tcfg.MODEL)
    jmc["COMPUTE_DTYPE"] = compute_dtype
    tmc["COMPUTE_DTYPE"] = compute_dtype
    jspec = JaxSpec(**spec_kwargs(jcfg))
    jmodel = jax_build(jmc, num_class=num_class, dataset=jspec)
    tmodel = build_network(tmc, num_class, DatasetSpec(**spec_kwargs(tcfg)),
                           device="cpu")
    return jmodel, tmodel, tmc, num_class, jspec


def flatten_variables(variables):
    """flax variables → ``{"params/a/b": float32 ndarray}``."""
    from flax.traverse_util import flatten_dict

    flat = flatten_dict(
        {k: variables[k] for k in ("params", "batch_stats") if k in variables}
    )
    return {"/".join(k): np.asarray(v, np.float32) for k, v in flat.items()}


def perturb(flat, seed):
    """Random but well-conditioned variables: weights N(0, scale), BN
    running stats away from their init, cls bias 0 so scores straddle
    the 0.1 gate."""
    rng = np.random.RandomState(seed)
    out = {}
    for k, v in flat.items():
        if k.endswith("/var"):
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
        elif k.endswith("/mean"):
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
        elif k.endswith("/scale"):
            out[k] = rng.uniform(0.8, 1.2, v.shape).astype(np.float32)
        elif k.endswith("/bias"):
            out[k] = (np.zeros(v.shape, np.float32) if "conv_cls" in k
                      else rng.normal(0, 0.1, v.shape).astype(np.float32))
        else:
            fan_in = int(np.prod(v.shape[:-1]))
            out[k] = (rng.normal(0, 1, v.shape) / np.sqrt(fan_in)).astype(
                np.float32
            )
    return out


def unflatten(flat):
    from flax.traverse_util import unflatten_dict

    return unflatten_dict({tuple(k.split("/")): v for k, v in flat.items()})


def random_points(seed, spec, batch, n, n_valid):
    """Uniform points in range plus tight clusters (multi-point pillars);
    the last n - n_valid rows are zero padding, masked off."""
    rng = np.random.RandomState(seed)
    pc = spec.point_cloud_range
    pts = np.zeros((batch, n, 4), np.float32)
    for i in range(3):
        pts[:, :n_valid, i] = rng.uniform(pc[i], pc[i + 3], (batch, n_valid))
    half = n_valid // 2
    centers = pts[:, :half // 8, :3].repeat(8, axis=1)
    pts[:, :half - half % 8, :2] = centers[:, :, :2] + rng.normal(
        0, 0.1, centers[:, :, :2].shape
    )
    pts[:, :n_valid, 3] = rng.uniform(0, 1, (batch, n_valid))
    pts[:, :n_valid, 0] = np.clip(pts[:, :n_valid, 0], pc[0], pc[3] - 1e-3)
    pts[:, :n_valid, 1] = np.clip(pts[:, :n_valid, 1], pc[1], pc[4] - 1e-3)
    mask = np.zeros((batch, n), bool)
    mask[:, :n_valid] = True
    return pts, mask


def canvas_inputs(rng, bsz, v, g, n_valid, c=64):
    """(feats, lins) for the canvas scatter: sorted unique ids for the
    first n_valid[b] slots, an invalid (= g) suffix with zero rows."""
    feats = rng.randn(bsz, v, c).astype(np.float32)
    lins = np.full((bsz, v), g, np.int32)
    for b, n in enumerate(n_valid):
        lins[b, :n] = np.sort(rng.choice(g, n, replace=False))
        feats[b, n:] = 0.0
    return feats, lins


def nms_boxes(rng, b, p, spread=12.0, cluster=80):
    """Random rotated boxes with a dense cluster at the front, which
    forces suppression chains across 128-column blocks."""
    boxes = np.zeros((b, p, 7), np.float32)
    boxes[..., 0:2] = rng.uniform(-spread, spread, (b, p, 2))
    boxes[..., 2] = rng.uniform(-1, 1, (b, p))
    boxes[..., 3:5] = rng.uniform(1.5, 4, (b, p, 2))
    boxes[..., 5] = 1.5
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, p))
    cluster = min(cluster, p)
    boxes[:, :cluster, 0:2] = rng.uniform(-3, 3, (b, cluster, 2))
    return boxes


def run_jax_point_detector(jmodel, variables, post_cfg, num_class, pts, mask):
    """A single-stage point detector of the JAX package (3DSSD,
    3DSSD-SASA, IA-SSD) on (B, N, 4) points → what
    ``chip_smoke.check_point_parity`` reads: ``picks_<k>`` of the k-th
    sampling call (``run_sampling`` / ``run_sampling_iassd``, in call
    order), ``scores_<k>`` where that call ranks or weights by scores, the
    votes (``vote_coords``), the head's candidates (``cand_scores``,
    ``cand_boxes``) and the detections."""
    import jax
    import jax.numpy as jnp

    from chip_smoke import sampling_segments
    from de6d_tpu.models.backbones_3d import iassd_backbone as jax_iassd
    from de6d_tpu.models.backbones_3d import pointnet2_modules as jax_pn2
    from de6d_tpu.models.detectors.detector3d_template import (
        post_processing as jax_post_processing,
    )

    rec = []

    def wrap(fn):
        def run(method, xyz, features, scores, valid, npoint, sample_range,
                *rest):
            idx = fn(method, xyz, features, scores, valid, npoint,
                     sample_range, *rest)
            kinds = {k for k, _, _ in sampling_segments(method, int(npoint))}
            rec.append((idx, scores if kinds & {"topk", "sfps"} else None))
            return idx
        return run

    orig = (jax_pn2.run_sampling, jax_iassd.run_sampling_iassd)
    jax_pn2.run_sampling = wrap(orig[0])
    jax_iassd.run_sampling_iassd = wrap(orig[1])
    try:
        @jax.jit
        def infer(v, p, m):
            rec.clear()
            out = jmodel.apply(v, {"points": p, "points_mask": m},
                               train=False)
            post = jax_post_processing(out, post_cfg, num_class)
            votes = out.get("point_vote_coords", out.get("centers"))
            return (post, jax.nn.sigmoid(out["batch_cls_preds"]),
                    out["batch_box_preds"], votes, list(rec))

        post, cand_scores, cand_boxes, votes, calls = infer(
            variables, jnp.asarray(pts), jnp.asarray(mask))
    finally:
        jax_pn2.run_sampling, jax_iassd.run_sampling_iassd = orig
    out = {k: np.asarray(post[k]) for k in
           ("pred_boxes", "pred_scores", "pred_labels", "pred_count")}
    out["cand_scores"] = np.asarray(cand_scores)
    out["cand_boxes"] = np.asarray(cand_boxes)
    out["vote_coords"] = np.asarray(votes)
    for k, (idx, scores) in enumerate(calls):
        out[f"picks_{k}"] = np.asarray(idx)
        if scores is not None:
            out[f"scores_{k}"] = np.asarray(scores)
    return out

