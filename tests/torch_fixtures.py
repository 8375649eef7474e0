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


def adversarial_boxes(rng, far=(0.0,), n_random=0):
    """(P, 7) boxes where a bound pre-test of the BEV IoU could go wrong:
    pairs that touch or lie 1e-6 m ... 0.1 m apart, with parallel edges,
    around each offset in ``far``; six 1e-3 m and six 1e4 m boxes; two
    identical boxes, a zero-size and a mirrored (negative-size) box as the
    last four rows before ``n_random`` random boxes."""
    rows = []
    for gap in (0.0, 1e-6, 1e-4, 1e-3, 2e-3, 1e-2, 0.1):
        for yaw in (0.0, np.pi / 2, 0.3):
            for off in far:
                step = 4.0 + gap
                rows += [[off, off, 0, 4, 1.6, 1.5, yaw],
                         [off + step * np.cos(yaw), off + step * np.sin(yaw),
                          0, 4, 1.6, 1.5, yaw],
                         [off, off + 1.6 + gap, 0, 4, 1.6, 1.5, 0.0]]
    for size in (1e-3, 1e4):
        rows += [[rng.uniform(-3, 3) * size, rng.uniform(-3, 3) * size, 0,
                  size, size, 1, rng.uniform(-3, 3)] for _ in range(6)]
    same = [1, 2, 0, 3.9, 1.6, 1.5, 0.7]
    rows += [same, same, [1, 2, 0, 0, 1.6, 1.5, 0],
             [1.5, 2, 0, -3.9, 1.6, 1.5, 0.7]]
    rows += [[rng.uniform(-6, 6), rng.uniform(-6, 6), 0, rng.uniform(0.5, 5),
              rng.uniform(0.5, 3), 1.5, rng.uniform(-3, 3)]
             for _ in range(n_random)]
    return np.asarray(rows, np.float32)


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


def sparse_site_keys(rng, grid, v, counts, faces=True):
    """(B, V) int32 sorted unique site keys of ``grid`` (zyx), ``counts[b]``
    of them in sample b and INVALID (int32 max) after: clusters of cells
    around random centres, so that most kernel offsets find a neighbour,
    and with ``faces`` a site on every face, edge and corner of the grid,
    whose neighbours fall outside it."""
    nz, ny, nx = grid
    face = sorted({(z * ny + y) * nx + x for z in (0, nz // 2, nz - 1)
                   for y in (0, ny // 2, ny - 1)
                   for x in (0, nx // 2, nx - 1)}) if faces else []
    keys = np.full((len(counts), v), 2**31 - 1, np.int32)
    for b, n in enumerate(counts):
        cells = set()
        while len(cells) < min(2 * n, nz * ny * nx):
            c = rng.randint(0, (nz, ny, nx))
            for _ in range(30):
                p = np.clip(c + rng.randint(-2, 3, 3), 0,
                            np.array(grid) - 1)
                cells.add(int((p[0] * ny + p[1]) * nx + p[2]))
        rest = np.array(sorted(cells - set(face)), np.int64)
        pick = np.concatenate([face[:n], rng.choice(
            rest, n - min(n, len(face)), replace=False)])
        keys[b, :n] = np.sort(pick)
    return keys


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



KITTI_ROOT = "data/kitti"
SLOPEDKITTI_ROOT = "data/slopedkitti"


def slopedkitti_subtree(dst, n_train=8, n_val=4):
    """:func:`kitti_subtree` of ``data/slopedkitti``, slope planes
    included."""
    return kitti_subtree(dst, n_train, n_val, root=SLOPEDKITTI_ROOT,
                         subdirs=("velodyne", "calib", "label_2",
                                  "slope_planes"))


def kitti_subtree(dst, n_train=8, n_val=4, root=KITTI_ROOT,
                  subdirs=("velodyne", "calib", "label_2")):
    """A KITTI tree cut from the repository's ``root`` (``data/kitti``)
    into ``dst``: the first ``n_train`` train and ``n_val`` val frames
    (the files of ``subdirs``), their infos, and the sampling database of
    those train frames (dbinfos filtered, the object files copied).
    Returns ``dst``."""
    import pickle
    import shutil
    from pathlib import Path

    src = Path(__file__).resolve().parent.parent / root
    dst = Path(dst)
    (dst / "ImageSets").mkdir(parents=True, exist_ok=True)
    (dst / "gt_database").mkdir(exist_ok=True)
    for sub in subdirs:
        (dst / "training" / sub).mkdir(parents=True, exist_ok=True)
    ext = {"velodyne": ".bin"}
    for split, n in (("train", n_train), ("val", n_val)):
        with open(src / f"kitti_infos_{split}.pkl", "rb") as f:
            infos = pickle.load(f)[:n]
        ids = [i["point_cloud"]["lidar_idx"] for i in infos]
        (dst / "ImageSets" / f"{split}.txt").write_text("\n".join(ids) + "\n")
        for idx in ids:
            for sub in subdirs:
                name = f"training/{sub}/{idx}{ext.get(sub, '.txt')}"
                shutil.copyfile(src / name, dst / name)
        with open(dst / f"kitti_infos_{split}.pkl", "wb") as f:
            pickle.dump(infos, f)
        if split == "train":
            with open(src / "kitti_dbinfos_train.pkl", "rb") as f:
                db = pickle.load(f)
            keep = set(ids)
            db = {k: [d for d in v if d["image_idx"] in keep]
                  for k, v in db.items()}
            for objs in db.values():
                for d in objs:
                    shutil.copyfile(src / d["path"], dst / d["path"])
            with open(dst / "kitti_dbinfos_train.pkl", "wb") as f:
                pickle.dump(db, f)
    return dst
