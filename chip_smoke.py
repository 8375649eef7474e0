"""Smoke test of the PyTorch/CUDA port (``de6d_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown

Phases, one status line each; any failure exits non-zero:

1. build          — compile ``de6d_tpu_torch/csrc/*.cu`` for sm_90a.
   grad guard     — ``scatter_canvas`` on the card returns a gradient
                    (its backward kernel) bit-equal to the CPU plain
                    version's; ``sparse_conv`` on the card has a
                    ``grad_fn`` under ``enable_grad``, and its feature and
                    weight gradients (its backward kernels) on a
                    submanifold and a strided table equal the CPU plain
                    autograd's within 1e-5 of each leaf's max
                    (:func:`check_grad_guard`).
2. kernels        — canvas and NMS against their plain PyTorch versions
                    on the card at PointPillars' shapes (canvas bit-exact
                    in bf16 and fp32; NMS keep flags identical on the realistic
                    candidates of the first served batch and on a
                    SCORE_THRESH 0 worst case, the kernel's corners
                    bit-equal to ``iou3d.pack_bev``), with timings, the
                    pre-test's survivor share and both bounds (on the
                    survivors, on every pair the walk tests). Every NMS
                    case of the later phases (Det6D, 3DSSD, IA-SSD,
                    SECOND) is checked and reported the same way.
3. serve          — ``StreamingDetector`` with ``configs/kitti_models/
                    pointpillar.yaml`` in bf16, the trained
                    ``bench_assets/pointpillar_params.npz`` and the 8 real
                    scans of ``bench_assets/scans.npz`` at batch 8; both
                    kernels' launch counters must rise.
4. parity         — PointPillars in fp32 (TF32 off) on 2 scans against the
                    stored JAX reference
                    ``de6d_tpu_torch/testdata/pointpillar_jax_ref.npz``.
4a. kernels / canvas_grad — the canvas backward kernel against
                    ``scatter_canvas_grad_plain``, bit-exact in bf16 and
                    fp32: the voxelized training batch (4 x 16000 x 64,
                    invalid suffix), all slots invalid, V = 1, a
                    non-contiguous cotangent; ms by events and in a CUDA
                    graph, ``torch.gather`` + ``where``, the bytes bound.
4b. parity / train_pointpillar — the train step in fp32 (TF32 off) from
                    the trained weights on the 4 synthetic frames of
                    ``de6d_tpu_torch/testdata/pointpillar_train_jax_ref.npz``
                    against the JAX step stored there: labels, targets,
                    loss terms, gradient norm, gradients, BatchNorm
                    statistics, 3 steps (:func:`check_train_parity`,
                    tolerances in :data:`TRAIN_TOL`).
4c. train / pointpillar — ``train.train_loop.train_model`` in bf16 at
                    batch 4, full width, from the trained weights, over
                    the same frames for :data:`TRAIN_STEPS` steps: step
                    ms, steps/s, frames/s, peak memory, device time and
                    idle share (torch.profiler over 5 steps; ``--profile``
                    prints the breakdown), the loss falling, exactly 1
                    canvas forward and 1 backward launch a step and none
                    of any other kernel.
4d. pipeline / kitti — the port's host data pipeline on ``data/kitti``
                    (``pointpillar.yaml``'s ``DATA_CONFIG``) against the
                    JAX loader's batches stored in ``de6d_tpu_torch/
                    testdata/kitti_loader_jax_ref.npz``, bit for bit
                    (:func:`check_loader`); host ms per batch over train
                    epoch 0 with 1 and 4 workers, with 4 in the loader's
                    own process, and over the val split.
4e. train / kitti — ``tools/train.py`` (``prepare``, ``train``,
                    ``evaluate``) in bf16 at batch 4 for one epoch of
                    ``data/kitti`` from the fresh init: step ms, steps/s,
                    frames/s, the loader's share of the loop, the loss
                    falling, exactly 1 canvas forward and 1 backward
                    launch a step and no other kernel, the checkpoint,
                    the post-training eval (1 canvas and 1-2 fused-NMS
                    launches a batch: the 1024-prefix cascade); the
                    anchors' val scores (:func:`anchor_scores`): with the
                    batch's BatchNorm statistics the foreground anchors'
                    mean over the background's must exceed the fresh
                    init's.
4f. eval / kitti  — the port's KITTI eval on the JAX run's own detections
                    (AP dict exactly, :func:`check_eval_code`; which
                    matcher ran, native or Python); ``eval_one_epoch`` with
                    the trained weights over the 100 val frames at batch 8
                    in fp32 (TF32 off) against ``de6d_tpu_torch/testdata/
                    pointpillar_eval_jax_ref.npz`` (:func:`check_eval_parity`:
                    counts, labels, boxes and scores within 1e-3, recall
                    counters and AP equal or parted at certified
                    thresholds), recall above 0, recall and 3D AP; bf16 ms
                    per frame with 1 canvas and 1 fused-NMS launch a
                    batch; ``tools/test.py --ckpt`` on phase 4e's
                    checkpoint.
5. kernels / fps  — the FPS kernel against its plain version at Det6D's
                    shapes (d-fps 8 x 16384 -> 4096 on the real scans,
                    s-fps 8 x 4096 -> 1024 and 8 x 1024 -> 512 weighted by
                    the served model's SA1/SA2 confidence scores, and an
                    all-valid random case): identical picks at the
                    dispatched cluster size and at every other one,
                    timings (every cluster size at SA1 and SA2), the
                    operations bound, the dispatched variant's measured
                    latency floor beside the first, single-block kernel's;
                    the edge cases (N = 1 ... 16384, npoint up to N,
                    all-invalid, ragged, exact ties); plus NMS at Det6D's
                    shape (8 x 256, post_k 256).
6. serve / det6d  — ``StreamingDetector`` with ``configs/kitti_models/
                    det6d_car.yaml`` in bf16, ``bench_assets/
                    det6d_car_params.npz`` and the 8 scans of
                    ``bench_assets/det6d_car_scans.npz``: finite 9-column
                    boxes, 3 FPS launches and 1 NMS launch per batch.
7. parity / det6d — Det6D in fp32 (TF32 off) on 2 scans against
                    ``de6d_tpu_torch/testdata/det6d_jax_ref.npz``: per-layer
                    picks, counts, labels, boxes and scores
                    (:func:`check_det6d_parity`).
7a. parity / train_det6d — the Det6D train step in fp32 (TF32 off) from
                    ``bench_assets/det6d_car_params.npz`` on the batch of
                    2 stored in ``de6d_tpu_torch/testdata/
                    det6d_train_jax_ref.npz`` (the JAX loader's on
                    ``data/slopedkitti``, SlopeAug on), every sampling call
                    given the reference's picks: own picks certified,
                    labels identical, targets, loss terms, gradient norm,
                    gradients and BatchNorm statistics within
                    :data:`DET6D_TRAIN_TOL` (:func:`check_det6d_train_parity`).
7b. train / det6d — ``train_model`` with ``slopedkitti_models/
                    det6d_car.yaml``'s dtypes (the head in bf16) at batch 8
                    on the fixture's 8 frames, :data:`TRAIN_STEPS` steps:
                    step ms, steps/s, frames/s, device ms and idle share
                    (5-step profiler window), peak memory, the loss
                    falling, exactly 3 FPS launches a step and no other
                    kernel launch.
7c. train / det6d_slopedkitti — ``tools/train.py`` (``prepare``, ``train``,
                    ``evaluate``) on that config for one epoch of
                    ``data/slopedkitti`` at batch 8 from the fresh init:
                    steps/s, the loader's share of the loop, the loss, 3
                    FPS launches a step; the post-training eval with 3 FPS
                    and 1-2 fused-NMS launches a batch.
7d. eval / det6d_slopedkitti — ``eval_one_epoch`` of the trained weights
                    over the 50 val frames at batch 8: fp32 (TF32 off)
                    against ``de6d_tpu_torch/testdata/det6d_eval_jax_ref.npz``
                    with the reference's picks (:func:`det6d_eval_parity`:
                    counts, labels, boxes, scores, recall, the SlopedKITTI
                    result dict); with the head in bf16, ms per frame and
                    the launch counts.

8. kernels / nms_mask — ``nms_suppression_mask`` and ``nms_resolve``
                    against their plain versions, whole outputs equal: the
                    8 x 9000 proposal candidates of the served PointRCNN
                    model (all live), its 8 x 100 final candidates, ragged
                    counts including 0, P = 1, 63, 64, 65, 130, and an
                    adversarial set (touching, 1e-6 m apart, parallel
                    edges, 1e-3 m and 1e4 m, identical, degenerate boxes)
                    at thresh -0.1, 0, 0.1, 0.85; each with the pairs the
                    bound pre-test leaves (survivor share), the bound on
                    those and the bound on all live pairs; plus
                    the FPS kernel at PointRCNN's shapes (4 backbone
                    layers, 800 RoI point sets with empty ones).
9. serve / pointrcnn — ``StreamingDetector`` with ``configs/kitti_models/
                    pointrcnn.yaml`` in bf16 on the 8 scans of
                    ``bench_assets/scans.npz``, weights drawn from a numpy
                    seed (the repository holds no trained PointRCNN
                    weights): per batch 2 mask launches, 2 resolves, 6 FPS
                    launches and no fused-NMS launch.
10. parity / pointrcnn — PointRCNN in fp32 (TF32 off) on 2 scans with the
                    same seeded weights against ``de6d_tpu_torch/testdata/
                    pointrcnn_jax_ref.npz`` (:func:`check_pointrcnn_parity`).

11. kernels / matrix_fps — the f-fps kernel against its plain version,
                    identical picks at the dispatched cluster size and at
                    every other one: the served 3DSSD model's real
                    xyz-plus-feature matrices (8 x 4096 -> 512, 8 x 512 ->
                    256), a ragged mask with fewer valid points than
                    picks and with none, N = 1,
                    1000, 2047 (exact ties), 4095, 4096 (exact ties planted
                    across the CTAs' slice boundaries), 5000, 9000, 16384;
                    kernel ms, bytes bound, the dispatched variant's latency
                    floor beside the first, single-block kernel's, plain ms;
                    at SA2 and SA3 every cluster size's ms and floor; the
                    SA2 matrix against float64; FPS and NMS at 3DSSD's
                    shapes; what the seeded weights give.
12. serve / 3dssd — ``StreamingDetector`` with ``configs/kitti_models/
                    3dssd_car.yaml`` in bf16 on the 8 scans of
                    ``bench_assets/scans.npz``, seeded weights: per batch 2
                    f-fps launches, 2 FPS launches, 1 fused-NMS launch.
13. parity / 3dssd — 3DSSD in fp32 (TF32 off) on 2 scans against
                    ``de6d_tpu_torch/testdata/ssd3d_jax_ref.npz``
                    (:func:`check_point_parity`: every sampling call's picks,
                    candidates, detections).
14. serve / iassd — the same with ``configs/kitti_models/IA-SSD.yaml``
                    (first the NMS on its candidates), a
                    shorter window: 2 FPS launches, no f-fps launch (the
                    shipped config samples with D-FPS and ctr_aware), 1
                    fused-NMS launch.
15. parity / iassd — IA-SSD against ``de6d_tpu_torch/testdata/
                    iassd_jax_ref.npz``.

16. kernels / lookup — the neighbour-table kernel against
                    ``neighbor_table_plain`` (hit and idx identical
                    everywhere) at the 8 tables the served SECOND model
                    builds per batch (recorded from one bf16 forward of
                    the 8 scans), sites on every grid face (submanifold,
                    strided, the (3, 1, 1) z-conv), INVALID rows inside,
                    an empty sample; the standalone lookup kernel against
                    its plain version on the same tables' neighbour keys,
                    an empty table, all-INVALID queries, queries outside
                    the keys, tables of 40,000 and 120,000 keys; for both,
                    kernel ms, plain ms, the library yardstick (key
                    generation + ``torch.searchsorted``; ``searchsorted``)
                    and the bytes bound; each stage's active sites; the
                    fused NMS on SECOND's candidates.
17. kernels / sparse_conv — the gather-GEMM kernel against its plain
                    version: the dispatched launch must be the variant of
                    ``sparse_conv.plan``, and every variant that takes the
                    shape (bf16: resident or streamed weights; fp32: simt)
                    is checked, at the 12 served layers in bf16 and fp32,
                    Cin = 48 / Cout = 40, Cin = 1 / Cout = 1 / K = 5,
                    Cout = 128 / K = 27, tiles with no hit and with one,
                    and a random table; per-layer variant and ms (each
                    variant's ms at the served layers), plain ms, the bound
                    from these inputs' hits and the dense bound at the
                    caps; the batch total beside the earlier kernel's.
18. serve / second — ``StreamingDetector`` with ``configs/kitti_models/
                    second.yaml`` in bf16, the trained ``bench_assets/
                    second_params.npz``, the 8 scans clipped to SECOND's
                    range: per batch 8 neighbour-table launches, no
                    standalone lookup, 12 sparse-conv launches, the fused
                    NMS.
19. parity / second — SECOND in fp32 (TF32 off) on 2 scans against
                    ``de6d_tpu_torch/testdata/second_jax_ref.npz``
                    (:func:`check_second_parity`: stage keys, candidates,
                    detections).
19a. kernels / sparse_conv_grad — the sparse conv's backward on the card
                    against its plain versions at the 12 layers of a
                    SECOND train step on the fixture's batch (B = 4), fp32
                    (1e-5 of each result's max) and bf16 (``CONV_TOL``):
                    the data gradient (the forward kernel on the table's
                    transpose: a submanifold layer's own table through the
                    mirrored offsets, bit-equal to the kernel on the
                    scattered transpose; a strided layer's transposed
                    table), the weight-gradient kernel (bit-equal over two
                    runs), the transposed-table kernel (equal to its plain
                    version and to the scatter of the forward table); a
                    layer without a hit, every row invalid, V = 1, a
                    sample without sites, a non-contiguous cotangent; ms
                    by events and in a CUDA graph, the plain versions'
                    (autograd through ``sparse_conv_plain``), the bounds
                    of ``sparse_conv.work_backward`` and
                    ``lookup.transposed_bytes``; the step's transposition
                    (4 strided tables, the submanifold layers 0 launches)
                    against its bound and its latency floor (an empty
                    kernel in a graph, 4 times); the fp32 forward at the
                    same 12 layers (ms, graph ms, plain ms, the bound of
                    ``sparse_conv.work``).
19b. parity / train_second — SECOND's train step in fp32 (TF32 off) from
                    ``bench_assets/second_params.npz`` on the batch stored
                    in ``de6d_tpu_torch/testdata/second_train_jax_ref.npz``
                    (the JAX loader's first batch of 4 on ``data/kitti``):
                    stage keys and labels identical; targets, loss terms,
                    gradient norm, gradients, ``MaskedBatchNorm``
                    statistics and 3 Adam steps within
                    :data:`SECOND_TRAIN_TOL`; this card's fp32 step within
                    :data:`SECOND_TRAIN_F64` of its float64 step
                    (:func:`check_second_train_parity`).
19c. train / second — ``train_model`` with ``second.yaml`` as shipped
                    (fp32, cuDNN's TF32 off as ``tools/train.py`` sets
                    it) at batch 4 on the fixture's frames,
                    :data:`TRAIN_STEPS` steps: step ms, steps/s, frames/s,
                    device ms and idle share (5-step profiler window),
                    peak memory, the loss falling, exactly 8 neighbour
                    tables, 12 conv forwards, 11 data gradients (7 of
                    them on their own, mirrored table), 12 weight
                    gradients and 4 transposed tables a step and no other
                    kernel launch.
19d. train / second_kitti — ``tools/train.py`` on ``second.yaml`` for one
                    epoch of ``data/kitti`` at batch 4 from the fresh
                    init, as phase 4e: steps/s, the loader's share, the
                    loss falling, the launches of 19c a step, the
                    checkpoint; the post-training eval with 8 neighbour
                    tables, 12 convs and 1-2 fused-NMS launches a batch.
19e. eval / second_kitti — as phase 4f with SECOND: the trained weights
                    over the 100 val frames at batch 8, fp32 against
                    ``de6d_tpu_torch/testdata/second_eval_jax_ref.npz``;
                    bf16 ms per frame with 8 neighbour tables, 12 convs
                    and 1-2 fused-NMS launches a batch; ``tools/test.py
                    --ckpt`` on 19d's checkpoint.

20. kernels / pv_rcnn — from one bf16 forward of the served PV-RCNN model
                    (``configs/kitti_models/pv_rcnn.yaml``, weights drawn
                    from a numpy seed) on the 8 scans clipped to its
                    range: the FPS kernel at its keypoint shape (8 x 16384
                    -> 2048) and the mask and resolve kernels on its 8 x
                    1024 proposals and 8 x 100 final candidates, each
                    against its plain version as in phases 5 and 8.
21. serve / pv_rcnn — ``StreamingDetector`` with that model in bf16: per
                    batch 1 FPS launch, 2 mask launches, 2 resolves, 8
                    neighbour tables, 12 sparse convs, and no fused NMS,
                    canvas, standalone lookup or f-fps.
22. parity / pv_rcnn — PV-RCNN in fp32 (TF32 off) on 2 scans against
                    ``de6d_tpu_torch/testdata/pvrcnn_jax_ref.npz``
                    (:func:`check_pvrcnn_parity`: keypoint picks,
                    proposals, RoIs, ``rcnn_cls`` / ``rcnn_reg``,
                    detections).

The line before the last is the card's name and power limit, the one
before it a JSON summary of the kernels, the last line
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CFG = ROOT / "configs/kitti_models/pointpillar.yaml"
PARAMS = ROOT / "bench_assets/pointpillar_params.npz"
SCANS = ROOT / "bench_assets/scans.npz"
REF = ROOT / "de6d_tpu_torch/testdata/pointpillar_jax_ref.npz"
DET6D_CFG = ROOT / "configs/kitti_models/det6d_car.yaml"
DET6D_PARAMS = ROOT / "bench_assets/det6d_car_params.npz"
DET6D_SCANS = ROOT / "bench_assets/det6d_car_scans.npz"
DET6D_REF = ROOT / "de6d_tpu_torch/testdata/det6d_jax_ref.npz"
DET6D_SLOPED_CFG = ROOT / "configs/slopedkitti_models/det6d_car.yaml"
DET6D_TRAIN_REF = ROOT / "de6d_tpu_torch/testdata/det6d_train_jax_ref.npz"
DET6D_EVAL_REF = ROOT / "de6d_tpu_torch/testdata/det6d_eval_jax_ref.npz"
SLOPEDKITTI_DIR = ROOT / "data/slopedkitti"
RCNN_CFG = ROOT / "configs/kitti_models/pointrcnn.yaml"
RCNN_REF = ROOT / "de6d_tpu_torch/testdata/pointrcnn_jax_ref.npz"
RCNN_SEED = 2026  # numpy seed of PointRCNN's weights (weights.seeded_flax)
SSD3D_CFG = ROOT / "configs/kitti_models/3dssd_car.yaml"
SSD3D_REF = ROOT / "de6d_tpu_torch/testdata/ssd3d_jax_ref.npz"
IASSD_CFG = ROOT / "configs/kitti_models/IA-SSD.yaml"
IASSD_REF = ROOT / "de6d_tpu_torch/testdata/iassd_jax_ref.npz"
SSD3D_SEED = IASSD_SEED = 2026  # no trained weights in the repository
SECOND_CFG = ROOT / "configs/kitti_models/second.yaml"
SECOND_PARAMS = ROOT / "bench_assets/second_params.npz"
SECOND_REF = ROOT / "de6d_tpu_torch/testdata/second_jax_ref.npz"
PVRCNN_CFG = ROOT / "configs/kitti_models/pv_rcnn.yaml"
PVRCNN_REF = ROOT / "de6d_tpu_torch/testdata/pvrcnn_jax_ref.npz"
PVRCNN_SEED = 2026  # no trained PV-RCNN weights in the repository
TRAIN_REF = ROOT / "de6d_tpu_torch/testdata/pointpillar_train_jax_ref.npz"
KITTI_DIR = ROOT / "data/kitti"
LOADER_REF = ROOT / "de6d_tpu_torch/testdata/kitti_loader_jax_ref.npz"
EVAL_REF = ROOT / "de6d_tpu_torch/testdata/pointpillar_eval_jax_ref.npz"
EVAL_BATCH = 8
# a recall counter or an AP may part from the reference only at a box
# whose IoU lies this close to the threshold in both runs
PARTING_IOU = 1e-3
TRAIN_STEPS = 30  # steps of the train phase, after one warm step
TRAIN_PROFILE_STEPS = 5

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# H100 SXM fp32 outside the tensor cores, an FMA counted as two; the
# NMS library is built with -fmad=false, so its instructions issue at
# most at half this rate (33.5e12 per second).
FP32_FLOPS = 67e12
PARITY_TOL = 1e-3  # metres / score units, see the parity phase
# An entry of the f-fps distance matrix, max(|a|² + |b|² − 2a·b, 0) per
# term, is a difference of fp32 sums that cancels; its error is a few
# ulps of the summands |a|² + |b|², whatever order the sums are taken in.
MATRIX_RTOL = 1e-6
SERVE_S = 3.0  # length of each pipelined serve window
SERIAL_BATCHES = 10
PROFILE_BATCHES = 20


def matrix_tolerance(scale):
    """The allowed distance of an f-fps matrix entry from its exact value,
    given ``scale``: the entry's ``|a|² + |b|²``, summed over the xyz and
    the (gamma-weighted) feature term."""
    return MATRIX_RTOL * scale


def fail(msg):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def time_ms(fn, iters, warmup=2):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters=20, replays=5):
    """Device time of one call of ``fn``: ``iters`` calls captured in a
    CUDA graph and replayed, so the host's launch overhead, which
    ``time_ms`` also sees when the kernel is short, is gone."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # attributes and allocations outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * iters)


def spec_from_cfg(cfg):
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        DatasetSpec,
    )

    kw = dict(
        class_names=tuple(cfg.CLASS_NAMES),
        point_feature_dim=4,
        point_cloud_range=tuple(float(x) for x in
                                cfg.DATA_CONFIG.POINT_CLOUD_RANGE),
    )
    for vox in cfg.DATA_CONFIG.DATA_PROCESSOR:  # point models have none
        if vox["NAME"] == "transform_points_to_voxels":
            kw.update(
                voxel_size=tuple(float(x) for x in vox["VOXEL_SIZE"]),
                max_voxels=int(vox["MAX_NUMBER_OF_VOXELS"]["test"]),
                max_points_per_voxel=int(vox["MAX_POINTS_PER_VOXEL"]),
            )
    return DatasetSpec(**kw)


def build_model(compute_dtype, dev, cfg_path=CFG, params=PARAMS):
    """The port's model for one yaml with its trained weights, or, with
    ``params`` an int, with weights drawn from that numpy seed. In fp32
    the slots' own compute-dtype overrides are dropped: fp32 everywhere;
    ``compute_dtype`` None keeps the config's own dtypes."""
    from de6d_tpu_torch import weights
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models import build_network

    cfg = cfg_from_yaml_file(cfg_path)
    mc = copy.deepcopy(cfg.MODEL)
    if compute_dtype is not None:
        mc["COMPUTE_DTYPE"] = compute_dtype
    if compute_dtype == "float32":
        for slot in mc.values():
            if isinstance(slot, dict):
                slot.pop("_COMPUTE_DTYPE", None)
    model = build_network(mc, len(cfg.CLASS_NAMES), spec_from_cfg(cfg),
                          device=dev)
    flat = (weights.seeded_flax(model, params) if isinstance(params, int)
            else weights.load_flax_npz(params))
    weights.load_into(model, flat)
    return model, mc, len(cfg.CLASS_NAMES)


def load_scans():
    """The real scans as (8, N, 4) plus the bench's padding mask."""
    import numpy as np

    pts = np.load(SCANS)["points"].astype(np.float32)
    return pts, ~np.all(pts == 0, axis=-1)


def load_clipped_scans(cfg_path, scans):
    """8 scans prepared for a point model as bench.py does: real rows (not
    all zero) clipped into the config's point cloud range ± 0.01, padding
    zeroed and masked."""
    import numpy as np

    from de6d_tpu_torch.config import cfg_from_yaml_file

    pc = [float(x) for x in
          cfg_from_yaml_file(cfg_path).DATA_CONFIG.POINT_CLOUD_RANGE]
    pts = np.load(scans)["points"].astype(np.float32)
    mask = ~np.all(pts == 0, axis=-1)
    for d in range(3):
        pts[..., d] = np.clip(pts[..., d], pc[d] + 0.01, pc[d + 3] - 0.01)
    pts[~mask] = 0.0
    return pts, mask


def load_det6d_scans():
    return load_clipped_scans(DET6D_CFG, DET6D_SCANS)


def load_rcnn_scans():
    return load_clipped_scans(RCNN_CFG, SCANS)


def load_ssd3d_scans():
    """For 3DSSD, 3DSSD-SASA and IA-SSD (one KITTI range)."""
    return load_clipped_scans(SSD3D_CFG, SCANS)


def load_second_scans():
    return load_clipped_scans(SECOND_CFG, SCANS)


def load_pvrcnn_scans():
    return load_clipped_scans(PVRCNN_CFG, SCANS)


# ---------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------

def nms_iou_count(boxes, counts, keep, thresh, post_k):
    """Pairs the NMS walk needs on this input, and of those the pairs the
    kernels' bound pre-test leaves for the full IoU: per live column, the
    kept boxes up to the first suppressor, plus the live pairs of each
    diagonal tile. Replays the walk on the host."""
    import torch

    from de6d_tpu_torch.ops import iou3d
    from de6d_tpu_torch.ops.kernels import nms_pretest as npt
    from de6d_tpu_torch.ops.kernels.nms_fused import BLK

    total = survivors = 0
    packed = iou3d.pack_bev(boxes[..., :7])
    box_b = npt.bounds(packed)
    pretest = thresh >= npt.MIN_THRESH
    for b in range(boxes.shape[0]):
        cnt = int(counts[b])
        kept = []
        for col0 in range(0, boxes.shape[1], BLK):
            if not (col0 < cnt and len(kept) < post_k):
                break
            col1 = min(col0 + BLK, cnt)
            cols = packed[b, :, col0:col1]
            col_b = tuple(v[b:b + 1, col0:col1] for v in box_b)
            alive = torch.arange(col0, col1, device=boxes.device)
            if kept:
                idx = torch.tensor(kept, device=boxes.device)
                over = iou3d.pairwise_iou_packed(packed[b][:, idx],
                                                 cols) > thresh
                hit = over.any(dim=0)
                first = torch.where(hit, over.int().argmax(dim=0) + 1,
                                    len(kept))
                total += int(first.sum())
                tested = (torch.arange(len(kept), device=boxes.device)[:, None]
                          < first[None])
                if pretest:
                    tested &= ~npt.skippable_pairs(
                        tuple(v[b:b + 1, idx] for v in box_b), col_b)[0]
                survivors += int(tested.sum())
                alive = alive[~hit]
            n_live = len(alive)
            total += n_live * (n_live - 1) // 2
            pairs = torch.ones(n_live, n_live, dtype=torch.bool,
                               device=boxes.device).triu(1)
            if pretest and n_live:
                ab = tuple(v[b:b + 1, alive] for v in box_b)
                pairs &= ~npt.skippable_pairs(ab, ab)[0]
            survivors += int(pairs.sum())
            kb = keep[b, col0:col0 + BLK].nonzero().flatten() + col0
            kept.extend(kb.tolist())
    return total, survivors


def check_canvas(feat, lin, ny, nx, report):
    import torch

    from de6d_tpu_torch.ops.kernels import canvas

    for dt in (torch.bfloat16, torch.float32):
        f = feat.to(dt)
        got = canvas.scatter_canvas(f, lin, ny, nx)
        ref = canvas.scatter_canvas_plain(f, lin, ny, nx)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"canvas {dt}: kernel differs from the plain version")
    f = feat.to(torch.bfloat16)
    b, v, c = f.shape
    g = ny * nx
    valid = lin < g
    n_valid = int(valid.sum())

    def library():
        out = torch.zeros(b, g, c, dtype=f.dtype, device=f.device)
        bi = torch.arange(b, device=f.device)[:, None].expand(b, v)[valid]
        out.index_put_((bi, lin[valid].long()), f[valid])
        return out

    if not torch.equal(library().reshape(b, ny, nx, c),
                       canvas.scatter_canvas_plain(f, lin, ny, nx)):
        fail("canvas: index_put_ yardstick differs")
    nbytes = b * g * c * 2 + n_valid * c * 2 + b * v * 4
    report["canvas"] = {
        "name": "scatter_canvas",
        "route": "cuda",
        "source": "de6d_tpu_torch/csrc/canvas.cu",
        "replaces": "de6d_tpu/ops/pallas/canvas.py:94",
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: canvas.scatter_canvas(f, lin, ny, nx), 50),
        "plain_ms": time_ms(
            lambda: canvas.scatter_canvas_plain(f, lin, ny, nx), 20),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(library, 20),
        "shape": f"feat {tuple(f.shape)} bf16, {n_valid} valid pillars "
                 f"-> canvas ({b}, {ny}, {nx}, {c})",
    }


def check_nms(cases, thresh, post_k):
    """cases: {label: (boxes (B, P, 7+), counts (B,))} → a result line per
    case: keep flags identical to the plain version's, the kernel's
    corners bit-equal to ``iou3d.pack_bev``'s, timings (by events, and the
    device's alone in a CUDA graph), the pre-test's survivor share and
    both bounds."""
    import torch

    from de6d_tpu_torch.ops import iou3d
    from de6d_tpu_torch.ops.kernels import nms_fused, nms_pretest
    from de6d_tpu_torch.ops.nms import _compact

    lines = {}
    for label, (boxes, counts) in cases.items():
        packed = iou3d.pack_bev(boxes[..., :7]).contiguous()
        corners = nms_fused.pack_bev(boxes)
        torch.cuda.synchronize()
        if not torch.equal(corners.view(torch.int32),
                           packed.view(torch.int32)):
            fail(f"nms {label}: the kernel's corners differ from "
                 "iou3d.pack_bev")
        got = nms_fused.nms_keep_batched(boxes, counts, thresh, post_k)
        ref = nms_fused.nms_keep_batched_plain(boxes, counts, thresh, post_k)
        torch.cuda.synchronize()
        gs, gc = _compact(got, post_k)
        rs, rc = _compact(ref, post_k)
        if not (torch.equal(gc, rc) and torch.equal(gs, rs)):
            fail(f"nms {label}: selections differ from the plain version")
        err = float((got.int() - ref.int()).abs().max())
        ious, survivors = nms_iou_count(boxes, counts, ref, thresh, post_k)
        b, p = boxes.shape[:2]
        nbytes = 7 * 4 * int(counts.clamp(max=p).sum()) + b * p + b * 4
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = (ious * nms_pretest.PRETEST_FLOPS
                 + survivors * nms_fused.FLOPS_PER_IOU) / FP32_FLOPS
        t_all = ious * nms_fused.FLOPS_PER_IOU / FP32_FLOPS
        lines[label] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: nms_fused.nms_keep_batched(
                boxes, counts, thresh, post_k), 20),
            "device_ms": graph_ms(lambda: nms_fused.nms_keep_batched(
                boxes, counts, thresh, post_k)),
            "pack_bev_ms": time_ms(lambda: iou3d.pack_bev(boxes[..., :7]),
                                   20),
            "plain_ms": time_ms(lambda: nms_fused.nms_keep_batched_plain(
                boxes, counts, thresh, post_k), 2, warmup=1),
            # what the function needs: the pre-test on every pair the walk
            # tests, the IoU on the pairs it does not decide
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bound_all_pairs_ms": max(t_all, t_bytes) * 1e3,
            "ious": ious,
            "survivors": survivors,
            "survivor_share": survivors / ious if ious else None,
            "corners_bit_equal": True,
            "kept": gc.tolist(),
            "shape": f"boxes ({b}, {p}, {boxes.shape[2]}), live "
                     f"{counts.tolist()}, post_k {post_k}",
        }
        ln = lines[label]
        share = ln["survivor_share"]
        print(f"kernels: nms {label}: identical selections, corners "
              f"bit-equal to pack_bev, {ln['ms']:.4f} ms (device "
              f"{ln['device_ms']:.4f} ms in a graph; pack_bev alone "
              f"{ln['pack_bev_ms']:.4f} ms), plain {ln['plain_ms']:.2f} ms, "
              f"bound {ln['bound_ms']:.5f} ms (all pairs "
              f"{ln['bound_all_pairs_ms']:.5f}), {ious} pairs walked, "
              f"{survivors} survive the pre-test ("
              f"{'-' if share is None else f'{share:.4%}'})", flush=True)
    return lines


def phase_kernels(dev, report):
    import torch

    from de6d_tpu_torch.models.backbones_2d.map_to_bev import cell_ids
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        select_candidates,
    )
    from de6d_tpu_torch.ops.nms import CASCADE_K0, NEG_INF

    model, mc, _ = build_model("bfloat16", dev)
    pts, mask = load_scans()
    with torch.no_grad():
        bd = model.maybe_voxelize({
            "points": torch.from_numpy(pts).to(dev),
            "points_mask": torch.from_numpy(mask).to(dev),
        })
        bd = model.vfe(bd)
        grid = model.spec.grid_size
        lin = cell_ids(bd["voxel_coords"], grid[1], grid[0])
        check_canvas(bd["pillar_features"], lin, grid[1], grid[0], report)
        c = report["canvas"]
        print(f"kernels: canvas bit-exact (bf16, fp32), {c['ms']:.4f} ms, "
              f"plain {c['plain_ms']:.4f} ms, index_put_ "
              f"{c['library_ms']:.4f} ms, bound {c['bound_ms']:.4f} ms",
              flush=True)

        out = model({"points": torch.from_numpy(pts).to(dev),
                     "points_mask": torch.from_numpy(mask).to(dev)})
        post_cfg = mc["POST_PROCESSING"]
        worst_cfg = copy.deepcopy(post_cfg)
        worst_cfg["SCORE_THRESH"] = 0.0
        nms_cfg = post_cfg["NMS_CONFIG"]
        cases = {}
        for label, cfg in (("realistic", post_cfg), ("worst_case", worst_cfg)):
            boxes, scores, _ = select_candidates(out, cfg)
            counts = (scores > NEG_INF / 2).sum(-1).to(torch.int32)
            boxes = boxes.contiguous()
            cases[f"{label}_prefix"] = (
                boxes[:, :CASCADE_K0].contiguous(),
                counts.clamp(max=CASCADE_K0),
            )
            cases[f"{label}_full"] = (boxes, counts)
        lines = check_nms(cases, float(nms_cfg["NMS_THRESH"]),
                          int(nms_cfg["NMS_POST_MAXSIZE"]))
    main = lines[next(iter(cases))]  # the main path's case
    report["nms"] = {
        "name": "nms_keep_batched",
        "route": "cuda",
        "source": "de6d_tpu_torch/csrc/nms_fused.cu",
        "replaces": "de6d_tpu/ops/pallas/nms_fused.py:205",
        **{k: main[k] for k in ("max_abs_err", "ms", "device_ms",
                                "plain_ms", "bound_ms",
                                "bound_by", "bound_all_pairs_ms",
                                "survivor_share")},
        "library_ms": None,
        "cases": lines,
    }
    return model, mc


def phase_nms_case(label, model, mc, pts, mask, report):
    """The fused NMS on the candidates of one bf16 forward of ``model`` on
    the 8 scans (the shape and post_k its post-processing launches)."""
    import torch

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        select_candidates,
    )
    from de6d_tpu_torch.ops.nms import NEG_INF

    post_cfg = mc["POST_PROCESSING"]
    with torch.no_grad():
        out = model({"points": torch.from_numpy(pts).cuda(),
                     "points_mask": torch.from_numpy(mask).cuda()})
        boxes, scores, _ = select_candidates(out, post_cfg)
    counts = (scores > NEG_INF / 2).sum(-1).to(torch.int32)
    nms_cfg = post_cfg["NMS_CONFIG"]
    report["nms"]["cases"].update(check_nms(
        {label: (boxes[..., :7].contiguous(), counts)},
        float(nms_cfg["NMS_THRESH"]),
        min(int(nms_cfg["NMS_POST_MAXSIZE"]), boxes.shape[1])))


def check_grad_guard(report):
    """On the card, ``scatter_canvas`` on a requires-grad input returns a
    tensor with a ``grad_fn`` whose gradient (the backward kernel) equals
    the CPU plain version's bit for bit (fp32); so does ``sparse_conv``
    under ``enable_grad``, on a submanifold and a strided table, whose
    feature and weight gradients (its backward kernels) equal the CPU
    plain autograd's within 1e-5 of each leaf's largest |entry| (fp32,
    sums in another order)."""
    import numpy as np
    import torch

    from de6d_tpu_torch.ops import sparse
    from de6d_tpu_torch.ops.kernels import canvas

    rng = np.random.RandomState(3)
    ny, nx, v, c = 6, 5, 12, 8
    lin = torch.from_numpy(np.concatenate(
        [np.sort(rng.choice(ny * nx, 9, replace=False)),
         [ny * nx] * 3]).astype(np.int32)[None])
    feat = torch.from_numpy(rng.standard_normal((1, v, c)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((1, ny, nx, c)).astype(
        np.float32))
    cpu = feat.clone().requires_grad_(True)
    canvas.scatter_canvas(cpu, lin, ny, nx).backward(ct)
    dev = feat.cuda().requires_grad_(True)
    with torch.enable_grad():
        out = canvas.scatter_canvas(dev, lin.cuda(), ny, nx)
        if out.grad_fn is None:
            fail("grad guard: scatter_canvas on the card lost its grad_fn")
        out.backward(ct.cuda())
    torch.cuda.synchronize()
    if not torch.equal(dev.grad.cpu(), cpu.grad):
        fail("grad guard: the canvas gradient on the card differs from the "
             "CPU plain version's")

    grid, cin, cout = (5, 8, 7), 8, 16
    keys = np.full((2, 60), sparse.INVALID, np.int32)
    for b, n in ((0, 60), (1, 41)):
        keys[b, :n] = np.sort(rng.choice(np.prod(grid), n, replace=False))
    keys = torch.from_numpy(keys)
    out_keys, out_grid = sparse.downsample_coords(keys, grid, (2, 2, 2),
                                                  (1, 1, 1), 40)
    feats = torch.from_numpy(rng.standard_normal((2, 60, cin)).astype(
        np.float32))
    w = torch.from_numpy((rng.standard_normal((27, cin, cout)) * 0.2).astype(
        np.float32))

    def grads(device, strided):
        k = keys.to(device)
        f = feats.to(device).clone().requires_grad_(True)
        wt = w.to(device).clone().requires_grad_(True)
        with torch.enable_grad():
            if strided:
                ok = out_keys.to(device)
                y = sparse.strided_conv(f, k, grid, wt, (3, 3, 3), (2, 2, 2),
                                        (1, 1, 1), ok, out_grid)
            else:
                table = sparse.subm_neighbor_table(k, grid)
                y = sparse.subm_conv_table(f, *table, wt,
                                           k != sparse.INVALID)
            if y.grad_fn is None:
                fail(f"grad guard: sparse_conv on {device} has no grad_fn")
            ct = torch.from_numpy(np.random.RandomState(5).standard_normal(
                tuple(y.shape)).astype(np.float32)).to(device)
            (y * ct).sum().backward()
        return f.grad.cpu(), wt.grad.cpu()

    worst = 0.0
    for strided in (False, True):
        for got, want in zip(grads("cuda", strided), grads("cpu", strided)):
            e = rel_err(got, want)
            if not e <= 1e-5:
                fail(f"grad guard: the sparse_conv gradient on the card "
                     f"({'strided' if strided else 'submanifold'}) differs "
                     f"from the CPU plain autograd's by {e:.3g} of its max")
            worst = max(worst, e)
    report["grad_guard"] = {"scatter_canvas": "gradient",
                            "sparse_conv": "gradient",
                            "sparse_conv_max_rel_err": worst}
    print("grad guard: scatter_canvas on the card returns a gradient (the "
          "backward kernel) bit-equal to the CPU plain version's; "
          "sparse_conv on the card has a grad_fn, and its feature and "
          "weight gradients (the backward kernels) on a submanifold and a "
          f"strided table are within {worst:.3g} of the CPU plain "
          "autograd's (of each leaf's max)", flush=True)


# ---------------------------------------------------------------------
# serve and parity
# ---------------------------------------------------------------------

def phase_serve(tag, model, mc, nc, pts, mask, kernels, box_width, profile,
                per_batch=None, serve_s=SERVE_S):
    """Serve the 8 scans at batch 8 through ``StreamingDetector``: a warm
    batch, SERIAL_BATCHES synchronous batches, then a pipelined window of
    ``serve_s`` seconds. ``kernels`` maps a name to a wrapper whose launch count is
    zeroed before the run and read after it; each must rise (or rise by
    exactly ``per_batch[name]`` per batch, which may be 0 for a kernel the
    path must not reach)."""
    import numpy as np
    import torch

    from de6d_tpu_torch.serving.streaming import StreamingDetector

    frames = [p[m] for p, m in zip(pts, mask)]  # padding rows dropped
    det = StreamingDetector(model, mc, nc, max_points=pts.shape[1],
                            device="cuda")
    torch.cuda.reset_peak_memory_stats()
    for fn in kernels.values():
        fn.launches = 0
    warm = det.detect_batch(frames)
    lat = []
    for _ in range(SERIAL_BATCHES):
        s = time.perf_counter()
        det.detect_batch(frames)
        lat.append(time.perf_counter() - s)
    n_req = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < serve_s:
        det.submit_batch(frames)  # finished frames wait in the detector
        n_req += 1
    results = []
    while (r := det.result()) is not None:
        results.append(r)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in kernels.items()}
    batches = n_req + 1 + SERIAL_BATCHES
    if len(results) != n_req * len(frames):
        fail(f"{tag}: {len(results)} results for {n_req * len(frames)} scans")
    for r in warm + results:
        if not (np.isfinite(r["boxes"]).all()
                and r["boxes"].shape[1] == box_width
                and len(r["boxes"]) <= 500):
            fail(f"{tag}: non-finite or malformed boxes")
    per_batch = per_batch or {}
    if any(n == 0 for k, n in launches.items() if per_batch.get(k, 1)):
        fail(f"{tag}: a kernel was not launched on the main path {launches}")
    for k, per in per_batch.items():
        if launches[k] != per * batches:
            fail(f"{tag}: {launches[k]} {k} launches in {batches} batches, "
                 f"expected {per} per batch")
    counts = [len(r["boxes"]) for r in results]
    sps = n_req * len(frames) / wall
    serial_ms = float(np.median(lat)) * 1e3
    out = {
        "scans_per_s": sps,
        "ms_per_scan": 1e3 / sps,
        "window_s": wall,
        "pipelined_batches": n_req,
        "serial_batch_ms": [x * 1e3 for x in lat],
        "serial_batch_median_ms": serial_ms,
        "mean_pred_count": float(np.mean(counts)),
        "pred_counts": counts[: len(frames)],
        "launches": launches,
        "batches": batches,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
    }
    print(f"{tag}: {sps:.2f} scans/s pipelined (depth {det.depth}, "
          f"{n_req} batches in {wall:.2f} s), {1e3 / sps:.3f} ms/scan, "
          f"serial batch-of-8 median {serial_ms:.2f} ms over "
          f"{SERIAL_BATCHES}, mean pred_count {np.mean(counts):.2f}, "
          f"launches {launches} over {batches} batches, peak "
          f"{out['peak_mem_gib']:.2f} GiB", flush=True)
    if profile:
        out["profile"] = phase_profile(tag, det, frames, serial_ms)
    return out


def phase_profile(tag, det, frames, serial_ms):
    from torch.profiler import ProfilerActivity, profile

    n = PROFILE_BATCHES
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            det.detect_batch(frames)
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        if dev_us > 0 and e.device_type.name == "CUDA":
            rows.append((e.key, dev_us / n, e.count / n))
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    idle = 1 - total / 1e3 / serial_ms
    # the hand-written kernels' device time per batch, every variant of a
    # kernel summed (profile names: "...(anonymous namespace)::<name><...")
    ours = {}
    for name, us, c in rows:
        if "(anonymous namespace)::" in name:
            kernel = name.split("::")[1].split("<")[0].split("(")[0]
            total_us_count = ours.setdefault(kernel, [0.0, 0.0])
            total_us_count[0] += us
            total_us_count[1] += c
    print(f"{tag} profile: {total:.1f} us device time per batch of 8 over "
          f"{n} batches ({len(rows)} kernels); idle {idle:.1%} of the "
          f"median serial batch; hand-written kernels "
          f"{ {k: f'{us:.1f} us x{c:.1f}' for k, (us, c) in ours.items()} }",
          flush=True)
    for name, us, c in rows[:12]:
        print(f"{tag} profile:   {us:10.1f} us  x{c:5.1f}  {name[:90]}")
    return {"batches": n, "device_us_per_batch": total,
            "idle_share_of_serial_batch": idle,
            "kernels_device_us_per_batch": ours,
            "top": [list(r) for r in rows[:25]]}


def phase_parity(dev, report):
    import numpy as np
    import torch

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        post_processing,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, mc, nc = build_model("float32", dev)
    pts, mask = load_scans()
    with torch.no_grad():
        out = model({"points": torch.from_numpy(pts[:2]).to(dev),
                     "points_mask": torch.from_numpy(mask[:2]).to(dev)})
        post = post_processing(out, mc["POST_PROCESSING"], nc)
    got = {k: v.cpu().numpy() for k, v in post.items()}
    ref = dict(np.load(REF))
    diffs = {}
    if not np.array_equal(got["pred_count"], ref["pred_count"]):
        fail(f"parity: counts {got['pred_count']} vs {ref['pred_count']}")
    for b, c in enumerate(ref["pred_count"].tolist()):
        if not np.array_equal(got["pred_labels"][b, :c],
                              ref["pred_labels"][b, :c]):
            fail(f"parity: labels of scan {b} differ")
        for k in ("pred_boxes", "pred_scores"):
            d = float(np.abs(got[k][b, :c] - ref[k][b, :c]).max(initial=0))
            diffs[k] = max(diffs.get(k, 0.0), d)
    if max(diffs.values()) > PARITY_TOL:
        fail(f"parity: max abs differences {diffs} > {PARITY_TOL}")
    report["parity"] = {"counts": got["pred_count"].tolist(),
                        "max_abs_diff": diffs}
    print(f"parity: fp32 (TF32 off) on 2 scans matches the JAX reference: "
          f"counts {got['pred_count'].tolist()}, max |d box| "
          f"{diffs['pred_boxes']:.3g}, max |d score| "
          f"{diffs['pred_scores']:.3g} (tol {PARITY_TOL})", flush=True)


# ---------------------------------------------------------------------
# PointPillars training: the canvas backward kernel, parity, a trainer
# ---------------------------------------------------------------------

def load_train_batch(dev):
    """The training batch of the fixture (4 synthetic KITTI frames through
    the JAX dataloader): points, points_mask, gt_boxes."""
    import numpy as np
    import torch

    with np.load(TRAIN_REF) as ref:
        return {k: torch.from_numpy(ref[k]).to(dev)
                for k in ("points", "points_mask", "gt_boxes")}


def train_opt_cfg():
    from de6d_tpu_torch.config import cfg_from_yaml_file

    return dict(cfg_from_yaml_file(CFG).OPTIMIZATION)


def phase_canvas_grad(report):
    """The canvas backward kernel against ``scatter_canvas_grad_plain`` on
    the card, bit-exact in bf16 and fp32: the voxelized training batch
    (4 x 16000 x 64 with its invalid suffix), every slot invalid, V = 1,
    a non-contiguous cotangent; kernel ms by events and in a CUDA graph,
    the plain version's and ``torch.gather`` + ``where``'s, the bytes
    bound."""
    import torch

    from de6d_tpu_torch.models.backbones_2d.map_to_bev import cell_ids
    from de6d_tpu_torch.ops.kernels import canvas

    model, _, _ = build_model("bfloat16", "cuda")
    with torch.no_grad():
        bd = model.vfe(model.maybe_voxelize(load_train_batch("cuda")))
    nx, ny = model.spec.grid_size[:2]
    del model
    lin = cell_ids(bd["voxel_coords"], ny, nx)
    b, v, c = bd["pillar_features"].shape
    gen = torch.Generator(device="cuda").manual_seed(0)
    ct = torch.randn((b, ny, nx, c), generator=gen, device="cuda")
    cases = {
        "train_batch": (ct, lin),
        "all_invalid": (ct, torch.full_like(lin, ny * nx)),
        "one_slot": (ct, lin[:, :1].contiguous()),
        "nchw_view": (ct.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1),
                      lin),
    }
    for dt in (torch.bfloat16, torch.float32):
        for label, (d_canvas, ids) in cases.items():
            d_canvas = d_canvas.to(dt)
            got = canvas.scatter_canvas_grad(d_canvas, ids)
            ref = canvas.scatter_canvas_grad_plain(d_canvas, ids)
            torch.cuda.synchronize()
            if not torch.equal(got, ref):
                fail(f"canvas_grad {label} {dt}: kernel differs from the "
                     "plain version")
    ct = ct.to(torch.bfloat16)
    g = ny * nx
    valid = lin < g
    n_valid = int(valid.sum())
    flat = ct.reshape(b, g, c)
    safe = torch.where(valid, lin, 0).long()[..., None].expand(-1, -1, c)

    def library():
        return torch.where(valid[..., None], torch.gather(flat, 1, safe), 0)

    if not torch.equal(library(), canvas.scatter_canvas_grad_plain(ct, lin)):
        fail("canvas_grad: the torch.gather yardstick differs")
    nbytes = n_valid * c * 2 + b * v * 4 + b * v * c * 2
    report["canvas_grad"] = {
        "name": "scatter_canvas_grad",
        "route": "cuda",
        "source": "de6d_tpu_torch/csrc/canvas.cu",
        "replaces": "de6d_tpu/ops/pallas/canvas.py:181",
        "max_abs_err": 0.0,
        "ms": time_ms(lambda: canvas.scatter_canvas_grad(ct, lin), 50),
        "graph_ms": graph_ms(lambda: canvas.scatter_canvas_grad(ct, lin)),
        "plain_ms": time_ms(
            lambda: canvas.scatter_canvas_grad_plain(ct, lin), 20),
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(library, 20),
        "cases": sorted(cases),
        "shape": f"cotangent ({b}, {ny}, {nx}, {c}) bf16, lin ({b}, {v}), "
                 f"{n_valid} valid pillars -> d_feat ({b}, {v}, {c})",
    }
    k = report["canvas_grad"]
    print(f"kernels / canvas_grad: bit-exact (bf16, fp32) on "
          f"{', '.join(sorted(cases))}; {k['ms']:.4f} ms by events, "
          f"{k['graph_ms']:.4f} ms in a graph, plain {k['plain_ms']:.4f} ms, "
          f"torch.gather + where {k['library_ms']:.4f} ms, bound "
          f"{k['bound_ms']:.5f} ms ({k['shape']})", flush=True)


def leaf_report(ref, prefix, got, norm_tol=None):
    """Compare ``got`` ({torch name: flat ndarray}) with the fixture's
    leaves under ``prefix``: whole leaves, or the stored entries and the
    largest |entry| of the large ones (whose norm, with ``norm_tol``, must
    be within that relative tolerance). Returns {name: (per-entry |d|, the
    leaf's largest |entry|)}; raises on a norm or shape that differs."""
    import numpy as np

    out = {}
    for name, g in got.items():
        if f"{prefix}/{name}" in ref:
            want = ref[f"{prefix}/{name}"]
            if want.shape != g.shape:
                raise RuntimeError(f"{prefix} {name}: shape {g.shape} vs "
                                   f"{want.shape}")
            out[name] = (np.abs(g - want), float(np.abs(want).max()))
            continue
        sample = ref[f"{prefix}_sample/{name}"]
        idx = np.linspace(0, g.size - 1, sample.size).astype(np.int64)
        out[name] = (np.abs(g[idx] - sample),
                     float(ref[f"{prefix}_max/{name}"]))
        if norm_tol is not None:
            norm = float(np.linalg.norm(g.astype(np.float64)))
            want_norm = float(ref[f"{prefix}_norm/{name}"])
            if abs(norm - want_norm) > norm_tol * want_norm:
                raise RuntimeError(f"{prefix} {name}: norm {norm} vs "
                                   f"{want_norm}")
    return out


# Tolerances of the full-width train parity against the JAX fp32 step,
# each with its reason. The JAX package's fp32 gradients on the CPU are
# themselves up to 1.75e-2 of a leaf's largest entry away from a float64
# evaluation of the same step (BatchNorm's backward cancels the nearly
# uniform gradient of the empty BEV cells), where the port's fp32 CPU
# gradients are within 3.7e-4 of it (trained weights, the fixture's
# batch: tests/test_torch_pointpillar_train.py::
# test_full_width_gradients_against_float64). So gradients are held at
# 2.5e-2 and the global gradient norm, which sums that noise, at 5e-4
# relative. Loss terms are held at 1e-4 relative, the BatchNorm
# statistics (fp32 sums over 214,272 positions a channel) at 2e-4
# relative + 1e-5. After 3 steps Adam has divided each entry by its own
# gradient's root-mean-square, so entries whose gradient sits at that
# noise move by up to their learning rate either way: the trajectory is
# held by the loss of each step (1e-4 relative) and every parameter
# within the summed learning rates. ``tests/test_torch_pointpillar_train.py``
# holds the tiny model, where the JAX gradients are accurate, to 1e-4
# (gradients) and 1e-5 (parameters after 3 steps).
TRAIN_TOL = {"loss": 1e-4, "grad_norm": 5e-4, "grad": 2.5e-2,
             "stats_rtol": 2e-4, "stats_atol": 1e-5, "reg_targets": 1e-5}


def check_train_parity(dev, steps=3):
    """PointPillars' train step in fp32 from the trained weights on the
    fixture's batch, against the JAX step stored in
    ``testdata/pointpillar_train_jax_ref.npz`` (dense assigner): labels
    identical; regression targets, loss terms, the gradient norm, every
    gradient (against its leaf's largest |entry|), the BatchNorm
    statistics after the step, the loss of each of ``steps`` steps and
    the parameters after them within :data:`TRAIN_TOL` (whose comment
    says why). Returns a report; raises RuntimeError where a check
    fails."""
    import numpy as np

    from de6d_tpu_torch.models.dense_heads.axis_aligned_assigner import (
        assign_targets,
    )
    from de6d_tpu_torch.train import (
        build_optimizer_and_schedule, create_train_state, make_train_step,
    )

    tol = TRAIN_TOL
    model, _, _ = build_model("float32", dev)
    ref = dict(np.load(TRAIN_REF))
    batch = load_train_batch(dev)
    head = model.dense_head
    tgt = assign_targets(head.anchors, head.anchor_group, head.matched_thr,
                         head.unmatched_thr, batch["gt_boxes"],
                         head.box_coder)
    labels = tgt["box_cls_labels"].reshape(-1).cpu().numpy()
    nz = np.flatnonzero(labels)
    if not (np.array_equal(nz, ref["labels_idx"])
            and np.array_equal(labels[nz], ref["labels_val"])):
        raise RuntimeError(f"train parity: labels differ ({nz.size} non-zero "
                           f"vs {ref['labels_idx'].size})")
    reg = tgt["box_reg_targets"].reshape(-1, 7).cpu().numpy()[ref["fg_idx"]]
    d_reg = float(np.abs(reg - ref["reg_targets_fg"]).max(initial=0))
    if d_reg > tol["reg_targets"]:
        raise RuntimeError(f"train parity: regression targets off by {d_reg}")

    opt, sched = build_optimizer_and_schedule(train_opt_cfg(), model, 1)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt)
    losses = []
    for i in range(steps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        if i == 0:
            metrics = {k: float(v) for k, v in m.items()}
            # copies: on the CPU .numpy() would alias what later steps
            # update in place
            grads = {n: p.grad.float().cpu().numpy().reshape(-1).copy()
                     for n, p in model.named_parameters()}
            stats = {n: b.cpu().numpy().copy()
                     for n, b in model.named_buffers() if "running" in n}
    params = {n: p.detach().cpu().numpy().reshape(-1)
              for n, p in model.named_parameters()}

    rel = {k: abs(v / float(ref[f"metric/{k}"]) - 1)
           for k, v in metrics.items()}
    for k, r in rel.items():
        if r > tol["grad_norm" if k == "grad_norm" else "loss"]:
            raise RuntimeError(
                f"train parity: {k} {metrics[k]} vs "
                f"{float(ref[f'metric/{k}'])} ({r:.3g} relative)")
    loss_rel = np.abs(np.asarray(losses) / ref["losses"] - 1)
    if loss_rel.max() > tol["loss"]:
        raise RuntimeError(f"train parity: losses {losses} vs "
                           f"{ref['losses'].tolist()}")
    grad_err = 0.0
    for name, (err, scale) in leaf_report(ref, "grad", grads,
                                          tol["grad"]).items():
        e = float(err.max(initial=0)) / max(scale, 1e-30)
        if e > tol["grad"]:
            raise RuntimeError(f"train parity: gradient {name} off by {e:.3g} "
                               f"of its leaf's max {scale}")
        grad_err = max(grad_err, e)
    stat_err = 0.0
    for name, b in stats.items():
        want = ref[f"stats/{name}"]
        if not np.allclose(b, want, rtol=tol["stats_rtol"],
                           atol=tol["stats_atol"]):
            raise RuntimeError(f"train parity: {name} after the step off by "
                               f"{np.abs(b - want).max()}")
        stat_err = max(stat_err, float(np.abs(b - want).max()))
    lr_sum = sum(sched(k) for k in range(steps))
    worst = 0.0
    parted = {}
    for name, (err, scale) in leaf_report(ref, "params3", params).items():
        if err.max(initial=0) > lr_sum:
            raise RuntimeError(f"train parity: parameters {name} after "
                               f"{steps} steps off by {err.max()} (learning "
                               f"rates summed {lr_sum})")
        worst = max(worst, float(err.max(initial=0)))
        parted[name] = float((err > 1e-5 * scale).mean())
    return {"labels_nonzero": int(nz.size),
            "positives": int((labels > 0).sum()),
            "max_reg_target_diff": d_reg, "metrics": metrics,
            "metrics_rel_diff": rel, "losses": losses,
            "losses_rel_diff": loss_rel.tolist(),
            "max_grad_diff_of_leaf_max": grad_err,
            "max_batch_stats_diff": stat_err,
            "params3_max_diff": worst, "lr_sum": lr_sum,
            "params3_share_beyond_1e-5_of_leaf_max": max(parted.values())}


def phase_train_parity(report):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    r = check_train_parity("cuda")
    report["train_parity"] = r
    print(f"parity / train_pointpillar: fp32 (TF32 off) matches the JAX "
          f"step: {r['labels_nonzero']} labelled anchors "
          f"({r['positives']} positive) identical, regression targets "
          f"{r['max_reg_target_diff']:.3g}, loss terms and grad_norm "
          f"within {max(r['metrics_rel_diff'].values()):.3g} relative "
          f"(loss {r['metrics']['loss']:.6f}, grad_norm "
          f"{r['metrics']['grad_norm']:.6f}), gradients within "
          f"{r['max_grad_diff_of_leaf_max']:.3g} of their leaf's max, BN "
          f"statistics {r['max_batch_stats_diff']:.3g}; losses of 3 steps "
          f"{[round(x, 6) for x in r['losses']]} (within "
          f"{max(r['losses_rel_diff']):.3g}), parameters after them within "
          f"{r['params3_max_diff']:.3g} (learning rates summed "
          f"{r['lr_sum']:.3g}; up to "
          f"{r['params3_share_beyond_1e-5_of_leaf_max']:.2%} of a leaf "
          f"beyond 1e-5 of its max)", flush=True)


class TimedLoader:
    """The fixed training batch once an epoch; notes when each step's
    batch is handed out."""

    def __init__(self, batch):
        self.batch = batch
        self.stamps = []

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        self.stamps.append(time.perf_counter())
        yield self.batch


class Scalars:
    """``tb_log`` stand-in that keeps the last value of each tag."""

    def __init__(self):
        self.last = {}

    def add_scalar(self, tag, value, step):
        self.last[tag] = value


def measure_train(tag, model, batch, opt_cfg, kernels, per_step,
                  steps=TRAIN_STEPS):
    """``train_model`` over one fixed batch, ``steps`` steps after one
    warm step (cuDNN's first calls): step ms from the loop itself
    (pipelined 1 deep), steps/s, frames/s, peak memory, the loss at the
    first and the last step (it must fall), launches of every kernel
    (``per_step[k]`` a step for kernel k, none of any other); then a
    torch.profiler window of :data:`TRAIN_PROFILE_STEPS` steps for the
    device time of a step. Returns (report, the profile's rows: (kernel,
    device us a step, launches a step), longest first)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from de6d_tpu_torch.train import (
        build_optimizer_and_schedule, create_train_state, make_train_step,
    )
    from de6d_tpu_torch.train.train_loop import train_model

    opt, sched = build_optimizer_and_schedule(opt_cfg, model, 1)
    state = create_train_state(model, opt)
    step = make_train_step(model, opt)
    t0 = time.perf_counter()
    state, m0 = step(state, batch)
    first_loss = float(m0["loss"])
    warm_ms = (time.perf_counter() - t0) * 1e3
    reset_launches(kernels)
    torch.cuda.reset_peak_memory_stats()
    loader = TimedLoader(batch)
    scalars = Scalars()
    t0 = time.perf_counter()
    state = train_model(model, opt, state, loader, opt_cfg,
                        total_epochs=steps, tb_log=scalars,
                        lr_schedule=sched, log_interval=steps + 1)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = read_launches(kernels)
    peak = torch.cuda.max_memory_allocated() / 2**30
    want = {k: steps * per_step.get(k, 0) for k in kernels}
    if launches != want:
        fail(f"{tag}: launches {launches} in {steps} steps, expected {want}")
    last_loss = scalars.last.get("train/loss")
    grad_norm = scalars.last.get("train/grad_norm")
    if last_loss is None or not (np.isfinite(last_loss)
                                 and np.isfinite(grad_norm)):
        fail(f"{tag}: last loss {last_loss}, grad_norm {grad_norm}")
    if not last_loss < first_loss:
        fail(f"{tag}: the loss did not fall on a fixed batch: first "
             f"{first_loss}, last {last_loss}")
    step_ms = np.diff(loader.stamps + [t_end]) * 1e3
    wall = t_end - t0
    med = float(np.median(step_ms))
    q1, q3 = np.percentile(step_ms, [25, 75])

    n_prof = TRAIN_PROFILE_STEPS
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            state, _ = step(state, batch)
        torch.cuda.synchronize()
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "cuda_time_total", 0)
        # kernels only: a user annotation's device range (the optimizer's
        # step) would count its kernels twice
        if (dev_us > 0 and e.device_type.name == "CUDA"
                and not getattr(e, "is_user_annotation", False)
                and not e.key.startswith("Optimizer.")):
            rows.append((e.key, dev_us / n_prof, e.count / n_prof))
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows) / 1e3
    b = int(batch["points"].shape[0])
    out = {
        "steps": steps, "batch": b, "warm_step_ms": warm_ms,
        "step_ms": step_ms.tolist(), "median_step_ms": med,
        "step_ms_iqr": [float(q1), float(q3)],
        "step_ms_min_max": [float(step_ms.min()), float(step_ms.max())],
        "steps_per_s": steps / wall, "frames_per_s": steps * b / wall,
        "device_ms_per_step": device_ms,
        "idle_share_of_median_step": 1 - device_ms / med,
        "peak_mem_gib": peak, "first_loss": first_loss,
        "last_loss": float(last_loss), "last_grad_norm": float(grad_norm),
        "launches": launches,
    }
    return out, rows


def train_line(tag, out, what):
    """The status line of a train phase."""
    q1, q3 = out["step_ms_iqr"]
    lo, hi = out["step_ms_min_max"]
    return (f"{tag}: {out['steps']} steps of batch {out['batch']} {what}: "
            f"median step {out['median_step_ms']:.2f} ms (IQR {q1:.2f}-"
            f"{q3:.2f}, min {lo:.2f}, max {hi:.2f}), "
            f"{out['steps_per_s']:.2f} steps/s, {out['frames_per_s']:.2f} "
            f"frames/s, device {out['device_ms_per_step']:.2f} ms a step "
            f"(profiler, {TRAIN_PROFILE_STEPS} steps), idle "
            f"{out['idle_share_of_median_step']:.1%} of the median step, "
            f"peak {out['peak_mem_gib']:.2f} GiB; loss "
            f"{out['first_loss']:.4f} -> {out['last_loss']:.4f}, grad_norm "
            f"{out['last_grad_norm']:.4f}; launches {out['launches']}; warm "
            f"step {out['warm_step_ms']:.0f} ms")


def phase_train(report, kernels, profile):
    """``train / pointpillar``: :func:`measure_train` over the fixture's 4
    frames at full width in bf16 from the trained weights, exactly one
    canvas forward and one backward launch a step."""
    model, _, _ = build_model("bfloat16", "cuda")
    out, rows = measure_train(
        "train / pointpillar", model, load_train_batch("cuda"),
        train_opt_cfg(), kernels, {"canvas": 1, "canvas_grad": 1})
    ours = {k: sum(us for name, us, _ in rows
                   if f"::{k}(" in name or name.startswith(f"{k}("))
            for k in ("canvas_kernel", "canvas_grad_kernel")}
    out.update(compute_dtype="bfloat16", kernels_device_us_per_step=ours)
    if profile:
        out["profile_top"] = [list(r) for r in rows[:25]]
    report["train"] = out
    print(train_line("train / pointpillar", out, "bf16 at full width "
                     "through train_model") + f"; hand-written kernels "
          f"{ {k: f'{us:.1f} us' for k, us in ours.items()} }", flush=True)
    if profile:
        for name, us, c in rows[:12]:
            print(f"train profile:   {us:10.1f} us  x{c:5.1f}  {name[:90]}")


# ---------------------------------------------------------------------
# PointPillars on data/kitti: the host pipeline, tools/train.py, eval
# ---------------------------------------------------------------------

def kitti_loader(training, batch_size, workers=4, cfg_path=CFG):
    """The port's (dataset, loader) on ``data/kitti`` with the
    ``DATA_CONFIG`` of ``cfg_path`` (``pointpillar.yaml``)."""
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.datasets import build_dataloader

    cfg = cfg_from_yaml_file(cfg_path)
    return build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, batch_size,
                            root_path=str(KITTI_DIR), training=training,
                            workers=workers)


def first_batches(loader, n, epoch=0):
    loader.set_epoch(epoch)
    out = []
    for b in loader:
        out.append(b)
        if len(out) == n:
            break
    return out


def check_loader(workers=4):
    """The port's loader against ``kitti_loader_jax_ref.npz`` (the JAX
    loader's first 8 train batches of epoch 0 at batch 4 and its first val
    batch at batch 8), bit for bit: points (sha256 of the bytes; the valid
    rows of the first batch of each split in full), points_mask, gt_boxes,
    image_shape, frame_id and the calibration matrices. Returns the
    counts."""
    import hashlib

    import numpy as np

    with np.load(LOADER_REF) as raw:
        ref = dict(raw)
    keys = ["batch_size", "calib", "frame_id", "gt_boxes", "image_shape",
            "points", "points_mask"]
    res = {}
    for tag, training, bs in (("train", True, 4), ("val", False, EVAL_BATCH)):
        n = int(ref[f"{tag}_batches"])
        _, loader = kitti_loader(training, bs, workers)
        got = first_batches(loader, n)
        loader.close()
        for i, b in enumerate(got):
            p = f"{tag}{i}_"
            where = f"pipeline: {tag} batch {i}"
            if sorted(b) != keys:
                fail(f"{where}: keys {sorted(b)}")
            pts = b["points"]
            if (pts.dtype != np.float32 or tuple(pts.shape) != tuple(
                    ref[p + "points_shape"]) or hashlib.sha256(
                    np.ascontiguousarray(pts).tobytes()).hexdigest()
                    != str(ref[p + "points_sha256"])):
                fail(f"{where}: points differ from the JAX loader's")
            if i == 0 and not np.array_equal(pts[b["points_mask"]],
                                             ref[p + "points_valid"]):
                fail(f"{where}: valid points differ")
            for k in ("points_mask", "gt_boxes", "image_shape"):
                if (b[k].dtype != ref[p + k].dtype
                        or not np.array_equal(b[k], ref[p + k])):
                    fail(f"{where}: {k} differs")
            if list(b["frame_id"]) != ref[p + "frame_id"].tolist():
                fail(f"{where}: frame ids {b['frame_id']}")
            for m in ("P2", "R0", "V2C"):
                if not np.array_equal(np.stack([getattr(c, m)
                                                for c in b["calib"]]),
                                      ref[p + f"calib_{m}"]):
                    fail(f"{where}: calib {m} differs")
        res[f"{tag}_batches"] = len(got)
    return res


def time_loader(training, batch_size, workers, epoch=0):
    """Host ms per batch over a whole epoch of the port's loader, after
    its first batch (which waits for the loader's process to start), and
    the seconds to that first batch. Returns (ms, batches, start s)."""
    _, loader = kitti_loader(training, batch_size, workers)
    loader.set_epoch(epoch)
    t0 = time.perf_counter()
    it = iter(loader)
    next(it)
    t1 = time.perf_counter()
    n = 1 + sum(1 for _ in it)
    ms = (time.perf_counter() - t1) * 1e3 / (n - 1)
    loader.close()
    return ms, n, t1 - t0


def phase_pipeline(report):
    """``pipeline / kitti``: the loader against the JAX loader's batches,
    then its host ms per batch over train epoch 0 (batch 4) with 1 and 4
    workers and over the val split (batch 8), and the seconds its process
    takes to give the first batch."""
    t0 = time.perf_counter()
    res = check_loader(workers=4)
    check_s = time.perf_counter() - t0
    for workers in (1, 4):
        ms, n, start_s = time_loader(True, 4, workers)
        res[f"train_ms_per_batch_w{workers}"] = ms
        res[f"train_first_batch_s_w{workers}"] = start_s
    res["train_batches_per_epoch"] = n
    (res["val_ms_per_batch_w4"], res["val_batches"],
     res["val_first_batch_s_w4"]) = time_loader(False, EVAL_BATCH, 4)
    report["pipeline_kitti"] = res
    print(f"pipeline / kitti: the port's loader equals the JAX loader's "
          f"batches bit for bit ({res['train_batches']} train batches of "
          f"epoch 0 at batch 4, 1 val batch at batch {EVAL_BATCH}; "
          f"{check_s:.1f} s); host ms per batch over train epoch 0 "
          f"({n} batches of 4, gt sampling, flip, rotation, scaling): "
          f"{res['train_ms_per_batch_w1']:.2f} (1 worker), "
          f"{res['train_ms_per_batch_w4']:.2f} (4 workers), after a first "
          f"batch in {res['train_first_batch_s_w4']:.2f} s (the loader's "
          f"process starting); val {res['val_ms_per_batch_w4']:.2f} ms per "
          f"batch of {EVAL_BATCH}", flush=True)


def reset_launches(kernels):
    for fn in kernels.values():
        fn.launches = 0


def read_launches(kernels):
    return {k: fn.launches for k, fn in kernels.items()}


def phase_train_kitti(report, kernels, cfg_path=CFG, tag="train / kitti",
                      key="train_kitti", per_step=(("canvas", 1),
                                                   ("canvas_grad", 1)),
                      eval_per_batch=(("canvas", 1),)):
    """``train / kitti``: ``tools/train.py``'s entry (its ``prepare``,
    ``train`` and ``evaluate``, as ``main`` runs them) with ``cfg_path``
    (``pointpillar.yaml``, bf16) as shipped at batch 4 for one epoch of
    ``data/kitti`` from the fresh init (``--fix_random_seed``), 4 loader
    workers: step ms, steps/s, frames/s, the share of the loop's wall time
    spent waiting on the loader; the loss finite and falling (mean of the
    last 10 steps below the first 10); exactly ``per_step`` launches a
    step (one canvas forward and one backward) and no other kernel; the
    checkpoint written; the post-training eval over the val split with
    ``eval_per_batch`` (one canvas) and one or two fused-NMS launches a
    batch; the anchors' val scores (:func:`anchor_scores`): with the
    batch's BatchNorm statistics the trained weights' foreground anchors'
    mean score over the background's must exceed the fresh init's (in
    eval mode the running statistics, moved 75 times at momentum 0.99,
    still hold 0.99^75 = 47 % of their initial zero mean and unit
    variance). Returns the checkpoint's path."""
    import copy
    import shutil

    import numpy as np
    import torch

    from de6d_tpu_torch.tools import train as train_cli

    extra = "chip_smoke"
    cfg_path = Path(cfg_path)
    shutil.rmtree(ROOT / "output/kitti_models" / cfg_path.stem / extra,
                  ignore_errors=True)
    argv = ["--cfg_file", str(cfg_path), "--epochs", "1", "--batch_size",
            "4", "--workers", "4", "--extra_tag", extra, "--fix_random_seed",
            "--set", "DATA_CONFIG.DATA_PATH", str(KITTI_DIR)]
    t0 = time.perf_counter()
    run = train_cli.prepare(argv)
    prep_s = time.perf_counter() - t0
    init_model = copy.deepcopy(run.model)
    reset_launches(kernels)
    t0 = time.perf_counter()
    train_cli.train(run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    steps = len(run.step_log)
    want = {k: steps * dict(per_step).get(k, 0) for k in kernels}
    if steps != len(run.train_loader) or launches != want:
        fail(f"{tag}: {steps} steps, launches {launches}, expected {want}")
    losses = np.array([float(x[2]) for x in run.step_log])
    if not np.isfinite(losses).all():
        fail(f"{tag}: non-finite losses {losses}")
    if not losses[-10:].mean() < losses[:10].mean():
        fail(f"{tag}: the loss did not fall: first 10 "
             f"{losses[:10].mean()}, last 10 {losses[-10:].mean()}")
    ckpt = run.ckpt_dir / "checkpoint_epoch_1"
    if not ckpt.is_file():
        fail(f"{tag}: no checkpoint at {ckpt}")
    data_s = np.array([x[0] for x in run.step_log])
    step_s = np.array([x[1] for x in run.step_log])
    iter_ms = (data_s + step_s) * 1e3
    reset_launches(kernels)
    t0 = time.perf_counter()
    ret, _ = train_cli.evaluate(run)
    eval_s = time.perf_counter() - t0
    eval_launches = read_launches(kernels)
    n_eval = -(-100 // 4)
    # the fused NMS runs on the 1024-candidate prefix, and again on all
    # 4096 where the prefix does not decide a batch (ops/nms.py cascade)
    want = {k: n_eval * dict(eval_per_batch).get(k, 0) for k in kernels}
    want["nms"] = eval_launches["nms"]
    if eval_launches != want or not n_eval <= want["nms"] <= 2 * n_eval:
        fail(f"{tag}: post-training eval launches {eval_launches} in "
             f"{n_eval} batches, expected {dict(eval_per_batch)} and 1-2 "
             "NMS a batch")
    if not (run.output_dir / "eval/eval_with_train/result.pkl").is_file():
        fail(f"{tag}: the post-training eval wrote no result.pkl")
    scores = anchor_scores({"init": init_model, "trained": run.model},
                           cfg_path)
    del init_model
    sep = {k: r["fg_mean"] / r["bg_mean"] for k, r in scores.items()}
    if not sep["trained_batch_stats"] > sep["init"]:
        fail(f"{tag}: the foreground anchors' val scores did not rise over "
             f"the background's: {scores}")
    out = {
        "steps": steps, "batch": 4,
        "compute_dtype": run.cfg.MODEL.get("COMPUTE_DTYPE", "float32"),
        "prepare_s": prep_s, "wall_s": wall,
        "median_step_ms": float(np.median(iter_ms)),
        "step_ms_iqr": [float(x) for x in np.percentile(iter_ms, [25, 75])],
        "median_host_step_ms": float(np.median(step_s) * 1e3),
        "median_loader_wait_ms": float(np.median(data_s) * 1e3),
        "loader_wait_share": float(data_s.sum() / (data_s + step_s).sum()),
        "steps_per_s": steps / wall, "frames_per_s": 4 * steps / wall,
        "first10_loss": float(losses[:10].mean()),
        "last10_loss": float(losses[-10:].mean()),
        "launches": launches, "eval_launches": eval_launches,
        "eval_s": eval_s,
        "eval_recall": {k: ret[k] for k in ret if k.startswith("recall/")},
        "val_anchor_scores": scores, "fg_over_bg": sep,
        "checkpoint": str(ckpt),
    }
    report[key] = out
    print(f"{tag}: tools/train.py, {cfg_path.name} "
          f"{out['compute_dtype']}, batch 4, "
          f"1 epoch of data/kitti ({steps} steps) from the fresh init: "
          f"median step {out['median_step_ms']:.2f} ms (IQR "
          f"{out['step_ms_iqr'][0]:.2f}-{out['step_ms_iqr'][1]:.2f}; host "
          f"step {out['median_host_step_ms']:.2f}, loader wait "
          f"{out['median_loader_wait_ms']:.2f}), "
          f"{out['steps_per_s']:.2f} steps/s, {out['frames_per_s']:.2f} "
          f"frames/s, loader wait {out['loader_wait_share']:.1%} of the "
          f"loop; loss first 10 {out['first10_loss']:.4f} -> last 10 "
          f"{out['last10_loss']:.4f}; launches {launches}; checkpoint "
          f"{out['checkpoint']}; post-training eval {eval_s:.1f} s, "
          f"launches {eval_launches}, recall {out['eval_recall']} "
          f"(prepare {prep_s:.1f} s); val anchor scores, fresh init / "
          f"trained with the running BatchNorm statistics / trained with "
          f"the batch's: foreground mean over background mean "
          f"{sep['init']:.4g} / {sep['trained']:.4g} / "
          f"{sep['trained_batch_stats']:.4g}, largest "
          f"{scores['init']['max']:.4g} / {scores['trained']['max']:.4g} / "
          f"{scores['trained_batch_stats']['max']:.4g}, anchors at or "
          f"above SCORE_THRESH {scores['init']['thresh']} "
          f"{scores['init']['above_thresh']} / "
          f"{scores['trained']['above_thresh']} / "
          f"{scores['trained_batch_stats']['above_thresh']}", flush=True)
    return ckpt


def anchor_scores(models, cfg_path=CFG):
    """{name: the anchors' class scores over the val split of
    ``cfg_path``} for each of ``models`` (anchor-head detectors on the
    card) in eval mode, and for ``models["trained"]`` again with every
    BatchNorm normalising by the batch's statistics (on a copy, as
    ``trained_batch_stats``): the largest score, the mean score of the
    anchors the target assigner labels foreground (of their class) and
    the mean largest score of those it labels background, the foreground
    anchors' count, and the anchors at or above
    ``POST_PROCESSING.SCORE_THRESH``."""
    import copy

    import torch

    from de6d_tpu_torch.models.dense_heads.axis_aligned_assigner import (
        assign_targets,
    )
    from de6d_tpu_torch.models.model_utils.layers import BatchNorm
    from de6d_tpu_torch.train.train_loop import device_batch

    _, loader = kitti_loader(False, EVAL_BATCH, 4, cfg_path)
    loader.set_epoch(0)
    batches = [device_batch(b, torch.device("cuda")) for b in loader]
    loader.close()
    runs = dict(models)
    runs["trained_batch_stats"] = copy.deepcopy(models["trained"])
    out = {}
    for name, model in runs.items():
        model.eval()
        if name == "trained_batch_stats":
            for m in model.modules():
                if isinstance(m, BatchNorm):
                    m.train()
        head = model.dense_head
        thresh = float(model.model_cfg["POST_PROCESSING"]["SCORE_THRESH"])
        top = fg_sum = bg_sum = 0.0
        fg_n = bg_n = above = 0
        for batch in batches:
            with torch.no_grad():
                res = model(dict(batch))
                s = torch.sigmoid(res["batch_cls_preds"].float())
                lab = assign_targets(
                    head.anchors, head.anchor_group, head.matched_thr,
                    head.unmatched_thr, batch["gt_boxes"],
                    head.box_coder)["box_cls_labels"].long()
            best = s.amax(-1)
            fg, bg = lab > 0, lab == 0
            own = torch.gather(s, 2, (lab.clamp(min=1) - 1)[..., None])[..., 0]
            top = max(top, float(best.max()))
            fg_sum += float(own[fg].sum())
            fg_n += int(fg.sum())
            bg_sum += float(best[bg].sum())
            bg_n += int(bg.sum())
            above += int((best >= thresh).sum())
        out[name] = {"max": top, "fg_mean": fg_sum / max(fg_n, 1),
                     "bg_mean": bg_sum / max(bg_n, 1), "fg_anchors": fg_n,
                     "above_thresh": above, "thresh": thresh}
    return out


def eval_annos_from_arrays(ref, cfg_path=CFG):
    """The fixture's per-frame detections as KITTI annos, built by the
    port's ``generate_prediction_dicts`` with each val frame's
    calibration."""
    import numpy as np

    ds, loader = kitti_loader(False, EVAL_BATCH, 4, cfg_path)
    starts = np.concatenate([[0], np.cumsum(ref["count"])])
    annos, i = [], 0
    loader.set_epoch(0)
    for batch in loader:
        preds = []
        for _ in range(batch["batch_size"]):
            s, e = starts[i], starts[i + 1]
            preds.append({"pred_boxes": ref["boxes"][s:e],
                          "pred_scores": ref["scores"][s:e],
                          "pred_labels": ref["labels"][s:e].astype(np.int32)})
            i += 1
        annos.extend(ds.generate_prediction_dicts(batch, preds,
                                                  ds.class_names))
    return ds, annos


def check_eval_code(ref_path=EVAL_REF, cfg_path=CFG, tag="eval / kitti"):
    """The port's KITTI eval on the JAX run's own detections (the eval
    fixture) must give the stored AP dict exactly."""
    import numpy as np

    with np.load(ref_path) as raw:
        ref = dict(raw)
    ds, annos = eval_annos_from_arrays(ref, cfg_path)
    _, ap = ds.evaluation(annos, ds.class_names)
    keys = ref["ap_keys"].tolist()
    got = np.array([float(ap[k]) for k in keys])
    if sorted(ap) != sorted(keys):
        fail(f"{tag}: AP keys {sorted(ap)}")
    if not np.array_equal(got, ref["ap_values"]):
        bad = [k for k, a, b in zip(keys, got, ref["ap_values"]) if a != b]
        fail(f"{tag}: the port's KITTI eval on the JAX detections "
             f"differs at {bad}")
    from de6d_tpu_torch.native import native_eval

    return {"ap_equal": True, "native_matcher": native_eval.available()}


def _best_iou(gt, boxes):
    """Each valid gt box's best 3D IoU with ``boxes`` (CPU, fp32)."""
    import numpy as np
    import torch

    from de6d_tpu_torch.ops import iou3d

    if len(boxes) == 0 or len(gt) == 0:
        return np.zeros(len(gt))
    iou = iou3d.boxes_iou3d(torch.from_numpy(np.ascontiguousarray(
        gt, np.float32)), torch.from_numpy(np.ascontiguousarray(
            boxes, np.float32)))
    return iou.amax(dim=1).numpy()


def check_eval_parity(ret, annos, tol=PARITY_TOL, ref_path=None,
                      cfg_path=CFG, tag="eval / kitti"):
    """The port's eval (fp32) against ``ref_path`` (:data:`EVAL_REF`,
    ``pointpillar_eval_jax_ref.npz``; the val split read with the
    ``DATA_CONFIG`` of ``cfg_path``):
    frame ids, per-frame counts and labels equal, boxes and scores within
    ``tol``; each recall counter equal, or parted only at ground-truth
    boxes whose best 3D IoU lies within :data:`PARTING_IOU` of the
    threshold in both runs (certified); the AP dict: the AOS entries
    within ``50 * max |d yaw|`` (AOS averages ``(1 + cos d)/2`` over the
    matches, in percent: continuous in the yaw), every other entry equal,
    or a difference explained by the detections at a threshold
    (:func:`certify_ap`). Returns the report."""
    import numpy as np

    with np.load(ref_path or EVAL_REF) as raw:
        ref = dict(raw)
    names = ["Car", "Pedestrian", "Cyclist"]
    got = {
        "frame_id": np.array([a["frame_id"] for a in annos]),
        "count": np.array([len(a["score"]) for a in annos]),
        "boxes": np.concatenate([np.asarray(a["boxes_lidar"], np.float32)
                                 .reshape(-1, 7) for a in annos]),
        "scores": np.concatenate([np.asarray(a["score"], np.float32)
                                  for a in annos]),
        "labels": np.concatenate([np.array([names.index(n) + 1
                                            for n in a["name"]], np.int64)
                                  for a in annos]),
    }
    if got["frame_id"].tolist() != ref["frame_id"].tolist():
        fail(f"{tag}: frame order differs")
    if not np.array_equal(got["count"], ref["count"]):
        bad = np.nonzero(got["count"] != ref["count"])[0]
        fail(f"{tag}: counts differ at frames {bad.tolist()}: "
             f"{got['count'][bad]} vs {ref['count'][bad]}")
    if not np.array_equal(got["labels"], ref["labels"]):
        fail(f"{tag}: labels differ")
    d_box = float(np.abs(got["boxes"] - ref["boxes"]).max(initial=0))
    d_score = float(np.abs(got["scores"] - ref["scores"]).max(initial=0))
    if max(d_box, d_score) > tol:
        fail(f"{tag}: max |d box| {d_box}, |d score| {d_score} > "
             f"{tol}")
    # recall counters
    counts = dict(zip(ref["recall_keys"].tolist(),
                      ref["recall_counts"].tolist()))
    partings = []
    gt_by_frame = None
    if ret["recall_counts"] != counts:
        if ret["recall_counts"].get("gt") != counts["gt"]:
            fail(f"{tag}: {ret['recall_counts']['gt']} gt boxes, "
                 f"reference {counts['gt']}")
        gt_by_frame = eval_gt_boxes(cfg_path)
        starts = np.concatenate([[0], np.cumsum(ref["count"])])
        for k, want in counts.items():
            if k == "gt" or ret["recall_counts"][k] == want:
                continue
            t = float(k.split("_")[1])
            for f, gt in enumerate(gt_by_frame):
                s, e = starts[f], starts[f + 1]
                bg = _best_iou(gt, got["boxes"][s:e])
                br = _best_iou(gt, ref["boxes"][s:e])
                for j in np.nonzero((bg > t) != (br > t))[0]:
                    if max(abs(bg[j] - t), abs(br[j] - t)) > PARTING_IOU:
                        fail(f"{tag}: {k} parts at frame {f} gt {j} "
                             f"(best IoU {bg[j]} vs {br[j]}), not within "
                             f"{PARTING_IOU} of {t}")
                    partings.append((k, f, int(j), float(bg[j]),
                                     float(br[j])))
            net = sum(1 if p[3] > t else -1 for p in partings if p[0] == k)
            if ret["recall_counts"][k] - want != net:
                fail(f"{tag}: {k} {ret['recall_counts'][k]} vs {want}"
                     f" not explained by the certified partings")
    # AP
    keys = ref["ap_keys"].tolist()
    ap = np.array([float(ret[k]) for k in keys])
    d_yaw = float(np.abs(got["boxes"][:, 6] - ref["boxes"][:, 6]).max(
        initial=0))
    aos_tol = 50 * d_yaw
    d_aos = max((abs(a - b) for k, a, b in zip(keys, ap, ref["ap_values"])
                 if "_aos/" in k), default=0.0)
    if d_aos > aos_tol:
        fail(f"{tag}: AOS differs by {d_aos} > {aos_tol}")
    ap_diff = [k for k, a, b in zip(keys, ap, ref["ap_values"])
               if a != b and "_aos/" not in k]
    certified_ap = []
    if ap_diff:
        certified_ap = certify_ap(got, ref, ap_diff, cfg_path, tag)
    return {"counts": int(got["count"].sum()), "max_abs_box": d_box,
            "max_abs_score": d_score, "recall_partings": partings,
            "max_abs_aos": d_aos, "aos_tol": aos_tol,
            "ap_differs_at": ap_diff, "ap_certified_by": certified_ap}


def eval_gt_boxes(cfg_path=CFG):
    """Each val frame's gt boxes (valid rows) as the eval batches carry
    them."""
    import numpy as np

    _, loader = kitti_loader(False, EVAL_BATCH, 4, cfg_path)
    out = []
    loader.set_epoch(0)
    for b in loader:
        for g in b["gt_boxes"]:
            out.append(g[np.any(np.abs(g[:, :7]) > 0, axis=-1), :7])
    return out


def certify_ap(got, ref, ap_diff, cfg_path=CFG, tag="eval / kitti"):
    """Replace the port's detections that lie at a threshold by the
    reference's: a 3D or BEV IoU with a gt box within :data:`PARTING_IOU`
    of 0.25, 0.5 or 0.7 in either run, or a score whose order against
    another detection's differs between the runs. The AP of the result
    must equal the reference AP (AOS aside). Returns the replaced
    detections' indices."""
    import numpy as np
    import torch

    from de6d_tpu_torch.ops import iou3d

    gt_by_frame = eval_gt_boxes(cfg_path)
    starts = np.concatenate([[0], np.cumsum(ref["count"])])
    near = np.zeros(len(ref["scores"]), bool)
    for f, gt in enumerate(gt_by_frame):
        s, e = starts[f], starts[f + 1]
        if e == s or len(gt) == 0:
            continue
        g = torch.from_numpy(np.ascontiguousarray(gt, np.float32))
        for boxes in (got["boxes"][s:e], ref["boxes"][s:e]):
            a = torch.from_numpy(np.ascontiguousarray(boxes, np.float32))
            for iou in (iou3d.boxes_iou3d(a, g), iou3d.boxes_iou_bev(a, g)):
                iou = iou.numpy()
                for t in (0.25, 0.5, 0.7):
                    near[s:e] |= (np.abs(iou - t) <= PARTING_IOU).any(1)
    flips = (np.sign(got["scores"][:, None] - got["scores"][None])
             != np.sign(ref["scores"][:, None] - ref["scores"][None]))
    near |= flips.any(1)
    hybrid = {k: v.copy() for k, v in got.items()}
    hybrid["boxes"][near] = ref["boxes"][near]
    hybrid["scores"][near] = ref["scores"][near]
    ds, annos = eval_annos_from_arrays(hybrid, cfg_path)
    _, ap = ds.evaluation(annos, ds.class_names)
    keys = [k for k in ref["ap_keys"].tolist() if "_aos/" not in k]
    want = dict(zip(ref["ap_keys"].tolist(), ref["ap_values"].tolist()))
    if any(float(ap[k]) != want[k] for k in keys):
        fail(f"{tag}: AP differs at {ap_diff}, not explained by the "
             f"{int(near.sum())} detections at a threshold")
    return np.nonzero(near)[0].tolist()


def phase_eval_kitti(report, kernels, ckpt, cfg_path=CFG, params=PARAMS,
                     ref_path=EVAL_REF, tag="eval / kitti", key="eval_kitti",
                     per_batch=(("canvas", 1),), nms_per_batch=(1, 1)):
    """``eval / kitti``: the port's KITTI eval on the JAX detections;
    ``eval_one_epoch`` of ``cfg_path`` (PointPillars) with the trained
    ``params`` over the 100 val frames at batch 8: fp32 (TF32 off) against
    ``ref_path`` (``pointpillar_eval_jax_ref.npz``,
    :func:`check_eval_parity`), recall above 0; bf16 ms per frame with
    ``per_batch`` launches (one canvas) and ``nms_per_batch`` fused-NMS
    launches a batch (one); then ``tools/test.py --ckpt`` on ``train /
    kitti``'s checkpoint."""
    import torch

    from de6d_tpu_torch.tools import test as test_cli
    from de6d_tpu_torch.train.eval_utils import eval_one_epoch

    code = check_eval_code(ref_path, cfg_path, tag)
    ds, loader = kitti_loader(False, EVAL_BATCH, 4, cfg_path)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, mc, _ = build_model("float32", "cuda", cfg_path, params)
    ret32, annos = eval_one_epoch(model, loader, ds, mc, ds.class_names)
    parity = check_eval_parity(ret32, annos, ref_path=ref_path,
                               cfg_path=cfg_path, tag=tag)
    if not ret32["recall/recalled_0.3"] > 0:
        fail(f"{tag}: recall {ret32['recall_counts']}")
    del model
    model, mc, _ = build_model("bfloat16", "cuda", cfg_path, params)
    eval_one_epoch(model, loader, ds, mc, ds.class_names)  # warm
    reset_launches(kernels)
    t0 = time.perf_counter()
    ret16, _ = eval_one_epoch(model, loader, ds, mc, ds.class_names)
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    n = len(loader)
    loader.close()
    want = {k: n * dict(per_batch).get(k, 0) for k in kernels}
    want["nms"] = launches["nms"]
    lo, hi = nms_per_batch
    if launches != want or not lo * n <= launches["nms"] <= hi * n:
        fail(f"{tag}: launches {launches} in {n} batches, expected "
             f"{dict(per_batch)} and {lo}-{hi} fused NMS a batch")
    del model
    argv = ["--cfg_file", str(cfg_path), "--ckpt", str(ckpt), "--extra_tag",
            "chip_smoke", "--batch_size", str(EVAL_BATCH), "--workers", "4",
            "--allow-zero-recall", "--set", "DATA_CONFIG.DATA_PATH",
            str(KITTI_DIR)]
    t0 = time.perf_counter()
    ret_cli = test_cli.main(argv)
    cli_s = time.perf_counter() - t0
    out_dir = (ROOT / "output/kitti_models" / Path(cfg_path).stem
               / "chip_smoke/eval/single")
    if not (out_dir / "result.pkl").is_file():
        fail(f"{tag}: tools/test.py wrote no result.pkl")

    def ap_line(r):
        return {c: (round(r[f"{c}_3d/moderate"], 4),
                    round(r[f"{c}_3d/moderate_R40"], 4))
                for c in ("Car", "Pedestrian", "Cyclist")}

    out = {
        "eval_code": code, "parity": parity,
        "fp32": {k: v for k, v in ret32.items()},
        "bf16": {k: v for k, v in ret16.items()},
        "bf16_ms_per_frame": ret16["sec_per_example"] * 1e3,
        "bf16_steady_ms_per_frame": (ret16["steady_sec_per_example"] or 0)
        * 1e3,
        "bf16_wall_s": wall, "batches": n, "launches": launches,
        "test_cli_s": cli_s,
        "test_cli": {k: v for k, v in ret_cli.items()},
    }
    report[key] = out
    print(f"{tag}: the port's KITTI eval on the JAX run's detections "
          f"gives its AP dict exactly (native matcher: "
          f"{code['native_matcher']}); fp32 (TF32 off) eval_one_epoch of "
          f"the trained weights over the 100 val frames at batch "
          f"{EVAL_BATCH} matches {Path(ref_path).name}: "
          f"{parity['counts']} detections, max |d box| "
          f"{parity['max_abs_box']:.3g}, |d score| "
          f"{parity['max_abs_score']:.3g} (tol {PARITY_TOL}), recall "
          f"partings {parity['recall_partings']}, AP differs at "
          f"{parity['ap_differs_at']}; recall {ret32['recall_counts']}; "
          f"3D AP (R11, R40) moderate {ap_line(ret32)}; bf16 "
          f"{out['bf16_ms_per_frame']:.3f} ms per frame over the epoch "
          f"(steady p50 {out['bf16_steady_ms_per_frame']:.3f}), launches "
          f"{launches} in {n} batches; tools/test.py --ckpt on the "
          f"train checkpoint ran in {cli_s:.1f} s, recall "
          f"{ret_cli['recall_counts']}", flush=True)


# ---------------------------------------------------------------------
# Det6D: FPS kernel, serve, parity
# ---------------------------------------------------------------------

def fps_weights(scores, gamma):
    """s-fps weights from confidence logits, as ``run_sampling`` makes
    them."""
    import torch

    return torch.sigmoid(scores) ** gamma


def argmax_round_ms():
    """The time of one empty block-wide argmax round of the first,
    single-block FPS kernel (8 blocks, as a batch of 8 samples runs)."""
    from de6d_tpu_torch.ops.kernels import fps as fk

    rounds = 4096
    return time_ms(lambda: fk.argmax_rounds(rounds, 8, "cuda"), 10) / rounds


_ROUND_MS = {}  # (samples, cluster size, threads) -> ms per empty round


def rounds_floor_ms(b, cluster, threads):
    """The time of one empty pick round (warp reduce, the CTA's
    __syncthreads and, for a cluster, the DSMEM messages of
    ``csrc/cluster_argmax.cuh``) for ``b`` clusters of ``cluster`` CTAs of
    ``threads`` threads: the latency floor per pick of an FPS or f-fps
    variant of that shape."""
    from de6d_tpu_torch.ops.kernels import fps as fk

    key = (b, cluster, threads)
    if key not in _ROUND_MS:
        rounds = 2048
        _ROUND_MS[key] = time_ms(lambda: fk.cluster_rounds(
            rounds, b, cluster, threads, "cuda"), 5) / rounds
    return _ROUND_MS[key]


def cluster_round_ms(b, n, cluster):
    """The latency floor per pick of the FPS variant with ``cluster``
    CTAs per sample for ``b`` samples of ``n`` points."""
    from de6d_tpu_torch.ops.kernels import fps as fk

    return rounds_floor_ms(b, cluster, fk.threads(n, cluster))


def fps_variants_equal(label, xyz, valid, npoint, w, ref):
    """Every cluster size the kernel takes for this N must give the plain
    loop's picks."""
    import torch

    from de6d_tpu_torch.ops.kernels import fps as fk

    for c in fk.cluster_sizes(valid.shape[1]):
        got = fk.fps_cluster(xyz, valid, npoint, w, cluster=c)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = (got != ref).nonzero()[0].tolist()
            fail(f"kernels / fps {label}: cluster {c} picks differ from the "
                 f"plain version, first at (sample, pick) {bad}")


def check_fps(cases, report, variant_ms=()):
    """cases: {label: (xyz (B, N, 3), valid (B, N), npoint, weights or
    None)}; the kernel's picks, at the dispatched cluster size and at
    every other one, must equal the plain loop's. Times the kernel, the
    plain loop and its latency floor: npoint empty pick rounds of the
    dispatched variant (``cluster_rounds``), beside the first kernel's
    single-block floor (``argmax_rounds``). Cases in ``variant_ms`` also
    time every cluster size."""
    import torch

    from de6d_tpu_torch.ops.kernels import fps as fk

    round_ms = argmax_round_ms()
    lines = {}
    for label, (xyz, valid, npoint, w) in cases.items():
        got = fk.fps(xyz, valid, npoint, weights=w)
        ref = fk.fps_plain(xyz, valid, npoint, w)
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            bad = (got != ref).nonzero()[0].tolist()
            fail(f"kernels / fps {label}: picks differ from the plain "
                 f"version, first at (sample, pick) {bad}")
        fps_variants_equal(label, xyz, valid, npoint, w, ref)
        b, n = valid.shape
        weighted = w is not None
        cluster = fk.dispatch(b, n, weighted)
        flops = b * n * (npoint - 1) * fk.FLOPS_PER_POINT[weighted]
        nbytes = b * n * (12 + 1 + 4 * weighted) + b * npoint * 4
        t_ops, t_bytes = flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
        rounds = npoint - 1 + weighted
        lines[label] = {
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: fk.fps(xyz, valid, npoint, weights=w), 5),
            "plain_ms": time_ms(lambda: fk.fps_plain(xyz, valid, npoint, w),
                                1, warmup=0),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "cluster": cluster,
            "threads": fk.threads(n, cluster),
            "latency_floor_ms": rounds * cluster_round_ms(b, n, cluster),
            "latency_floor_single_block_ms": rounds * round_ms,
            "shape": f"{'s' if weighted else 'd'}-fps ({b}, {n}) -> {npoint}"
                     f", {int(valid.sum())} valid",
        }
        ln = lines[label]
        if label in variant_ms:
            ln["variant_ms"] = {
                c: time_ms(lambda: fk.fps_cluster(
                    xyz, valid, npoint, w, cluster=c), 5)
                for c in fk.cluster_sizes(n)}
            ln["variant_latency_floor_ms"] = {
                c: rounds * cluster_round_ms(b, n, c)
                for c in fk.cluster_sizes(n)}
        print(f"kernels / fps {label}: identical picks (every cluster "
              f"size), {ln['shape']}: cluster {cluster} x {ln['threads']} "
              f"threads {ln['ms']:.4f} ms, plain {ln['plain_ms']:.1f} ms, "
              f"bound {ln['bound_ms']:.5f} ms ({ln['bound_by']}), latency "
              f"floor {ln['latency_floor_ms']:.4f} ms (single block "
              f"{ln['latency_floor_single_block_ms']:.4f})"
              + (f", by cluster size {ln['variant_ms']}"
                 if "variant_ms" in ln else ""), flush=True)
    report["fps_round_ms"] = round_ms
    return lines


def check_fps_edges():
    """Picks identical to the plain loop at every cluster size on the
    edge cases: N = 1, 1023, 1024, 1025, 4096, 16384 with npoint up to N,
    an all-invalid sample, fewer valid points than picks, an exact-tie
    lattice (every distance an integer), d-fps and s-fps."""
    import numpy as np
    import torch

    from de6d_tpu_torch.ops.kernels import fps as fk

    rng = np.random.RandomState(21)
    n_cases = 0
    for n, npoints in ((1, (1, 3)), (1023, (1023, 100)), (1024, (1024,)),
                       (1025, (1025, 513)), (4096, (4096, 1000)),
                       (16384, (16384, 4096))):
        xyz = rng.uniform(-40, 70, (4, n, 3)).astype(np.float32)
        side = int(round(n ** (1 / 3))) + 1  # lattice: exact ties
        g = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)[:n]
        xyz[3] = g.astype(np.float32)
        valid = np.ones((4, n), bool)
        valid[1] = False  # all invalid
        valid[2, max(1, n // 3):] = False  # fewer valid than picks
        xyz_t = torch.from_numpy(xyz).cuda()
        valid_t = torch.from_numpy(valid).cuda()
        w = torch.from_numpy(np.floor(rng.uniform(0, 4, (4, n))).astype(
            np.float32)).cuda()  # integer weights: tied keys
        for npoint in npoints:
            for weights in (None, w):
                ref = fk.fps_plain(xyz_t, valid_t, npoint, weights)
                got = fk.fps_cluster(xyz_t, valid_t, npoint, weights,
                                     cluster=fk.dispatch(4, n,
                                                         weights is not None))
                if not torch.equal(got, ref):
                    fail(f"kernels / fps edges N={n} npoint={npoint}: "
                         "dispatched picks differ from the plain version")
                fps_variants_equal(f"edges N={n} npoint={npoint}", xyz_t,
                                   valid_t, npoint, weights, ref)
                if not bool((ref[1] == 0).all()):
                    fail(f"kernels / fps edges N={n}: an all-invalid sample "
                         "must pick index 0 throughout")
                n_cases += 1
    print(f"kernels / fps edges: {n_cases} cases identical to the plain "
          "loop at every cluster size (N = 1 ... 16384, npoint up to N, "
          "all-invalid, ragged, exact-tie lattice)", flush=True)
    return n_cases


def phase_det6d_kernels(report):
    """FPS at the served Det6D model's shapes and inputs, and NMS at its
    candidate shape."""
    import numpy as np
    import torch

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        select_candidates,
    )
    from de6d_tpu_torch.ops.nms import NEG_INF

    model, mc, _ = build_model("bfloat16", "cuda", DET6D_CFG, DET6D_PARAMS)
    gamma = float(mc["BACKBONE_3D"]["SA_CONFIG"].get("WEIGHT_GAMMA", 1.0))
    pts, mask = load_det6d_scans()
    points = torch.from_numpy(pts).cuda()
    valid = torch.from_numpy(mask).cuda()
    with torch.no_grad():
        out = model({"points": points, "points_mask": valid})
    xyz_l, valid_l = out["point_coords_list"], out["point_valid_list"]
    scores_l = out["point_scores_list"]
    rng = np.random.RandomState(0)
    syn_xyz = torch.from_numpy(rng.uniform(-40, 70, (8, 16384, 3)).astype(
        np.float32)).cuda()
    syn_w = torch.from_numpy(rng.random_sample((8, 16384)).astype(
        np.float32)).cuda()
    cases = {
        "sa1_dfps": (points[..., :3].contiguous(), valid, 4096, None),
        "sa2_sfps": (xyz_l[0], valid_l[0], 1024,
                     fps_weights(scores_l[0], gamma)),
        "sa3_sfps": (xyz_l[1], valid_l[1], 512,
                     fps_weights(scores_l[1], gamma)),
        "synthetic_sfps_all_valid": (
            syn_xyz, torch.ones(8, 16384, dtype=torch.bool, device="cuda"),
            4096, syn_w),
        "synthetic_dfps_ragged": (
            syn_xyz[:3, :1000], torch.arange(1000, device="cuda")[None]
            < torch.tensor([[1000], [700], [0]], device="cuda"), 333, None),
    }
    lines = check_fps(cases, report, variant_ms=("sa1_dfps", "sa2_sfps"))
    path = [lines[k] for k in ("sa1_dfps", "sa2_sfps", "sa3_sfps")]
    report["fps"] = {
        "name": "fps",
        "route": "cuda",
        "source": "de6d_tpu_torch/csrc/fps.cu",
        "replaces": "de6d_tpu/ops/pallas/fps.py:136",
        "max_abs_err": 0.0,
        # per served batch: the SA1 + SA2 + SA3 launches
        **{k: sum(ln[k] for ln in path) for k in (
            "ms", "plain_ms", "bound_ms", "latency_floor_ms",
            "latency_floor_single_block_ms")},
        "bound_by": "operations",
        "library_ms": None,
        "cases": lines,
        "edge_cases": check_fps_edges(),
    }

    post_cfg = mc["POST_PROCESSING"]
    nms_cfg = post_cfg["NMS_CONFIG"]
    boxes, scores, _ = select_candidates(out, post_cfg)
    counts = (scores > NEG_INF / 2).sum(-1).to(torch.int32)
    lines = check_nms({"det6d": (boxes.contiguous(), counts)},
                      float(nms_cfg["NMS_THRESH"]),
                      min(int(nms_cfg["NMS_POST_MAXSIZE"]), boxes.shape[1]))
    report["nms"]["cases"].update(lines)
    return model, mc


def absolute_picks(picks):
    """Per-layer picks (indices into the previous layer's points) → the
    same picks as indices into the input scan."""
    import numpy as np

    out, prev = [], None
    for p in picks:
        p = np.asarray(p, np.int64)
        prev = p if prev is None else np.take_along_axis(prev, p, axis=1)
        out.append(prev)
    return out


def sfps_parting(xyz, valid, w_port, w_ref, prefix, p, r):
    """One sample's s-fps step after the picks ``prefix``: the port's keys
    ``min_dist * max(w, 1e-12)`` of its own pick ``p`` and of the
    reference's pick ``r`` → (relative key gap, the gap that the relative
    differences between the port's and the reference's weights of the two
    points explain, plus 1e-6)."""
    import torch

    from de6d_tpu_torch.ops.kernels.fps import INF

    md = torch.full_like(w_port, INF)
    for last in prefix:
        dx, dy, dz = (xyz - xyz[last]).unbind(-1)
        md = torch.minimum(md, (dx * dx + dy * dy) + dz * dz)
    md = torch.where(valid, md, -1.0)
    key = torch.where(md >= 0, md * torch.clamp(w_port, min=1e-12), md)
    gap = float((key[p] - key[r]) / key[p])
    rel = (w_port / w_ref - 1).abs()
    return gap, float(rel[p] + rel[r]) + 1e-6


def check_det6d_parity(out, post, ref, gamma=1.0, tol=PARITY_TOL):
    """Det6D against the JAX reference ``ref`` (the fixture's arrays).

    1. Every port pick is the argmax of its own step key: each layer's
       picks equal the plain loop replayed on the port's own inputs.
    2. Picks, as indices into the scan: SA1 (d-fps, no learned input)
       must be identical. An s-fps layer may part from the reference
       only at a near-tie: at a sample's first differing pick, the port's
       key of its own pick exceeds its key of the reference's pick by no
       more than the relative differences between the two weights on
       either side (fp32 sums in another order move the confidence
       scores by ulps) plus 1e-6; the report names layer and pick.
    3. Counts and labels equal, boxes (9 columns) and scores within
       ``tol``, whether or not the picks parted.
    Returns a report; raises RuntimeError where a check fails."""
    import numpy as np
    import torch

    from de6d_tpu_torch.ops.kernels.fps import fps_plain

    picks = [p.cpu().numpy() for p in out["point_sample_idx_list"]]
    inputs = [(out["points"][..., :3].float(), out["points_mask"], None)]
    for k in range(1, len(picks)):
        inputs.append((out["point_coords_list"][k - 1],
                       out["point_valid_list"][k - 1],
                       fps_weights(out["point_scores_list"][k - 1], gamma)))
    for k, (xyz, valid, w) in enumerate(inputs):
        replay = fps_plain(xyz, valid, picks[k].shape[1], w).cpu().numpy()
        if not np.array_equal(replay, picks[k]):
            raise RuntimeError(f"parity / det6d: SA{k + 1} picks are not "
                               "the argmax of their own step keys")
    ref_picks = [ref[f"picks_{k}"] for k in range(len(picks))]
    got_abs, ref_abs = absolute_picks(picks), absolute_picks(ref_picks)
    n_diff = [int((g != r).sum()) for g, r in zip(got_abs, ref_abs)]
    partings = []
    for b in range(picks[0].shape[0]):
        first = next(((k, int(np.argmax(g[b] != r[b])))
                      for k, (g, r) in enumerate(zip(got_abs, ref_abs))
                      if (g[b] != r[b]).any()), None)
        if first is None:
            continue
        k, j = first
        if inputs[k][2] is None:
            raise RuntimeError(f"parity / det6d: SA{k + 1} (d-fps) picks "
                               f"differ from the reference at sample {b}, "
                               f"pick {j}")
        # layers before k agree, so the port's and the reference's layer-k
        # inputs are the same points in the same order
        xyz, valid, w_port = (t[b] for t in inputs[k])
        w_ref = fps_weights(torch.as_tensor(ref[f"scores_{k - 1}"][b],
                                            device=xyz.device), gamma)
        p, r = int(picks[k][b][j]), int(ref_picks[k][b][j])
        gap, explained = sfps_parting(xyz, valid, w_port, w_ref,
                                      picks[k][b][:j].tolist(), p, r)
        partings.append({"sample": b, "layer": f"SA{k + 1}", "pick": j,
                         "port": p, "ref": r, "key_gap": gap,
                         "weight_diff": explained - 1e-6})
        print(f"parity / det6d: sample {b} parts from the reference at "
              f"SA{k + 1} pick {j} (port row {p}, reference row {r}); "
              f"relative key gap {gap:.3g} vs weight differences "
              f"{explained - 1e-6:.3g}", flush=True)
        if not 0.0 <= gap <= explained:
            raise RuntimeError(
                f"parity / det6d: SA{k + 1} pick {j} of sample {b} is not a "
                f"near-tie (key gap {gap:.3g} > {explained:.3g})")

    got = {k: v.cpu().numpy() for k, v in post.items()}
    if not np.array_equal(got["pred_count"], ref["pred_count"]):
        raise RuntimeError(f"parity / det6d: counts {got['pred_count']} vs "
                           f"{ref['pred_count']}")
    if got["pred_boxes"].shape[-1] != 9:
        raise RuntimeError("parity / det6d: boxes are not 9-DoF")
    diffs = {"pred_boxes": 0.0, "pred_scores": 0.0}
    for b, c in enumerate(ref["pred_count"].tolist()):
        if not np.array_equal(got["pred_labels"][b, :c],
                              ref["pred_labels"][b, :c]):
            raise RuntimeError(f"parity / det6d: labels of scan {b} differ")
        for k in diffs:
            d = float(np.abs(got[k][b, :c] - ref[k][b, :c]).max(initial=0))
            diffs[k] = max(diffs[k], d)
    if max(diffs.values()) > tol:
        raise RuntimeError(f"parity / det6d: max abs differences {diffs} > "
                           f"{tol}")
    return {"counts": got["pred_count"].tolist(), "max_abs_diff": diffs,
            "picks_differing": n_diff, "partings": partings}


def phase_det6d_parity(report):
    import numpy as np
    import torch

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        post_processing,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, mc, nc = build_model("float32", "cuda", DET6D_CFG, DET6D_PARAMS)
    gamma = float(mc["BACKBONE_3D"]["SA_CONFIG"].get("WEIGHT_GAMMA", 1.0))
    pts, mask = load_det6d_scans()
    with torch.no_grad():
        out = model({"points": torch.from_numpy(pts[:2]).cuda(),
                     "points_mask": torch.from_numpy(mask[:2]).cuda()})
        post = post_processing(out, mc["POST_PROCESSING"], nc)
        res = check_det6d_parity(out, post, dict(np.load(DET6D_REF)), gamma)
    report["parity_det6d"] = res
    same = "identical" if not res["partings"] else (
        f"parting at near-ties only ({res['picks_differing']} differing)")
    print(f"parity / det6d: fp32 (TF32 off) on 2 scans matches the JAX "
          f"reference: picks per layer {same}, counts {res['counts']}, max "
          f"|d box| {res['max_abs_diff']['pred_boxes']:.3g}, max |d score| "
          f"{res['max_abs_diff']['pred_scores']:.3g} (tol {PARITY_TOL})",
          flush=True)


# ---------------------------------------------------------------------
# Det6D training: parity, train_model, tools/train.py, the SlopedKITTI
# eval
# ---------------------------------------------------------------------

# How far an fp32 evaluation of the fixture's full-width Det6D step lies
# from a float64 evaluation of the same step (the port's, every layer in
# float64, the reference's picks), the larger of the JAX package's and the
# port's on the CPU (tests/test_torch_det6d_train.py::
# test_full_width_gradients_against_float64): gradients 1.39e-2 of a
# leaf's largest |entry| (the port over every entry; JAX 1.01e-2 over the
# fixture's stored entries: BatchNorm's backward over up to 4096 x 128
# grouped slots cancels), loss terms 5.32e-7 relative (both), the gradient
# norm 6.85e-6 relative (JAX; the port 2.58e-7).
DET6D_TRAIN_F64 = {"grad": 1.39e-2, "loss": 5.32e-7, "grad_norm": 6.85e-6}
# Tolerances of the card's fp32 step against the JAX fp32 step: each
# fp32 evaluation lies within the distance above of the float64 one (the
# phase checks the card's own distance), so the two lie within twice that
# of each other. BatchNorm statistics (fp32 sums over up to 1,048,576
# positions a channel) at 2e-4 relative + 1e-5, regression targets 1e-5
# (log of the two libraries), as in :data:`TRAIN_TOL`.
DET6D_TRAIN_TOL = {**{k: 2 * v for k, v in DET6D_TRAIN_F64.items()},
                   "stats_rtol": 2e-4, "stats_atol": 1e-5,
                   "reg_targets": 1e-5}
DET6D_TRAIN_TARGETS = ("vote_cls_labels", "vote_reg_labels",
                       "point_cls_labels", "point_reg_labels",
                       "point_box_labels")


def det6d_train_batch(dev, prefix=""):
    """The fixture's batch of 2 (``prefix`` "train8_": its batch of 8)."""
    import numpy as np
    import torch

    with np.load(DET6D_TRAIN_REF) as ref:
        return {k: torch.from_numpy(ref[prefix + k]).to(dev)
                for k in ("points", "points_mask", "gt_boxes")}


def det6d_train_forward(model, batch, ref):
    """A train-mode forward and loss of ``model`` on ``batch`` with every
    sampling call forced to the fixture's picks. Returns (batch dict,
    loss, terms, the sampling calls with the port's own picks)."""
    picks = [ref[f"picks_{k}"] for k in range(3)]
    model.train()
    with forced_sampling(picks) as calls:
        out = model(dict(batch))
    loss, tb = model.get_training_loss(out)
    return out, loss, tb, list(calls)


def det6d_train_gradients(dev, batch, ref, dtype):
    """The port's loss terms and gradients (flat float64 numpy per
    parameter) of the fixture's step from the trained weights, the
    fixture's picks forced, with every layer computing in ``dtype``
    (float32 or float64; the geometry and the grouped inputs stay fp32,
    as the layers read them)."""
    import torch

    model = build_model("float32", dev, DET6D_SLOPED_CFG, DET6D_PARAMS)[0]
    if dtype == torch.float64:
        model.double()
        for mod in model.modules():
            if isinstance(getattr(mod, "dtype", None), torch.dtype):
                mod.dtype = torch.float64
    out, loss, tb, _ = det6d_train_forward(model, batch, ref)
    loss.backward()
    for k in ("vote_cls_labels", "point_cls_labels"):
        if not (out[k].cpu().numpy() == ref[f"target/{k}"]).all():
            raise RuntimeError(f"det6d gradients in {dtype}: {k} differ "
                               "from the fixture's")
    grads = {n: p.grad.detach().double().cpu().numpy().reshape(-1)
             for n, p in model.named_parameters()}
    return grads, {k: float(v) for k, v in tb.items()}


def f64_distances(g32, m32, g64, m64):
    """Largest gradient distance of ``g32`` from ``g64`` relative to each
    leaf's largest |entry|, largest relative loss-term distance, relative
    gradient-norm distance."""
    import numpy as np

    grad = max(float(np.abs(g32[n] - g).max() / max(np.abs(g).max(), 1e-30))
               for n, g in g64.items())
    loss = max(abs(m32[k] / v - 1) for k, v in m64.items() if v != 0)

    def norm(g):
        return np.sqrt(sum(float((x ** 2).sum()) for x in g.values()))

    return {"grad": grad, "loss": loss,
            "grad_norm": abs(norm(g32) / norm(g64) - 1)}


def check_det6d_train_parity(dev, measure_f64=True):
    """Det6D's train step in fp32 from the trained weights on the
    fixture's batch (2 frames of the JAX loader, SlopeAug on) against the
    JAX step stored in ``det6d_train_jax_ref.npz``, every sampling call
    given the reference's picks (:func:`forced_sampling`):

    1. each call's own picks equal the reference's or part at a certified
       near-tie (:func:`certify_sampling_call`);
    2. vote, point-cls, pitch-cls, yaw-bin and SASA labels and the box
       labels identical; regression targets within
       ``DET6D_TRAIN_TOL["reg_targets"]``;
    3. the loss terms, the gradient norm, every gradient (against its
       leaf's largest |entry|) and the BatchNorm statistics after the step
       within :data:`DET6D_TRAIN_TOL`.
    Returns a report; raises RuntimeError where a check fails."""
    import numpy as np
    import torch

    tol = DET6D_TRAIN_TOL
    tag = "parity / train_det6d"
    ref = dict(np.load(DET6D_TRAIN_REF))
    batch = det6d_train_batch(dev)
    model = build_model("float32", dev, DET6D_SLOPED_CFG, DET6D_PARAMS)[0]
    out, loss, tb, calls = det6d_train_forward(model, batch, ref)
    partings = []
    for k, call in enumerate(calls):
        partings += certify_sampling_call(
            tag, k, call, None if k == 0 else ref[f"scores_{k - 1}"], 0.0)
    got = {k: out[k].detach().cpu().numpy() for k in DET6D_TRAIN_TARGETS}
    for k in ("vote_cls_labels", "point_cls_labels", "point_box_labels"):
        if not np.array_equal(got[k], ref[f"target/{k}"]):
            raise RuntimeError(f"{tag}: {k} differ")
    reg, ref_reg = got["point_reg_labels"], ref["target/point_reg_labels"]
    if not (np.array_equal(reg[..., 6:18], ref_reg[..., 6:18])
            and np.array_equal(reg[..., 30], ref_reg[..., 30])):
        raise RuntimeError(f"{tag}: yaw-bin or pitch-class labels differ")
    d_reg = max(float(np.abs(got[k] - ref[f"target/{k}"]).max())
                for k in ("vote_reg_labels", "point_reg_labels"))
    if d_reg > tol["reg_targets"]:
        raise RuntimeError(f"{tag}: regression targets off by {d_reg}")
    for k, lab in enumerate(out["point_sasa_labels"]):
        if not np.array_equal(lab.cpu().numpy(),
                              ref[f"target/point_sasa_labels_{k}"]):
            raise RuntimeError(f"{tag}: SASA labels of layer {k} differ")
    loss.backward()
    grads = {n: p.grad.float().cpu().numpy().reshape(-1).copy()
             for n, p in model.named_parameters()}
    metrics = {k: float(v) for k, v in tb.items()}
    metrics["grad_norm"] = float(np.sqrt(sum(
        float((g.astype(np.float64) ** 2).sum()) for g in grads.values())))
    rel = {}
    for k, v in metrics.items():
        want = float(ref[f"metric/{k}"])
        rel[k] = abs(v - want) / max(abs(want), 1e-12)
        if rel[k] > tol["grad_norm" if k == "grad_norm" else "loss"]:
            raise RuntimeError(f"{tag}: {k} {v} vs {want} ({rel[k]:.3g} "
                               "relative)")
    grad_err = 0.0
    for name, (err, scale) in leaf_report(ref, "grad", grads,
                                          tol["grad"]).items():
        e = float(err.max(initial=0)) / max(scale, 1e-30)
        if e > tol["grad"]:
            raise RuntimeError(f"{tag}: gradient {name} off by {e:.3g} of "
                               f"its leaf's max {scale}")
        grad_err = max(grad_err, e)
    stat_err = 0.0
    for name, b in model.named_buffers():
        if "running" not in name:
            continue
        b, want = b.cpu().numpy(), ref[f"stats/{name}"]
        if not np.allclose(b, want, rtol=tol["stats_rtol"],
                           atol=tol["stats_atol"]):
            raise RuntimeError(f"{tag}: {name} after the step off by "
                               f"{np.abs(b - want).max()}")
        stat_err = max(stat_err, float(np.abs(b - want).max()))
    f64 = None
    if measure_f64:
        # the bound's premise: this device's fp32 step lies no farther
        # from the float64 step than the CPU runs did
        g64, m64 = det6d_train_gradients(dev, batch, ref, torch.float64)
        g32 = {n: g.astype(np.float64) for n, g in grads.items()}
        m32 = {k: v for k, v in metrics.items() if k != "grad_norm"}
        f64 = f64_distances(g32, m32, g64, m64)
        for k, v in f64.items():
            if v > DET6D_TRAIN_F64[k]:
                raise RuntimeError(
                    f"{tag}: the {k} of this device's fp32 step lies "
                    f"{v:.3g} from the float64 step, more than the CPU "
                    f"runs' {DET6D_TRAIN_F64[k]:.3g} the tolerance rests on")
    labels = ref["target/point_cls_labels"]
    return {"batch_index": int(ref["batch_index"]),
            "f64_distance": f64,
            "positives": int((labels > 0).sum()),
            "pitch_positives": int(((labels > 0)
                                    & (ref_reg[..., 30] > 0)).sum()),
            "sasa_fg": [int((ref[f"target/point_sasa_labels_{k}"] > 0).sum())
                        for k in range(3)],
            "partings": partings, "max_reg_target_diff": d_reg,
            "metrics": metrics, "metrics_rel_diff": rel,
            "max_grad_diff_of_leaf_max": grad_err,
            "max_batch_stats_diff": stat_err}


def phase_det6d_train_parity(report):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    r = check_det6d_train_parity("cuda")
    report["det6d_train_parity"] = r
    print(f"parity / train_det6d: fp32 (TF32 off) step on the fixture's "
          f"batch (loader batch {r['batch_index']}) matches the JAX step: "
          f"picks {'identical' if not r['partings'] else 'certified partings ' + str(len(r['partings']))}; "
          f"labels identical ({r['positives']} positives, "
          f"{r['pitch_positives']} with pitch class 1, SASA fg "
          f"{r['sasa_fg']}), regression targets "
          f"{r['max_reg_target_diff']:.3g}; loss terms and grad_norm within "
          f"{max(r['metrics_rel_diff'].values()):.3g} relative (loss "
          f"{r['metrics']['loss']:.6f}, grad_norm "
          f"{r['metrics']['grad_norm']:.6f}), gradients within "
          f"{r['max_grad_diff_of_leaf_max']:.3g} of their leaf's max, BN "
          f"statistics {r['max_batch_stats_diff']:.3g}; tolerances "
          f"{ {k: DET6D_TRAIN_TOL[k] for k in DET6D_TRAIN_F64} }; this "
          f"card's fp32 step from its float64 step: "
          f"{ {k: float(f'{v:.3g}') for k, v in r['f64_distance'].items()} }",
          flush=True)


def det6d_opt_cfg():
    from de6d_tpu_torch.config import cfg_from_yaml_file

    return dict(cfg_from_yaml_file(DET6D_SLOPED_CFG).OPTIMIZATION)


def phase_det6d_train(report, kernels, profile):
    """``train / det6d``: :func:`measure_train` with
    ``slopedkitti_models/det6d_car.yaml``'s dtypes (the head in bf16) at
    full width from the trained weights over the fixture's 8 frames,
    exactly 3 FPS launches a step and no other kernel launch."""
    model = build_model(None, "cuda", DET6D_SLOPED_CFG, DET6D_PARAMS)[0]
    out, rows = measure_train(
        "train / det6d", model, det6d_train_batch("cuda", "train8_"),
        det6d_opt_cfg(), kernels, {"fps": 3})
    fps_us = sum(us for name, us, _ in rows if "fps" in name.lower())
    out.update(compute_dtype="config (head bf16)",
               fps_device_us_per_step=fps_us,
               profile_top=[list(r) for r in rows[:25]])
    report["train_det6d"] = out
    print(train_line("train / det6d", out, "(head bf16) at full width "
                     "through train_model") + f"; FPS kernels {fps_us:.1f} "
          "us a step", flush=True)
    for name, us, c in rows[:12 if profile else 6]:
        print(f"train / det6d profile: {us:10.1f} us  x{c:6.1f}  "
              f"{name[:90]}")


def phase_det6d_train_slopedkitti(report, kernels):
    """``train / det6d_slopedkitti``: ``tools/train.py``'s entry
    (``prepare``, ``train``, ``evaluate``) on the shipped
    ``slopedkitti_models/det6d_car.yaml`` at batch 8 for one epoch of
    ``data/slopedkitti`` from the fresh init, 4 loader workers: step ms,
    steps/s, frames/s, the loader's share of the loop, the loss; exactly
    3 FPS launches a step and no other kernel; the checkpoint; the
    post-training SlopedKITTI eval with 3 FPS and 1-2 fused-NMS launches
    a batch."""
    import shutil

    import numpy as np
    import torch

    from de6d_tpu_torch.tools import train as train_cli

    tag = "chip_smoke"
    shutil.rmtree(ROOT / "output/slopedkitti_models/det6d_car" / tag,
                  ignore_errors=True)
    argv = ["--cfg_file", str(DET6D_SLOPED_CFG), "--epochs", "1",
            "--batch_size", "8", "--workers", "4", "--extra_tag", tag,
            "--fix_random_seed", "--set", "DATA_CONFIG.DATA_PATH",
            str(SLOPEDKITTI_DIR)]
    t0 = time.perf_counter()
    run = train_cli.prepare(argv)
    prep_s = time.perf_counter() - t0
    reset_launches(kernels)
    t0 = time.perf_counter()
    train_cli.train(run)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    steps = len(run.step_log)
    want = {k: 3 * steps if k == "fps" else 0 for k in kernels}
    if steps != len(run.train_loader) or launches != want:
        fail(f"train / det6d_slopedkitti: {steps} steps, launches "
             f"{launches}, expected {want}")
    losses = np.array([float(x[2]) for x in run.step_log])
    if not np.isfinite(losses).all():
        fail(f"train / det6d_slopedkitti: non-finite losses {losses}")
    ckpt = run.ckpt_dir / "checkpoint_epoch_1"
    if not ckpt.is_file():
        fail(f"train / det6d_slopedkitti: no checkpoint at {ckpt}")
    data_s = np.array([x[0] for x in run.step_log])
    step_s = np.array([x[1] for x in run.step_log])
    iter_ms = (data_s + step_s) * 1e3
    reset_launches(kernels)
    t0 = time.perf_counter()
    ret, _ = train_cli.evaluate(run)
    eval_s = time.perf_counter() - t0
    eval_launches = read_launches(kernels)
    n_eval = -(-50 // 8)
    want = {k: 3 * n_eval if k == "fps" else 0 for k in kernels}
    want["nms"] = eval_launches["nms"]
    if eval_launches != want or not n_eval <= want["nms"] <= 2 * n_eval:
        fail(f"train / det6d_slopedkitti: post-training eval launches "
             f"{eval_launches} in {n_eval} batches")
    out = {
        "steps": steps, "batch": 8, "compute_dtype": "config (head bf16)",
        "prepare_s": prep_s, "wall_s": wall,
        "median_step_ms": float(np.median(iter_ms)),
        "step_ms_iqr": [float(x) for x in np.percentile(iter_ms, [25, 75])],
        "median_host_step_ms": float(np.median(step_s) * 1e3),
        "median_loader_wait_ms": float(np.median(data_s) * 1e3),
        "loader_wait_share": float(data_s.sum() / (data_s + step_s).sum()),
        "steps_per_s": steps / wall, "frames_per_s": 8 * steps / wall,
        "losses": losses.tolist(), "launches": launches,
        "eval_launches": eval_launches, "eval_s": eval_s,
        "eval_recall": {k: ret[k] for k in ret if k.startswith("recall/")},
        "eval_ods": ret.get("Car_ods/all_R40"), "checkpoint": str(ckpt),
    }
    report["train_det6d_slopedkitti"] = out
    print(f"train / det6d_slopedkitti: tools/train.py, slopedkitti "
          f"det6d_car.yaml (head bf16), batch 8, 1 epoch of "
          f"data/slopedkitti ({steps} steps) from the fresh init: median "
          f"step {out['median_step_ms']:.2f} ms (IQR "
          f"{out['step_ms_iqr'][0]:.2f}-{out['step_ms_iqr'][1]:.2f}; host "
          f"step {out['median_host_step_ms']:.2f}, loader wait "
          f"{out['median_loader_wait_ms']:.2f}), {out['steps_per_s']:.2f} "
          f"steps/s, {out['frames_per_s']:.2f} frames/s, loader wait "
          f"{out['loader_wait_share']:.1%} of the loop; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f} (mean of the first 5 "
          f"{losses[:5].mean():.4f}, last 5 {losses[-5:].mean():.4f}); "
          f"launches {launches}; post-training eval {eval_s:.1f} s, "
          f"launches {eval_launches}, recall {out['eval_recall']} "
          f"(prepare {prep_s:.1f} s)", flush=True)


def slopedkitti_val_loader(workers=4):
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.datasets import build_dataloader

    cfg = cfg_from_yaml_file(DET6D_SLOPED_CFG)
    return build_dataloader(cfg.DATA_CONFIG, cfg.CLASS_NAMES, EVAL_BATCH,
                            root_path=str(SLOPEDKITTI_DIR), training=False,
                            workers=workers)


# the SlopedKITTI true-positive scores (ATS, ASS, AOS) and the ODS average
# per-match errors, which move by at most the detections' own difference:
# held to PARITY_TOL; AOS (percent) averages (1 + cos d yaw) / 2 over the
# matches: held to 50 * max |d yaw|, as the KITTI eval's; every other AP
# entry must be equal
SLOPED_SCORE_KEYS = ("_ats/", "_ass/", "_aoe_score/", "_ods/")


def det6d_eval_parity(dev, kernels=None):
    """``eval_one_epoch`` of Det6D in fp32 from the trained weights over the
    50 val frames of ``data/slopedkitti`` at batch 8, every sampling call
    given the JAX eval's picks (:func:`forced_sampling`), against
    ``det6d_eval_jax_ref.npz``: each call's own picks equal the
    reference's or part at a certified near-tie; frame order, per-frame
    counts and labels equal, boxes (9 columns) and scores within
    :data:`PARITY_TOL`; recall counters equal; every AP entry of the
    SlopedKITTI result dict equal and its true-positive scores and ODS
    within :data:`PARITY_TOL`. Returns the report."""
    import numpy as np

    from de6d_tpu_torch.train.eval_utils import eval_one_epoch

    tag = "eval / det6d_slopedkitti"
    ref = dict(np.load(DET6D_EVAL_REF))
    n_batches = sum(k.endswith("_picks_0") for k in ref)
    picks = [ref[f"b{b}_picks_{k}"] for b in range(n_batches)
             for k in range(3)]
    ds, loader = slopedkitti_val_loader()
    model, mc, _ = build_model("float32", dev, DET6D_SLOPED_CFG,
                               DET6D_PARAMS)
    with forced_sampling(picks) as calls:
        ret, annos = eval_one_epoch(model, loader, ds, mc, ds.class_names)
    loader.close()
    if len(calls) != len(picks):
        fail(f"{tag}: {len(calls)} sampling calls, reference {len(picks)}")
    partings = []
    for i, call in enumerate(calls):
        b, k = divmod(i, 3)
        partings += certify_sampling_call(
            tag, i, call, None if k == 0 else ref[f"b{b}_scores_{k - 1}"],
            0.0)
    got = {
        "frame_id": np.array([a["frame_id"] for a in annos]),
        "count": np.array([len(a["score"]) for a in annos]),
        "boxes": np.concatenate([np.asarray(a["boxes_lidar"], np.float32)
                                 .reshape(-1, 9) for a in annos]),
        "scores": np.concatenate([np.asarray(a["score"], np.float32)
                                  for a in annos]),
    }
    if got["frame_id"].tolist() != ref["frame_id"].tolist():
        fail(f"{tag}: frame order differs")
    if not np.array_equal(got["count"], ref["count"]):
        bad = np.nonzero(got["count"] != ref["count"])[0]
        fail(f"{tag}: counts differ at frames {bad.tolist()}")
    if any(n != "Car" for a in annos for n in a["name"]) or not (
            ref["labels"] == 1).all():
        fail(f"{tag}: labels differ")
    d_box = float(np.abs(got["boxes"] - ref["boxes"]).max(initial=0))
    d_score = float(np.abs(got["scores"] - ref["scores"]).max(initial=0))
    if max(d_box, d_score) > PARITY_TOL:
        fail(f"{tag}: max |d box| {d_box}, |d score| {d_score} > "
             f"{PARITY_TOL}")
    counts = dict(zip(ref["recall_keys"].tolist(),
                      ref["recall_counts"].tolist()))
    if ret["recall_counts"] != counts:
        fail(f"{tag}: recall {ret['recall_counts']} vs {counts}")
    d_scores = d_aos = 0.0
    aos_tol = 50 * float(np.abs(got["boxes"][:, 6] - ref["boxes"][:, 6]).max(
        initial=0))
    for k, want in zip(ref["ap_keys"].tolist(), ref["ap_values"].tolist()):
        v = float(ret[k])
        if "_aos/" in k:
            d_aos = max(d_aos, abs(v - want))
            if abs(v - want) > aos_tol:
                fail(f"{tag}: {k} {v} vs {want} (> {aos_tol})")
        elif any(s in k for s in SLOPED_SCORE_KEYS):
            d_scores = max(d_scores, abs(v - want))
            if abs(v - want) > PARITY_TOL:
                fail(f"{tag}: {k} {v} vs {want}")
        elif v != want:
            fail(f"{tag}: {k} {v} vs {want}")
    return {"counts": int(got["count"].sum()), "max_abs_box": d_box,
            "max_abs_score": d_score, "partings": partings,
            "max_abs_tp_score": d_scores, "max_abs_aos": d_aos,
            "aos_tol": aos_tol, "recall": ret["recall_counts"],
            "ods": float(ret["Car_ods/all_R40"]),
            "ap_3d_moderate_R40": float(ret["Car_3d/moderate_R40"])}


def phase_det6d_eval(report, kernels):
    """``eval / det6d_slopedkitti``: the fp32 gate (:func:`det6d_eval_parity`),
    then ``eval_one_epoch`` with the config's dtypes (head bf16): ms per
    frame and 3 FPS and 1-2 fused-NMS launches a batch."""
    import torch

    from de6d_tpu_torch.train.eval_utils import eval_one_epoch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    parity = det6d_eval_parity("cuda")
    ds, loader = slopedkitti_val_loader()
    model, mc, _ = build_model(None, "cuda", DET6D_SLOPED_CFG, DET6D_PARAMS)
    eval_one_epoch(model, loader, ds, mc, ds.class_names)  # warm
    reset_launches(kernels)
    t0 = time.perf_counter()
    ret, _ = eval_one_epoch(model, loader, ds, mc, ds.class_names)
    wall = time.perf_counter() - t0
    launches = read_launches(kernels)
    n = len(loader)
    loader.close()
    want = {k: 3 * n if k == "fps" else 0 for k in kernels}
    want["nms"] = launches["nms"]
    if launches != want or not n <= launches["nms"] <= 2 * n:
        fail(f"eval / det6d_slopedkitti: launches {launches} in {n} "
             "batches, expected 3 FPS and 1-2 fused NMS a batch")
    out = {"parity": parity,
           "bf16_head": {k: v for k, v in ret.items()},
           "ms_per_frame": ret["sec_per_example"] * 1e3,
           "steady_ms_per_frame": (ret["steady_sec_per_example"] or 0) * 1e3,
           "wall_s": wall, "batches": n, "launches": launches}
    report["eval_det6d"] = out
    print(f"eval / det6d_slopedkitti: fp32 (TF32 off) eval_one_epoch of the "
          f"trained weights over the 50 val frames at batch {EVAL_BATCH} "
          f"matches det6d_eval_jax_ref.npz: {parity['counts']} detections, "
          f"max |d box| {parity['max_abs_box']:.3g}, |d score| "
          f"{parity['max_abs_score']:.3g} (tol {PARITY_TOL}), "
          f"{len(parity['partings'])} certified s-fps partings, recall "
          f"{parity['recall']} equal, every AP but AOS equal (AOS within "
          f"{parity['max_abs_aos']:.3g} of the yaw bound "
          f"{parity['aos_tol']:.3g}), TP scores and ODS within "
          f"{parity['max_abs_tp_score']:.3g} (ODS "
          f"{parity['ods']:.4f}, 3D AP moderate R40 "
          f"{parity['ap_3d_moderate_R40']:.4f}); head bf16 "
          f"{out['ms_per_frame']:.3f} ms per frame over the epoch (steady "
          f"p50 {out['steady_ms_per_frame']:.3f}), launches {launches} in "
          f"{n} batches", flush=True)


# ---------------------------------------------------------------------
# PointRCNN: suppression-mask kernel, serve, parity
# ---------------------------------------------------------------------

def timed(fn):
    """(result, device ms) of one call of ``fn``."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def random_boxes(rng, b, p, spread=12.0, cluster=80):
    """(b, p, 7) rotated boxes with a dense cluster at the front, so that
    suppression chains cross the 64-column words."""
    import numpy as np

    boxes = np.zeros((b, p, 7), np.float32)
    boxes[..., 0:2] = rng.uniform(-spread, spread, (b, p, 2))
    boxes[..., 2] = rng.uniform(-1, 1, (b, p))
    boxes[..., 3:5] = rng.uniform(1.5, 4, (b, p, 2))
    boxes[..., 5] = 1.5
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, p))
    cluster = min(cluster, p)
    boxes[:, :cluster, 0:2] = rng.uniform(-3, 3, (b, cluster, 2))
    return boxes


def adversarial_boxes(rng):
    """(2, P, 7) boxes where a bound pre-test could go wrong: pairs that
    touch or lie 1e-6 m apart along an edge, parallel edges at small gaps,
    1e-3 m and 1e4 m boxes, boxes far from the origin, identical boxes,
    degenerate (zero-size) and mirrored (negative-size) boxes, and random
    rotations."""
    import numpy as np

    rows = []
    for gap in (0.0, 1e-6, 1e-4, 1e-3, 2e-3, 1e-2, 0.1):
        for yaw in (0.0, np.pi / 2, 0.3):
            for far in (0.0, 5e3):
                l, w = 4.0, 1.6
                c, s_ = np.cos(yaw), np.sin(yaw)
                # box 2 beside box 1 along its heading, `gap` between faces
                step = l + gap
                rows.append([far, far, 0, l, w, 1.5, yaw])
                rows.append([far + step * c, far + step * s_, 0, l, w, 1.5,
                             yaw])
                rows.append([far, far + w + gap, 0, l, w, 1.5, 0.0])
    for size in (1e-3, 1e4):
        for k in range(6):
            rows.append([rng.uniform(-3, 3) * size, rng.uniform(-3, 3) * size,
                         0, size, size * rng.uniform(0.5, 2), 1.0,
                         rng.uniform(-np.pi, np.pi)])
    same = [1.0, 2.0, 0.0, 3.9, 1.6, 1.5, 0.7]
    rows += [same, same, [1.0, 2.0, 0.0, 0.0, 1.6, 1.5, 0.0],
             [1.5, 2.0, 0.0, -3.9, 1.6, 1.5, 0.7],
             [1e4, -1e4, 0.0, 4.0, 1.6, 1.5, 1.0],
             [1e4 + 4.0 + 1e-6, -1e4, 0.0, 4.0, 1.6, 1.5, 1.0]]
    for _ in range(40):
        rows.append([rng.uniform(-6, 6), rng.uniform(-6, 6), 0,
                     rng.uniform(0.5, 5), rng.uniform(0.5, 3), 1.5,
                     rng.uniform(-np.pi, np.pi)])
    boxes = np.asarray(rows, np.float32)
    return np.stack([boxes, boxes[rng.permutation(len(boxes))]])


def check_nms_mask(cases):
    """cases: {label: (boxes (B, P, 7+), counts (B,), thresh, post)} → a
    result line per case. The kernel's whole bit mask must equal the
    plain version's, and the resolve kernel's selections and counts its
    plain version's (each on its own side's mask)."""
    import torch

    from de6d_tpu_torch.ops import iou3d
    from de6d_tpu_torch.ops.kernels import nms_mask as nm

    lines = {}
    for label, (boxes, counts, thresh, post) in cases.items():
        packed = iou3d.pack_bev(boxes[..., :7]).contiguous()
        got = nm.nms_suppression_mask(packed, counts, thresh)
        ref, plain_ms = timed(
            lambda: nm.nms_suppression_mask_plain(packed, counts, thresh))
        if not torch.equal(got, ref):
            bad = (got != ref).nonzero()[0].tolist()
            fail(f"kernels / nms_mask {label}: mask differs from the plain "
                 f"version, first at (sample, row, word) {bad}")
        sel, nsel = nm.nms_resolve(got, counts, post)
        (rsel, rnsel), resolve_plain_ms = timed(
            lambda: nm.nms_resolve_plain(ref, counts, post))
        torch.cuda.synchronize()
        if not (torch.equal(sel, rsel) and torch.equal(nsel, rnsel)):
            fail(f"kernels / nms_mask {label}: resolve differs from its "
                 "plain version")
        b, p = boxes.shape[:2]
        live = counts.clamp(0, p).long()
        ious = int((live * (live - 1) // 2).sum())
        survivors = int(nm.survivors_plain(packed, counts, thresh).sum())
        nbytes = packed.numel() * 4 + b * 4 + got.numel() * 8
        # what the function needs: the pre-test on every live pair, the IoU
        # on the pairs it does not decide
        t_ops = (ious * nm.PRETEST_FLOPS
                 + survivors * nm.FLOPS_PER_IOU) / FP32_FLOPS
        t_all = ious * nm.FLOPS_PER_IOU / FP32_FLOPS
        t_bytes = nbytes / HBM_BYTES_PER_S
        lines[label] = {
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: nm.nms_suppression_mask(
                packed, counts, thresh), 5),
            "plain_ms": plain_ms,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bound_all_pairs_ms": max(t_all, t_bytes) * 1e3,
            "resolve_ms": time_ms(lambda: nm.nms_resolve(got, counts, post),
                                  20),
            "resolve_plain_ms": resolve_plain_ms,
            "ious": ious,
            "survivors": survivors,
            "survivor_share": survivors / ious if ious else None,
            "bits_set": int(nm.unpack_bits(got, p).sum()) if p <= 1024
            else None,
            "kept": nsel.tolist(),
            "shape": f"corners ({b}, 9, {p}), live {counts.tolist()}, "
                     f"thresh {thresh}, post {post}",
        }
        ln = lines[label]
        share = ln["survivor_share"]
        print(f"kernels / nms_mask {label}: mask and selections identical, "
              f"{ln['ms']:.4f} ms, plain {ln['plain_ms']:.2f} ms, bound "
              f"{ln['bound_ms']:.5f} ms ({ln['bound_by']}; all pairs "
              f"{ln['bound_all_pairs_ms']:.5f}), {ious} live pairs, "
              f"{survivors} survive the pre-test ("
              f"{'-' if share is None else f'{share:.4%}'}); resolve "
              f"{ln['resolve_ms']:.4f} ms, plain "
              f"{ln['resolve_plain_ms']:.2f} ms, kept {ln['kept']}",
              flush=True)
    return lines


def phase_rcnn_kernels(report):
    """The mask and resolve kernels at the served PointRCNN model's
    shapes and inputs and at the ragged shapes, and FPS at its shapes."""
    import numpy as np
    import torch

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        select_candidates,
    )
    from de6d_tpu_torch.ops.nms import NEG_INF, stable_top_k

    model, mc, _ = build_model("bfloat16", "cuda", RCNN_CFG, RCNN_SEED)
    pts, mask = load_rcnn_scans()
    points = torch.from_numpy(pts).cuda()
    valid = torch.from_numpy(mask).cuda()
    with torch.no_grad():
        out = model({"points": points, "points_mask": valid})
    roi_cfg = mc["ROI_HEAD"]["NMS_CONFIG"]["TEST"]
    num_rois = int(roi_cfg["NMS_POST_MAXSIZE"])
    if tuple(out["rois"].shape) != (8, num_rois, 7):
        fail(f"kernels / nms_mask: RoI buffer {tuple(out['rois'].shape)}")
    roi_counts = out["roi_valid"].sum(-1).tolist()
    report["pointrcnn_rois"] = {"shape": list(out["rois"].shape),
                                "valid": roi_counts,
                                "empty": out["roi_empty"].sum(-1).tolist()}
    print(f"kernels / nms_mask: RoI buffer {tuple(out['rois'].shape)}, "
          f"valid per scan {roi_counts}, without points "
          f"{report['pointrcnn_rois']['empty']}", flush=True)

    # the proposal layer's candidates: top NMS_PRE_MAXSIZE stage-1 scores
    scores = torch.sigmoid(out["point_cls_preds"]).amax(dim=-1)
    pre = min(int(roi_cfg["NMS_PRE_MAXSIZE"]), scores.shape[1])
    top, order = stable_top_k(scores, pre)
    cand = torch.gather(out["point_box_preds"], 1,
                        order[..., None].expand(-1, -1, 7)).contiguous()
    all_live = torch.full((8,), pre, dtype=torch.int32, device="cuda")
    post_cfg = mc["POST_PROCESSING"]
    nms_cfg = post_cfg["NMS_CONFIG"]
    fin_boxes, fin_scores, _ = select_candidates(out, post_cfg)
    fin_boxes = fin_boxes.contiguous()
    fin_counts = (fin_scores > NEG_INF / 2).sum(-1).to(torch.int32)
    fin_post = min(int(nms_cfg["NMS_POST_MAXSIZE"]), fin_boxes.shape[1])
    ragged = torch.minimum(fin_counts, torch.tensor(
        [100, 77, 0, 1, 64, 65, 99, 100], dtype=torch.int32, device="cuda"))
    rng = np.random.RandomState(7)
    cases = {
        "proposals": (cand, all_live, float(roi_cfg["NMS_THRESH"]), num_rois),
        "final": (fin_boxes, fin_counts, float(nms_cfg["NMS_THRESH"]),
                  fin_post),
        "final_ragged": (fin_boxes, ragged, float(nms_cfg["NMS_THRESH"]),
                         fin_post),
    }
    for p in (1, 63, 64, 65, 130):
        boxes = torch.from_numpy(random_boxes(rng, 4, p)).cuda()
        counts = torch.tensor([p, p - 1, p // 2, 0], dtype=torch.int32,
                              device="cuda")
        cases[f"p{p}"] = (boxes, counts, 0.1, p)
    adversarial = torch.from_numpy(adversarial_boxes(rng)).cuda()
    adv_counts = torch.tensor([adversarial.shape[1]] * 2, dtype=torch.int32,
                              device="cuda")
    for thresh in (-0.1, 0.0, 0.1, 0.85):
        cases[f"adversarial_thresh_{thresh}"] = (adversarial, adv_counts,
                                                 thresh, 64)
    lines = check_nms_mask(cases)
    path = [lines["proposals"], lines["final"]]  # the two launches per batch
    report["nms_mask"] = {
        "name": "nms_suppression_mask",
        "route": "cuda",
        "source": "de6d_tpu_torch/csrc/nms_mask.cu",
        "replaces": "de6d_tpu/ops/pallas/nms_mask.py:132",
        "max_abs_err": 0.0,
        **{k: sum(ln[k] for ln in path) for k in (
            "ms", "plain_ms", "bound_ms", "bound_all_pairs_ms", "resolve_ms",
            "resolve_plain_ms", "ious", "survivors")},
        "bound_by": lines["proposals"]["bound_by"],
        "library_ms": None,
        "cases": lines,
    }

    xyz_l, valid_l = out["point_coords_list"], out["point_valid_list"]
    roi_xyz = torch.from_numpy(rng.uniform(-2, 2, (800, 512, 3)).astype(
        np.float32)).cuda()
    roi_valid = (torch.arange(800, device="cuda") % 5 != 0)[:, None].expand(
        800, 512).contiguous()  # every fifth point set is empty
    fps_cases = {
        "rcnn_sa1": (points[..., :3].contiguous(), valid, 4096, None),
        "rcnn_sa2": (xyz_l[0], valid_l[0], 1024, None),
        "rcnn_sa3": (xyz_l[1], valid_l[1], 256, None),
        "rcnn_sa4": (xyz_l[2], valid_l[2], 64, None),
        "rcnn_roi_sa1": (roi_xyz, roi_valid, 128, None),
        "rcnn_roi_sa2": (roi_xyz[:, :128].contiguous(),
                         roi_valid[:, :128].contiguous(), 32, None),
    }
    fps_lines = check_fps(fps_cases, report)
    report["fps"]["cases"].update(fps_lines)
    report["fps"]["pointrcnn_ms_per_batch"] = sum(
        ln["ms"] for ln in fps_lines.values())
    return model, mc


def face_distance(points, valid, rois):
    """points (N, 3), valid (N,), rois (R, 7) → (R,) the least distance
    of a valid point from the RoI's surface, measured as ``points_in_
    boxes_mask`` decides membership: ``| max_k (|local_k| - half_k) |``."""
    import torch

    d = points[None, :, :3] - rois[:, None, 0:3]
    c = torch.cos(rois[:, 6])[:, None]
    s = torch.sin(rois[:, 6])[:, None]
    local = torch.stack([c * d[..., 0] + s * d[..., 1],
                         (-s) * d[..., 0] + c * d[..., 1], d[..., 2]], dim=-1)
    outer = (local.abs() - rois[:, None, 3:6] / 2).amax(dim=-1)  # (R, N)
    return torch.where(valid[None], outer.abs(), torch.inf).amin(dim=-1)


def close_to(tag, name, got, want, tol, where=""):
    """The largest difference between ``got`` and ``want``, absolute for
    values below 1 and relative above (seeded weights decode to boxes
    tens of metres long); raises RuntimeError above ``tol``."""
    import numpy as np

    want = np.asarray(want, np.float64)
    d = float((np.abs(np.asarray(got, np.float64) - want)
               / np.maximum(1.0, np.abs(want))).max(initial=0))
    if not d <= tol:
        raise RuntimeError(f"{tag}: {name}{where} differs by {d:.3g} > {tol}")
    return d


def pair_roi_lists(tag, b, roi_idx, ref_idx, rois, ref_rois, tie_gap, near,
                   tol, source):
    """One sample's RoI list (the ``source`` row each RoI came from, its
    boxes) against the reference's. It may part from the reference's only
    at a near-tie: at the first differing slot the two rows' reference
    scores (``tie_gap(port row, reference row)``) within ``near``, or
    RuntimeError. A list that holds the same set of rows in another
    order, or that parts only onto twin rows (every slot still holds the
    reference's box within ``tol``), counts as the reference's list.
    Returns (port slots, reference slots) of the RoIs to compare, whether
    the list counts as the reference's, and the parting (or None)."""
    import numpy as np

    same = roi_idx == ref_idx
    # a swap of two tied candidates leaves the set of RoIs as it was;
    # twin rows (same coordinates and features) give the same box in
    # every slot: either way the list counts as the reference's
    same_set = np.array_equal(np.sort(roi_idx), np.sort(ref_idx))
    twins = bool((np.abs(rois - ref_rois) <= tol).all())
    parting = None
    if not same.all():
        j = int(np.argmin(same))
        p, r = int(roi_idx[j]), int(ref_idx[j])
        gap = tie_gap(p, r)
        parting = {"sample": b, "slot": j, "port": p, "ref": r,
                   "score_gap": gap, "allowed": near, "same_set": same_set,
                   "same_boxes": twins}
        print(f"{tag}: sample {b} parts from the reference at RoI {j} "
              f"(port {source} {p}, reference {source} {r}); score gap "
              f"{gap:.3g} vs {near:.3g}; same set of RoIs: {same_set}, "
              f"same box in every slot: {twins}", flush=True)
        if gap > near:
            raise RuntimeError(f"{tag}: RoI {j} of sample {b} is no "
                               "near-tie")
    if twins and not same_set:  # slot by slot
        gi = ri = np.arange(len(ref_idx))
    else:  # RoIs from the same row, reference slot → port slot
        slot = {int(p): j for j, p in enumerate(roi_idx)}
        pairs = [(slot[int(p)], j) for j, p in enumerate(ref_idx)
                 if int(p) in slot]
        gi = np.array([g for g, _ in pairs], np.int64)
        ri = np.array([r for _, r in pairs], np.int64)
    return gi, ri, same_set or twins, parting


def check_pointrcnn_parity(out, post, ref, tol=PARITY_TOL):
    """PointRCNN against the JAX reference ``ref`` (the fixture's arrays).

    1. Backbone picks (d-fps on coordinates, no learned input): each SA
       layer's picks identical.
    2. Stage-1 scores (sigmoid of the class logits, max over classes)
       within ``tol``; their largest difference is ``delta``. The boxes of
       the reference's first candidates within ``tol``.
    3. The candidate order (top ``NMS_PRE_MAXSIZE`` by score, the NMS
       input): a position may hold another point than the reference's
       only at a near-tie, the two points' reference scores within
       ``2 * delta`` (fp32 sums in another order move scores by ulps).
    4. RoIs, by the point each came from: a sample's RoI list may part
       from the reference's only at such a near-tie (at the first
       differing slot, the two points' reference scores within
       ``2 * delta``); the slot is reported. A list that holds the same
       set of points in another order, or that parts only onto twin
       points (every slot still holds the reference's box within
       ``tol``), counts as the reference's list.
    5. RoIs that came from the same point: boxes within ``tol``; then
       ``rcnn_cls`` and ``rcnn_reg`` within ``tol`` and the same RoIs
       without points — except a RoI with a point on one of its faces
       (:func:`face_distance` within the band that the measured
       difference between the two RoIs can move a point by), whose pooled
       set may differ; those are counted and reported.
    6. Detections of a sample whose RoI list counts as the reference's and
       none of whose on-a-face RoIs moved: counts and labels equal, boxes
       and scores within ``tol``. Other samples' detections are reported
       as not compared.
    "Within ``tol``" is absolute for values below 1 and relative above.
    Returns a report; raises RuntimeError where a check fails."""
    import numpy as np
    import torch

    from de6d_tpu_torch.ops.nms import stable_top_k

    def close(name, got, want, where=""):
        return close_to("parity / pointrcnn", name, got, want, tol, where)

    diffs = {}
    picks = [p.cpu().numpy() for p in out["point_sample_idx_list"]]
    for k, p in enumerate(picks):
        if not np.array_equal(p, ref[f"picks_{k}"]):
            raise RuntimeError(f"parity / pointrcnn: SA{k + 1} (d-fps) "
                               "picks differ from the reference")
    scores_t = torch.sigmoid(out["point_cls_preds"]).amax(dim=-1)
    scores = scores_t.cpu().numpy()
    ref_scores = ref["stage1_scores"]
    delta = diffs["stage1_scores"] = close("stage-1 scores", scores,
                                           ref_scores)
    ref_order = ref["stage1_order"].astype(np.int64)
    n_top = ref["stage1_boxes_top"].shape[1]
    boxes = out["point_box_preds"].cpu().numpy()
    diffs["stage1_boxes"] = close(
        "stage-1 boxes", np.take_along_axis(
            boxes, ref_order[:, :n_top, None], axis=1),
        ref["stage1_boxes_top"])
    order = stable_top_k(scores_t, ref_order.shape[1])[1].cpu().numpy()
    near = 2 * delta + 1e-7

    def tie_gap(b, p, r):
        return abs(float(ref_scores[b, p]) - float(ref_scores[b, r]))

    swapped = 0
    for b, k in zip(*np.nonzero(order != ref_order)):
        swapped += 1
        if tie_gap(b, order[b, k], ref_order[b, k]) > near:
            raise RuntimeError(
                f"parity / pointrcnn: candidate {k} of sample {b} differs "
                "from the reference and is no near-tie")

    roi_idx = out["roi_point_idx"].cpu().numpy()
    roi_cnt = out["roi_valid"].sum(-1).cpu().numpy()
    got = {k: v.cpu().numpy() for k, v in post.items()}
    for k in ("rois", "rcnn_cls", "rcnn_reg", "roi_empty"):
        got[k] = out[k].cpu().numpy()
    partings, on_faces, skipped = [], [], []
    for k in ("rois", "rcnn_cls", "rcnn_reg", "pred_boxes", "pred_scores"):
        diffs[k] = 0.0
    for b in range(roi_idx.shape[0]):
        c = int(ref["roi_count"][b])
        if int(roi_cnt[b]) != c:
            raise RuntimeError(f"parity / pointrcnn: {roi_cnt[b]} RoIs in "
                               f"sample {b}, reference {c}")
        gi, ri, whole, parting = pair_roi_lists(
            "parity / pointrcnn", b, roi_idx[b, :c], ref["roi_idx"][b, :c],
            got["rois"][b, :c], ref["rois"][b, :c],
            lambda p, r: tie_gap(b, p, r), near, tol, "point")
        if parting is not None:
            partings.append(parting)
        where = f" of sample {b}"
        diffs["rois"] = max(diffs["rois"], close(
            "rois", got["rois"][b, gi], ref["rois"][b, ri], where))
        # a RoI with a point on one of its faces: the ulps between the
        # two RoIs can move that point in or out and change the pooled set
        d_roi = np.abs(got["rois"][b, gi].astype(np.float64)
                       - ref["rois"][b, ri])
        half_diag = np.linalg.norm(ref["rois"][b, ri, 3:6], axis=-1) / 2
        band = 2 * (d_roi[:, :3].max(-1) + d_roi[:, 3:6].max(-1)
                    + d_roi[:, 6] * half_diag) + 1e-6
        on_face = face_distance(out["point_coords"][b], out["point_valid"][b],
                                out["rois"][b, gi]).cpu().numpy() <= band
        held = ~on_face
        d_cls = np.abs(got["rcnn_cls"][b, gi].astype(np.float64)
                       - ref["rcnn_cls"][b, ri])
        moved = on_face & ((d_cls > tol) | (got["roi_empty"][b, gi]
                                            != ref["roi_empty"][b, ri]))
        on_faces.append({"sample": b, "rois": int(on_face.sum()),
                         "moved": int(moved.sum())})
        if not np.array_equal(got["roi_empty"][b, gi[held]],
                              ref["roi_empty"][b, ri[held]]):
            raise RuntimeError("parity / pointrcnn: RoIs without points "
                               f"differ{where}")
        full = held & ~ref["roi_empty"][b, ri]
        for k in ("rcnn_cls", "rcnn_reg"):
            diffs[k] = max(diffs[k], close(
                k, got[k][b, gi[full]], ref[k][b, ri[full]], where))
        if not whole or moved.any():
            skipped.append(b)
            continue
        n = int(ref["pred_count"][b])
        if int(got["pred_count"][b]) != n:
            raise RuntimeError(f"parity / pointrcnn: counts "
                               f"{got['pred_count']} vs {ref['pred_count']}")
        if not np.array_equal(got["pred_labels"][b, :n],
                              ref["pred_labels"][b, :n]):
            raise RuntimeError(f"parity / pointrcnn: labels{where} differ")
        for k in ("pred_boxes", "pred_scores"):
            diffs[k] = max(diffs[k], close(k, got[k][b, :n], ref[k][b, :n],
                                           where))
    return {"counts": got["pred_count"].tolist(),
            "roi_counts": roi_cnt.tolist(), "max_abs_diff": diffs,
            "candidates_swapped": swapped, "partings": partings,
            "rois_on_a_face": on_faces, "detections_not_compared": skipped}


def phase_rcnn_parity(report):
    import numpy as np
    import torch

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        post_processing,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, mc, nc = build_model("float32", "cuda", RCNN_CFG, RCNN_SEED)
    pts, mask = load_rcnn_scans()
    with torch.no_grad():
        out = model({"points": torch.from_numpy(pts[:2]).cuda(),
                     "points_mask": torch.from_numpy(mask[:2]).cuda()})
        post = post_processing(out, mc["POST_PROCESSING"], nc)
    try:
        res = check_pointrcnn_parity(out, post, dict(np.load(RCNN_REF)))
    except RuntimeError as e:
        fail(str(e))
    report["parity_pointrcnn"] = res
    d = res["max_abs_diff"]
    print(f"parity / pointrcnn: fp32 (TF32 off) on 2 scans matches the JAX "
          f"reference: backbone picks identical, "
          f"{res['candidates_swapped']} candidates swapped at near-ties, "
          f"{len(res['partings'])} RoI lists parted, RoIs with a point on "
          f"a face {res['rois_on_a_face']}, detections not compared for "
          f"samples {res['detections_not_compared']}, RoIs "
          f"{res['roi_counts']}, detections {res['counts']}, max |d| stage-1 "
          f"score {d['stage1_scores']:.3g}, RoI {d['rois']:.3g}, rcnn_cls "
          f"{d['rcnn_cls']:.3g}, box {d['pred_boxes']:.3g}, score "
          f"{d['pred_scores']:.3g} (tol {PARITY_TOL})", flush=True)


# ---------------------------------------------------------------------
# 3DSSD / 3DSSD-SASA / IA-SSD: f-fps kernel, serve, parity
# ---------------------------------------------------------------------

@contextlib.contextmanager
def forced_sampling(ref_picks):
    """Within the block every sampling call of the port's point backbones
    (``run_sampling``, ``run_sampling_iassd``) computes its own picks on
    the inputs it is given, records them with those inputs, and returns
    the reference's picks for that call (``ref_picks[k]`` for the k-th
    call) instead. Each call's picks are thus held against the
    reference's on the same upstream points, and a certified parting
    (which changes the sampled set, not only its order) does not spread
    into the layers after it."""
    import torch

    from de6d_tpu_torch.models.backbones_3d import (
        iassd_backbone, pointnet2_modules,
    )

    calls = []

    def wrap(fn):
        def run(method, xyz, features, scores, valid, npoint, sample_range,
                gamma=1.0):
            extra = () if fn is orig[1] else (gamma,)
            own = fn(method, xyz, features, scores, valid, npoint,
                     sample_range, *extra)
            k = len(calls)
            if k >= len(ref_picks) or tuple(ref_picks[k].shape) != tuple(
                    own.shape):
                raise RuntimeError(f"sampling call {k} ({method}) has no "
                                   "counterpart in the reference")
            ref = torch.tensor(ref_picks[k], device=own.device,
                               dtype=own.dtype)
            calls.append(dict(method=method, own=own, ref=ref, xyz=xyz,
                              features=features, scores=scores, valid=valid,
                              npoint=int(npoint), range=sample_range,
                              gamma=float(gamma)))
            return ref
        return run

    orig = (pointnet2_modules.run_sampling, iassd_backbone.run_sampling_iassd)
    pointnet2_modules.run_sampling = wrap(orig[0])
    iassd_backbone.run_sampling_iassd = wrap(orig[1])
    try:
        yield calls
    finally:
        (pointnet2_modules.run_sampling,
         iassd_backbone.run_sampling_iassd) = orig


def sampling_segments(method, npoint):
    """[(kind, start, stop)] of one sampling call's picks: 'topk' for
    score ranking (c-fps, ctr_aware, cls), 'ffps', 'sfps', and 'exact' for
    what has no learned input (d-fps, strides, part-wise d-fps)."""
    if "cls" in method or "ctr" in method or method == "c-fps":
        return [("topk", 0, npoint)]
    if method in ("F-FPS", "FFS", "f-fps"):
        return [("ffps", 0, npoint)]
    if method == "FS":
        return [("ffps", 0, npoint), ("exact", npoint, 2 * npoint)]
    if method == "s-fps":
        return [("sfps", 0, npoint)]
    return [("exact", 0, npoint)]


def ffps_parting(xyz, feats, gamma, valid, prefix, p, r):
    """One sample's f-fps step after the picks ``prefix`` (a LongTensor):
    the port's own keys (running minima over its own matrix) of its pick
    ``p`` and of the reference's pick ``r`` → (key gap, the gap that
    :func:`matrix_tolerance` allows for the two matrix entries that hold
    those minima)."""
    import torch

    from de6d_tpu_torch.ops import sampling

    dm = sampling.calc_dist_matrix_for_sampling(
        xyz[None], None if feats is None else feats[None], gamma)[0]
    md, arg = dm[prefix].min(dim=0)
    norm = (xyz * xyz).sum(-1)
    if feats is not None:
        norm = norm + gamma * (feats * feats).sum(-1)
    scale = norm + norm[prefix[arg]]  # |a|² + |b|² of the entry held
    md = torch.where(valid, md, -1.0)
    return float(md[p] - md[r]), float(matrix_tolerance(scale[p] + scale[r]))


def certify_sampling_call(tag, k, call, ref_scores, tol):
    """The k-th sampling call of a forced run: where the port's own picks
    differ from the reference's, each difference must be a near-tie, or
    RuntimeError. Returns the partings.

    * 'exact' segments must be identical.
    * 'ffps' / 'sfps': at a sample's first differing pick the port's key of
      its own pick exceeds its key of the reference's pick by no more than
      the matrix tolerance (:func:`ffps_parting`) or the weights'
      differences (:func:`sfps_parting`) explain.
    * 'topk': the scores that are ranked lie within ``tol`` of the
      reference's (largest difference ``delta``); a position may hold
      another point only where the two points' reference scores lie within
      ``2 * delta`` of each other."""
    import torch

    lo, hi = call["range"]
    hi = call["xyz"].shape[1] if hi == -1 else hi
    xyz, valid = call["xyz"][:, lo:hi].float(), call["valid"][:, lo:hi]
    own, ref = call["own"].long() - lo, call["ref"].long() - lo
    gamma = call["gamma"]

    def weights(scores):
        w = scores[:, lo:hi]
        if w.ndim == 3:  # IA-SSD: per-class logits, the largest ranks
            w = w.amax(dim=-1)
        return torch.sigmoid(w.float()) ** gamma

    partings = []
    for kind, a, z in sampling_segments(call["method"], call["npoint"]):
        differs = own[:, a:z] != ref[:, a:z]
        if not bool(differs.any()):
            continue
        name = f"sampling call {k} ({call['method']}, picks {a}:{z})"
        if kind == "exact":
            raise RuntimeError(f"{tag}: {name} has no learned input and "
                               "differs from the reference")
        if kind == "topk":
            w_port = weights(call["scores"])
            w_ref = weights(torch.as_tensor(ref_scores, device=xyz.device))
            delta = float(torch.where(valid, (w_port - w_ref).abs(),
                                      0.0).max())
            if not delta <= tol:
                raise RuntimeError(f"{tag}: {name}: scores differ by "
                                   f"{delta:.3g} > {tol}")
            w_ref = torch.where(valid, w_ref, -1e10)
            gaps = (torch.gather(w_ref, 1, own[:, a:z])
                    - torch.gather(w_ref, 1, ref[:, a:z])).abs()[differs]
            near = 2 * delta + 1e-7
            if float(gaps.max()) > near:
                raise RuntimeError(f"{tag}: {name}: a position differs "
                                   f"that is no near-tie ({float(gaps.max()):.3g}"
                                   f" > {near:.3g})")
            partings.append({"call": k, "method": call["method"],
                             "positions": int(differs.sum()),
                             "score_gap": float(gaps.max()), "allowed": near})
            continue
        for b in differs.any(dim=1).nonzero().flatten().tolist():
            j = a + int(differs[b].int().argmax())
            p, r = int(own[b, j]), int(ref[b, j])
            if kind == "ffps":
                if j == a:
                    raise RuntimeError(f"{tag}: {name}: the seed differs")
                feats = call["features"]
                feats = None if feats is None else feats[b, lo:hi].float()
                gap, allowed = ffps_parting(xyz[b], feats, gamma, valid[b],
                                            own[b, a:j], p, r)
            else:
                w_ref = weights(torch.as_tensor(ref_scores,
                                                device=xyz.device))
                gap, allowed = sfps_parting(
                    xyz[b], valid[b], weights(call["scores"])[b], w_ref[b],
                    own[b, a:j].tolist(), p, r)
            partings.append({"call": k, "method": call["method"],
                             "sample": b, "pick": j, "port": p, "ref": r,
                             "key_gap": gap, "allowed": allowed})
            print(f"{tag}: sample {b} parts from the reference at {name}, "
                  f"pick {j} (port row {p}, reference row {r}); key gap "
                  f"{gap:.3g}, allowed {allowed:.3g}", flush=True)
            if not 0.0 <= gap <= allowed:
                raise RuntimeError(f"{tag}: {name}: pick {j} of sample {b} "
                                   f"is no near-tie ({gap:.3g} > "
                                   f"{allowed:.3g})")
    return partings


def vote_group_changes(sa, xyz, valid, votes, ref_votes, votes_valid):
    """(B, M) bool: the votes around which the SA module ``sa`` groups
    other points of ``xyz`` than around the reference's votes, both sets
    taken by the port's ball query. A vote differs from the reference's
    by ulps (dense sums in another order), which moves a point that lies
    on one of its spheres in or out."""
    import torch

    from de6d_tpu_torch.ops import ball_query as bq

    scales = list(zip(*sa._scale_tuples()))
    own = bq.ball_query_scales(xyz, votes, scales, valid, votes_valid)
    other = bq.ball_query_scales(xyz, ref_votes, scales, valid, votes_valid)
    changed = torch.zeros_like(votes_valid)
    for (ia, ca), (ib, cb) in zip(own, other):
        changed |= (ia != ib).any(dim=-1) | (ca != cb)
    return changed


def check_point_parity(tag, model, points, mask, post_cfg, nc, ref,
                       tol=PARITY_TOL):
    """A single-stage point detector (3DSSD, 3DSSD-SASA, IA-SSD) against
    the JAX reference ``ref`` (the fixture's arrays), in one forced run
    (:func:`forced_sampling`): without a parting it is the free run.

    1. Every sampling call's picks equal the reference's or part at a
       certified near-tie (:func:`certify_sampling_call`).
    2. The votes (3DSSD: the head's vote coordinates; IA-SSD: the vote
       layer's centres) within ``tol``.
    3. The head's candidates: class scores within ``tol``, boxes within
       ``tol`` (relative above 1) — except a candidate with a point on one
       of its vote's grouping spheres (:func:`vote_group_changes`), whose
       grouped set, and with it its features, may differ; those are
       counted and reported.
    4. Detections of a sample without such a candidate: counts and labels
       equal, boxes and scores within ``tol``. Other samples' detections
       are reported as not compared.
    Returns (the batch dict, a report); raises RuntimeError where a check
    fails."""
    import numpy as np
    import torch

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        post_processing,
    )

    n_calls = sum(k.startswith("picks_") for k in ref)
    with torch.no_grad(), forced_sampling(
            [ref[f"picks_{k}"] for k in range(n_calls)]) as calls:
        out = model({"points": points, "points_mask": mask})
        post = post_processing(out, post_cfg, nc)
    if len(calls) != n_calls:
        raise RuntimeError(f"{tag}: {len(calls)} sampling calls, reference "
                           f"{n_calls}")
    partings = []
    for k, call in enumerate(calls):
        partings += certify_sampling_call(tag, k, call,
                                          ref.get(f"scores_{k}"), tol)

    # the SA module at the votes, and the points it groups
    sa = getattr(model.point_head, "sa_module", None)
    if sa is not None:  # 3DSSD: in the head, over all backbone points
        votes, votes_valid = out["point_vote_coords"], out["point_vote_valid"]
        xyz, valid = out["point_coords"], out["point_valid"]
    else:  # IA-SSD: the backbone's last layer, over its LAYER_INPUT
        backbone = model.backbone_3d
        sa, inp = backbone.sa_modules[-1], backbone.layer_inputs[-1]
        votes, votes_valid = out["centers"], out["centers_valid"]
        xyz, valid = out["encoder_coords"][inp], out["encoder_valid"][inp]
    diffs = {"vote_coords": close_to(tag, "vote coordinates",
                                     votes.cpu().numpy(), ref["vote_coords"],
                                     tol)}
    moved = vote_group_changes(
        sa, xyz, valid, votes,
        torch.as_tensor(ref["vote_coords"], device=votes.device),
        votes_valid).cpu().numpy()
    held = ~moved
    diffs["cand_scores"] = close_to(
        tag, "candidate scores",
        torch.sigmoid(out["batch_cls_preds"]).cpu().numpy()[held],
        ref["cand_scores"][held], tol)
    diffs["cand_boxes"] = close_to(
        tag, "candidate boxes", out["batch_box_preds"].cpu().numpy()[held],
        ref["cand_boxes"][held], tol)
    diffs.update(pred_boxes=0.0, pred_scores=0.0)
    got = {k: v.cpu().numpy() for k, v in post.items()}
    skipped = []
    for b, c in enumerate(ref["pred_count"].tolist()):
        if moved[b].any():
            skipped.append(b)
            continue
        if int(got["pred_count"][b]) != c:
            raise RuntimeError(f"{tag}: counts {got['pred_count']} vs "
                               f"{ref['pred_count']}")
        if not np.array_equal(got["pred_labels"][b, :c],
                              ref["pred_labels"][b, :c]):
            raise RuntimeError(f"{tag}: labels of scan {b} differ")
        for k in ("pred_boxes", "pred_scores"):
            diffs[k] = max(diffs[k], close_to(
                tag, k, got[k][b, :c], ref[k][b, :c], tol, f" of scan {b}"))
    return out, {
        "counts": got["pred_count"].tolist(), "max_abs_diff": diffs,
        "sampling_calls": [c["method"] for c in calls],
        "picks_differing": [int((c["own"] != c["ref"]).sum()) for c in calls],
        "partings": partings,
        "candidates_on_a_sphere": moved.sum(-1).tolist(),
        "detections_not_compared": skipped,
    }


def check_matrix_fps(cases, report, variant_ms=()):
    """cases: {label: (dist matrix (B, N, N), valid (B, N), npoint)}; the
    kernel's picks, at the dispatched cluster size and at every other one,
    must equal the plain loop's. Times the kernel and the plain loop; the
    bound is the bytes of the rows these picks read; the latency floor is
    npoint - 1 empty pick rounds of the dispatched variant's shape (the
    pick loop without its dependent row read), beside the first,
    single-block kernel's. Cases in ``variant_ms`` also time every cluster
    size."""
    import torch

    from de6d_tpu_torch.ops.kernels import matrix_fps as mk

    round_ms = argmax_round_ms()
    lines = {}
    for label, (dm, valid, npoint) in cases.items():
        got = mk.matrix_fps(dm, valid, npoint)
        ref, plain_ms = timed(lambda: mk.matrix_fps_plain(dm, valid, npoint))
        if not torch.equal(got, ref):
            bad = (got != ref).nonzero()[0].tolist()
            fail(f"kernels / matrix_fps {label}: picks differ from the "
                 f"plain version, first at (sample, pick) {bad}")
        b, n = valid.shape
        for c in mk.CLUSTER_SIZES:
            other = mk.matrix_fps_cluster(dm, valid, npoint, cluster=c)
            torch.cuda.synchronize()
            if not torch.equal(other, ref):
                bad = (other != ref).nonzero()[0].tolist()
                fail(f"kernels / matrix_fps {label}: cluster {c} picks "
                     f"differ from the plain version, first at {bad}")
        cluster = mk.dispatch(b, n)
        nbytes = mk.bytes_moved(got, n)
        lines[label] = {
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: mk.matrix_fps(dm, valid, npoint), 5),
            "plain_ms": plain_ms,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "bytes": nbytes,
            "cluster": cluster,
            "threads": mk.threads(n, cluster),
            "latency_floor_ms": (npoint - 1) * rounds_floor_ms(
                b, cluster, mk.threads(n, cluster)),
            "latency_floor_single_block_ms": (npoint - 1) * round_ms,
            "shape": f"f-fps ({b}, {n}, {n}) -> {npoint}, "
                     f"{int(valid.sum())} valid",
        }
        ln = lines[label]
        if label in variant_ms:
            ln["variant_ms"] = {
                c: time_ms(lambda: mk.matrix_fps_cluster(
                    dm, valid, npoint, cluster=c), 5)
                for c in mk.CLUSTER_SIZES}
            ln["variant_latency_floor_ms"] = {
                c: (npoint - 1) * rounds_floor_ms(b, c, mk.threads(n, c))
                for c in mk.CLUSTER_SIZES}
        print(f"kernels / matrix_fps {label}: identical picks (every "
              f"cluster size), {ln['shape']}: cluster {cluster} x "
              f"{ln['threads']} threads {ln['ms']:.4f} ms, plain "
              f"{ln['plain_ms']:.1f} ms, bound {ln['bound_ms']:.5f} ms "
              f"({nbytes} bytes), latency floor "
              f"{ln['latency_floor_ms']:.4f} ms (single block "
              f"{ln['latency_floor_single_block_ms']:.4f})"
              + (f", by cluster size {ln['variant_ms']}, floors "
                 f"{ln['variant_latency_floor_ms']}"
                 if "variant_ms" in ln else ""), flush=True)
    report["matrix_fps_round_ms"] = round_ms
    return lines


def phase_ssd3d_kernels(report):
    """The f-fps kernel at the served 3DSSD model's shapes and inputs (the
    real xyz-plus-feature matrices of SA2 and SA3) and at ragged shapes;
    the matrix against float64; what the seeded weights give."""
    import numpy as np
    import torch

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        post_processing, select_candidates,
    )
    from de6d_tpu_torch.ops import sampling
    from de6d_tpu_torch.ops.nms import NEG_INF

    model, mc, nc = build_model("bfloat16", "cuda", SSD3D_CFG, SSD3D_SEED)
    sa_cfg = mc["BACKBONE_3D"]["SA_CONFIG"]
    gamma = float(sa_cfg.get("WEIGHT_GAMMA", 1.0))
    pts, mask = load_ssd3d_scans()
    points = torch.from_numpy(pts).cuda()
    valid = torch.from_numpy(mask).cuda()
    levels = []  # each SA layer's (xyz, features, scores, valid, picks)
    hooks = [sa.register_forward_hook(lambda m, a, o: levels.append(o))
             for sa in model.backbone_3d.sa_modules]
    with torch.no_grad():
        out = model({"points": points, "points_mask": valid})
        post = post_processing(out, mc["POST_PROCESSING"], nc)
    for h in hooks:
        h.remove()

    # SA2 samples all of SA1's points, SA3's f-fps the first 512 of SA2's
    (_, hi3), _ = sa_cfg["SAMPLE_RANGE_LIST"][2]
    dm2 = sampling.calc_dist_matrix_for_sampling(levels[0][0], levels[0][1],
                                                 gamma)
    dm3 = sampling.calc_dist_matrix_for_sampling(
        levels[1][0][:, :hi3], levels[1][1][:, :hi3], gamma)
    xyz64, f64 = levels[0][0][0].double(), levels[0][1][0].double()
    n_x, n_f = (xyz64 * xyz64).sum(-1), (f64 * f64).sum(-1)
    exact = ((n_x[:, None] + n_x[None] - 2 * xyz64 @ xyz64.t()).clamp(min=0)
             + gamma * (n_f[:, None] + n_f[None]
                        - 2 * f64 @ f64.t()).clamp(min=0))
    norm = n_x + gamma * n_f
    err = ((dm2[0].double() - exact).abs()
           / matrix_tolerance(norm[:, None] + norm[None])).max()
    del exact
    if not float(err) <= 1.0:
        fail(f"kernels / matrix_fps: the SA2 distance matrix is {err:.3g} "
             "times its tolerance away from float64")
    print(f"kernels / matrix_fps: SA2 distance matrix {tuple(dm2.shape)} "
          f"within {float(err):.3f} of its tolerance ({MATRIX_RTOL:g} x "
          "(|a|^2 + |b|^2)) of float64", flush=True)

    rng = np.random.RandomState(0)

    def synthetic(b, n, counts, ties=False):
        a = torch.from_numpy(rng.uniform(-40, 70, (b, n, 3)).astype(
            np.float32)).cuda()
        if ties:  # a lattice: many exactly equal distances
            a = a.round()
        f = torch.from_numpy(np.abs(rng.normal(0, 1, (b, n, 16))).astype(
            np.float32)).cuda()
        v = (torch.arange(n, device="cuda")[None]
             < torch.tensor(counts, device="cuda")[:, None])
        return sampling.calc_dist_matrix_for_sampling(
            a, None if ties else f), v

    def slice_ties(b, n):
        """Small integers (exact ties in every CTA's slice) with the seed
        row's maximum planted on both sides of the slice boundaries of
        clusters of 16, 8 and 4 at N = 4096."""
        dm = rng.randint(0, 4, (b, n, n)).astype(np.float32)
        cols = [255, 256, 511, 512, 1023, 1024]
        dm[:, 0, cols] = dm[:, cols, 0] = 9.0
        dm[:, np.arange(n), np.arange(n)] = 0.0
        v = torch.ones(b, n, dtype=torch.bool, device="cuda")
        return torch.from_numpy(dm).cuda(), v

    cases = {
        "sa2_ffps": (dm2, levels[0][3], int(sa_cfg["NPOINT_LIST"][1][0])),
        "sa3_ffps": (dm3, levels[1][3][:, :hi3].contiguous(),
                     int(sa_cfg["NPOINT_LIST"][2][0])),
        # N not a multiple of 32, a ragged mask, fewer valid points than
        # picks, no valid point
        "ragged_1000": synthetic(4, 1000, [1000, 700, 100, 0]) + (333,),
        "ties_2047": synthetic(2, 2047, [2047, 1500], ties=True) + (400,),
        "slice_ties_4096": slice_ties(2, 4096) + (512,),
        "n4095": synthetic(2, 4095, [4095, 3000]) + (512,),
        "n5000": synthetic(2, 5000, [5000, 4097]) + (128,),
        "n9000": synthetic(1, 9000, [8500]) + (64,),
        "n16384": synthetic(2, 16384, [16384, 100]) + (64,),
        "n1": synthetic(3, 1, [1, 0, 1]) + (5,),
    }
    lines = check_matrix_fps(cases, report,
                             variant_ms=("sa2_ffps", "sa3_ffps"))
    if lines["slice_ties_4096"]["cluster"] < 2:
        fail("kernels / matrix_fps: 2 x 4096 did not run on a cluster")
    path = [lines["sa2_ffps"], lines["sa3_ffps"]]  # the launches per batch
    report["matrix_fps"] = {
        "name": "matrix_fps",
        "route": "cuda",
        "source": "de6d_tpu_torch/csrc/matrix_fps.cu",
        "replaces": "de6d_tpu/ops/pallas/fps.py:251",
        "max_abs_err": 0.0,
        **{k: sum(ln[k] for ln in path) for k in (
            "ms", "plain_ms", "bound_ms", "latency_floor_ms",
            "latency_floor_single_block_ms")},
        "bound_by": "bytes",
        "library_ms": None,
        "dispatched_clusters": [ln["cluster"] for ln in path],
        "matrix_error_over_tolerance": float(err),
        "cases": lines,
    }
    del dm2, dm3, cases

    fps_lines = check_fps({
        "ssd3d_sa1_dfps": (points[..., :3].contiguous(), valid,
                           int(sa_cfg["NPOINT_LIST"][0][0]), None),
        "ssd3d_sa3_dfps": (levels[1][0], levels[1][3],
                           int(sa_cfg["NPOINT_LIST"][2][1]), None),
    }, report)
    report["fps"]["cases"].update(fps_lines)
    report["fps"]["ssd3d_ms_per_batch"] = sum(
        ln["ms"] for ln in fps_lines.values())

    # what the seed gives: votes, candidates, detections
    lim = model.point_head.max_translation
    offsets = out["point_vote_coords"] - out["point_candidate_coords"]
    clamped = float(((offsets.abs() >= lim * (1 - 1e-6))
                     & out["point_vote_valid"][..., None]).float().mean())
    boxes, scores, _ = select_candidates(out, mc["POST_PROCESSING"])
    counts = (scores > NEG_INF / 2).sum(-1).to(torch.int32)
    nms_cfg = mc["POST_PROCESSING"]["NMS_CONFIG"]
    report["nms"]["cases"].update(check_nms(
        {"ssd3d": (boxes.contiguous(), counts)}, float(nms_cfg["NMS_THRESH"]),
        min(int(nms_cfg["NMS_POST_MAXSIZE"]), boxes.shape[1])))
    live = counts.tolist()
    kept = post["pred_count"].tolist()
    sizes = out["batch_box_preds"][..., 3:6]
    report["ssd3d_seeded"] = {
        "vote_components_clamped": clamped, "candidates_live": live,
        "detections": kept,
        "box_size_range": [float(sizes.min()), float(sizes.max())]}
    print(f"kernels / matrix_fps: seeded 3DSSD: {clamped:.1%} of the vote "
          f"components clamped, live candidates {live}, detections {kept}, "
          f"box sizes {float(sizes.min()):.3g}..{float(sizes.max()):.3g} m",
          flush=True)
    if not (clamped < 0.5 and 0 < sum(kept) < sum(live)):
        fail("kernels / matrix_fps: the seeded 3DSSD weights give a trivial "
             "head (votes clamped, or an NMS that keeps all or nothing)")
    return model, mc


def phase_point_parity(tag, cfg_path, seed, ref_path, report):
    """fp32 (TF32 off) on 2 scans with seeded weights against the stored
    JAX reference (:func:`check_point_parity`)."""
    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, mc, nc = build_model("float32", "cuda", cfg_path, seed)
    pts, mask = load_ssd3d_scans()
    try:
        _, res = check_point_parity(
            tag, model, torch.from_numpy(pts[:2]).cuda(),
            torch.from_numpy(mask[:2]).cuda(), mc["POST_PROCESSING"], nc,
            dict(np.load(ref_path)))
    except RuntimeError as e:
        fail(str(e))
    report[tag.replace(" / ", "_")] = res
    d = res["max_abs_diff"]
    print(f"{tag}: fp32 (TF32 off) on 2 scans matches the JAX reference: "
          f"sampling calls {res['sampling_calls']}, picks differing "
          f"{res['picks_differing']} ({len(res['partings'])} partings, each "
          f"a certified near-tie), candidates with a point on a grouping "
          f"sphere {res['candidates_on_a_sphere']}, detections not compared "
          f"for samples {res['detections_not_compared']}, counts "
          f"{res['counts']}, max |d| vote {d['vote_coords']:.3g}, "
          f"candidate score {d['cand_scores']:.3g}, candidate box "
          f"{d['cand_boxes']:.3g}, box {d['pred_boxes']:.3g}, score "
          f"{d['pred_scores']:.3g} (tol {PARITY_TOL})", flush=True)


# ---------------------------------------------------------------------
# SECOND: lookup and sparse-conv kernels, serve, parity
# ---------------------------------------------------------------------

def second_stage_keys(out):
    """The sparse backbone's sorted site keys per stage, x_conv1..x_conv4
    and the output of the (3, 1, 1) z-conv: five (B, V_s) int32 tensors."""
    ms = out["multi_scale_3d_features"]
    return [ms[f"x_conv{s}"][1] for s in range(1, 5)] + [
        out["encoded_spconv_keys"]]


@contextlib.contextmanager
def recorded_sparse_calls():
    """Within the block every neighbour-table and sparse-conv call of
    ``de6d_tpu_torch.ops.sparse`` is recorded with its inputs (args,
    kwargs), in call order, and then run as usual."""
    from de6d_tpu_torch.ops import sparse as sp

    calls = {"neighbor_table": [], "sparse_conv": []}
    orig = (sp.neighbor_table, sp.sparse_conv)

    def table(*args, **kwargs):
        calls["neighbor_table"].append((args, kwargs))
        return orig[0](*args, **kwargs)

    def conv(*args, **kwargs):
        calls["sparse_conv"].append((args, kwargs))
        return orig[1](*args, **kwargs)

    sp.neighbor_table, sp.sparse_conv = table, conv
    try:
        yield calls
    finally:
        sp.neighbor_table, sp.sparse_conv = orig


# the backbone's calls in order: a stage's submanifold table, then the
# strided layer into the next stage
SECOND_LOOKUPS = ("subm_s1", "down_s2", "subm_s2", "down_s3", "subm_s3",
                  "down_s4", "subm_s4", "down_z")
SECOND_CONVS = ("subm_s1_in", "subm_s1", "down_s2", "subm_s2a", "subm_s2b",
                "down_s3", "subm_s3a", "subm_s3b", "down_s4", "subm_s4a",
                "subm_s4b", "down_z")
BF16_FLOPS = 989e12  # H100 SXM data sheet, dense tensor cores
# fp32 sums of up to 27 x 64 products in another order; bf16 outputs are
# one rounding of an fp32 sum, so an order change can move one bf16 ulp
# (2^-7 relative)
CONV_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# the 12 served layers with the first tensor-core kernel (one block per 64
# rows walking the offsets in turn), for comparison in the printout
EARLIER_CONV_MS = 1.4042


def check_lookup(cases):
    """cases: {label: (tables (B, V), queries (B, Q))} → a result line per
    case. ``hit`` and ``idx`` must equal the plain version's everywhere
    (the kernel returns searchsorted's clipped insertion point on a miss,
    so idx agrees on misses too, not only on hits)."""
    import torch

    from de6d_tpu_torch.ops.kernels import lookup as lk

    lines = {}
    for label, (table, queries) in cases.items():
        idx, hit = lk.lookup(table, queries)
        ridx, rhit = lk.lookup_plain(table, queries)
        torch.cuda.synchronize()
        if not (torch.equal(hit, rhit) and torch.equal(idx, ridx)):
            bad = (hit != rhit) | (idx != ridx)
            fail(f"kernels / lookup {label}: differs from the plain version "
                 f"at (sample, query) {bad.nonzero()[0].tolist()}")
        b, v = table.shape
        nbytes = lk.bytes_moved(v, queries)
        lines[label] = {
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: lk.lookup(table, queries), 20),
            "device_ms": graph_ms(lambda: lk.lookup(table, queries)),
            "plain_ms": time_ms(lambda: lk.lookup_plain(table, queries), 5),
            "library_ms": time_ms(lambda: torch.searchsorted(
                table, queries, out_int32=True), 5),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "bytes": nbytes,
            "hits": int(hit.sum()),
            "shape": f"tables ({b}, {v}), queries {tuple(queries.shape)}",
        }
        ln = lines[label]
        print(f"kernels / lookup {label}: hit and idx identical, "
              f"{ln['shape']}, {ln['hits']} hits: {ln['ms']:.4f} ms (device "
              f"{ln['device_ms']:.4f}), plain "
              f"{ln['plain_ms']:.4f} ms, searchsorted {ln['library_ms']:.4f}"
              f" ms, bound {ln['bound_ms']:.5f} ms ({nbytes} bytes)",
              flush=True)
    return lines


def check_neighbor_tables(cases):
    """cases: {label: (args, kwargs) of ``neighbor_table``} → a result line
    per case: ``idx`` and ``hit`` equal to ``neighbor_table_plain``'s
    everywhere (misses, out-of-grid neighbours, INVALID rows); ms, the
    plain version's (the composed path it replaces: torch key generation
    and ``lookup_plain``), the library yardstick (the same key generation
    and one ``torch.searchsorted``), the bytes bound."""
    import torch

    from de6d_tpu_torch.ops.kernels import lookup as lk

    lines = {}
    for label, (args, kwargs) in cases.items():
        idx, hit = lk.neighbor_table(*args, **kwargs)
        ridx, rhit = lk.neighbor_table_plain(*args, **kwargs)
        torch.cuda.synchronize()
        if not (torch.equal(hit, rhit) and torch.equal(idx, ridx)):
            bad = (hit != rhit) | (idx != ridx)
            fail(f"kernels / neighbor_table {label}: differs from the plain "
                 f"version at (sample, row, offset) "
                 f"{bad.nonzero()[0].tolist()}")
        table, ask = args[0], args[1]
        b, q, k = idx.shape
        nbytes = lk.neighbor_bytes(table, ask, k)

        def library():
            nbr = lk.neighbor_keys_plain(ask, *args[2:], **kwargs)
            return torch.searchsorted(table, nbr.reshape(b, -1),
                                      out_int32=True)

        lines[label] = {
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: lk.neighbor_table(*args, **kwargs), 20),
            "device_ms": graph_ms(lambda: lk.neighbor_table(*args, **kwargs)),
            "plain_ms": time_ms(lambda: lk.neighbor_table_plain(
                *args, **kwargs), 5),
            "library_ms": time_ms(library, 5),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "bytes": nbytes,
            "hits": int(hit.sum()),
            "invalid_queries": int((lk.neighbor_keys_plain(
                ask, *args[2:], **kwargs) == lk.INVALID).sum()),
            "shape": f"tables {tuple(table.shape)}, asking {tuple(ask.shape)}"
                     f", K {k}",
        }
        ln = lines[label]
        print(f"kernels / neighbor_table {label}: hit and idx identical, "
              f"{ln['shape']}, {ln['hits']} hits, {ln['invalid_queries']} "
              f"INVALID queries: {ln['ms']:.4f} ms (device "
              f"{ln['device_ms']:.4f}), plain "
              f"{ln['plain_ms']:.4f} ms, keys + searchsorted "
              f"{ln['library_ms']:.4f} ms, bound {ln['bound_ms']:.5f} ms",
              flush=True)
    return lines


def face_sites(grid, v, n, seed):
    """(8, v) sorted keys of ``grid``: a site on every face, edge and
    corner, the rest random cells near them, INVALID after ``n``; sample 0
    has no site."""
    import numpy as np
    import torch

    from de6d_tpu_torch.ops import sparse

    nz, ny, nx = grid
    rng = np.random.RandomState(seed)
    face = {(z * ny + y) * nx + x for z in (0, nz // 2, nz - 1)
            for y in (0, ny // 2, ny - 1) for x in (0, nx // 2, nx - 1)}
    keys = np.full((8, v), sparse.INVALID, np.int32)
    for b in range(1, 8):
        cells = set(face)
        while len(cells) < n:
            c = rng.randint(0, (nz, ny, nx))
            p = np.clip(c + rng.randint(-1, 2, (20, 3)), 0,
                        np.array(grid) - 1)
            cells.update(((p[:, 0] * ny + p[:, 1]) * nx + p[:, 2]).tolist())
        rest = np.array(sorted(cells - face), np.int64)
        keys[b, :n] = np.sort(np.concatenate(
            [sorted(face), rng.choice(rest, n - len(face), replace=False)]))
    return torch.from_numpy(keys).cuda()


def check_sparse_conv(cases, variant_ms=()):
    """cases: {label: (features, idx, hit, weights, valid)} → a result line
    per case: the dispatched kernel, which must launch the variant of
    ``sparse_conv.plan``, and every other variant that takes the shape,
    each within ``CONV_TOL`` (absolute + relative to the plain value) of
    the plain version on the same inputs; timings, the bound from the hits
    of these inputs, and the dense product's count. Cases in
    ``variant_ms`` also time every variant."""
    import torch

    from de6d_tpu_torch.ops.kernels import sparse_conv as sc

    lines = {}
    for label, args in cases.items():
        f, idx, hit, w, valid = args
        b, q, k = idx.shape
        cin, cout = w.shape[1:]
        got = sc.sparse_conv(*args)
        variant = sc.launched_variant()
        ref = sc.sparse_conv_plain(*args).float()
        torch.cuda.synchronize()
        if variant != sc.plan(cin, cout, k, f.dtype).variant:
            fail(f"kernels / sparse_conv {label}: launched {variant}, the "
                 f"plan says {sc.plan(cin, cout, k, f.dtype)}")
        tol = CONV_TOL[str(f.dtype).split(".")[-1]]
        names = [n for n in sc.VARIANTS
                 if sc.plan(cin, cout, k, f.dtype, n) is not None]
        err = 0.0
        for name, out in [(variant, got)] + [
                (n, sc.sparse_conv_variant(*args, variant=n))
                for n in names if n != variant]:
            torch.cuda.synchronize()
            d = (out.float() - ref).abs()
            if not float((d - tol * (1 + ref.abs())).max()) <= 0:
                fail(f"kernels / sparse_conv {label}: variant {name} differs"
                     f" from the plain version by {float(d.max()):.3g} (tol "
                     f"{tol} abs + rel)")
            err = max(err, float(d.max()))
        nbytes, ops = sc.work(*args)
        peak = BF16_FLOPS if f.dtype == torch.bfloat16 else FP32_FLOPS
        t_ops, t_bytes = ops / peak, nbytes / HBM_BYTES_PER_S
        dense = 2 * b * q * k * cin * cout
        lines[label] = {
            "max_abs_err": err,
            "variant": variant,
            "variants_checked": names,
            "ms": time_ms(lambda: sc.sparse_conv(*args), 10),
            "plain_ms": time_ms(lambda: sc.sparse_conv_plain(*args), 3),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bytes": nbytes,
            "flops_hits": ops,
            "flops_dense_at_caps": dense,
            "bound_dense_at_caps_ms": max(dense / peak, t_bytes) * 1e3,
            "valid_rows": valid.sum(-1).tolist(),
            "hits_per_valid_row": ops / (2 * cin * cout)
            / max(1, int(valid.sum())),
            "shape": f"{str(f.dtype).split('.')[-1]} feats {tuple(f.shape)}, "
                     f"table ({b}, {q}, {k}), W ({k}, {cin}, {cout})",
        }
        ln = lines[label]
        if label in variant_ms:
            ln["variant_ms"] = {n: time_ms(lambda: sc.sparse_conv_variant(
                *args, variant=n), 10) for n in names}
        print(f"kernels / sparse_conv {label}: {variant} (checked "
              f"{'/'.join(names)}) within {tol} of plain (max |d| "
              f"{err:.3g}), {ln['shape']}, "
              f"{ln['hits_per_valid_row']:.2f} hits/row: {ln['ms']:.4f} ms"
              + (f" {ln['variant_ms']}" if "variant_ms" in ln else "")
              + f", plain {ln['plain_ms']:.3f} ms, bound "
              f"{ln['bound_ms']:.5f} ms ({ln['bound_by']}), dense at caps "
              f"{ln['bound_dense_at_caps_ms']:.5f} ms", flush=True)
    return lines


def phase_second_kernels(report):
    """``neighbor_table``, ``lookup`` and ``sparse_conv`` at the served
    SECOND model's shapes and inputs (recorded from one bf16 forward of
    the 8 scans), and the edge cases: sites on every grid face, INVALID
    rows inside, an empty sample, an empty table, all-INVALID queries,
    queries outside the keys, tables of 40,000 and 120,000 keys; fp32
    layers, Cin = 48 and Cout = 40; the fused NMS on SECOND's candidates."""
    import numpy as np
    import torch

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        select_candidates,
    )
    from de6d_tpu_torch.ops import sparse
    from de6d_tpu_torch.ops.kernels import lookup as lk
    from de6d_tpu_torch.ops.nms import CASCADE_K0, NEG_INF

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    model, mc, nc = build_model("bfloat16", "cuda", SECOND_CFG, SECOND_PARAMS)
    pts, mask = load_second_scans()
    with torch.no_grad(), recorded_sparse_calls() as calls:
        out = model({"points": torch.from_numpy(pts).cuda(),
                     "points_mask": torch.from_numpy(mask).cuda()})
    if (len(calls["neighbor_table"]), len(calls["sparse_conv"])) != (8, 12):
        fail(f"kernels / second: {len(calls['neighbor_table'])} neighbour "
             f"tables and {len(calls['sparse_conv'])} convs in one forward, "
             "expected 8 and 12")
    keys = second_stage_keys(out)
    sites = [(k != sparse.INVALID).sum(-1).tolist() for k in keys]
    # how many active outputs each strided layer finds before its cap
    uncapped = []
    for (k_in, grid), layer in zip(
            [(ms[1], ms[2]) for ms in out["multi_scale_3d_features"].values()],
            (model.backbone_3d.SparseDownLayer_0,
             model.backbone_3d.SparseDownLayer_1,
             model.backbone_3d.SparseDownLayer_2,
             model.backbone_3d.SparseDownLayer_3)):
        full, _ = sparse.downsample_coords(
            k_in, grid, layer.stride, layer.padding,
            8 * k_in.shape[1], layer.kernel)
        uncapped.append((full != sparse.INVALID).sum(-1).tolist())
    report["second_sites"] = {"per_stage": sites,
                              "strided_outputs_before_cap": uncapped}
    print(f"kernels / second: active sites per stage (x_conv1..4, z-conv) "
          f"{sites}; strided outputs before the caps {uncapped}", flush=True)

    tables = dict(zip(SECOND_LOOKUPS, calls["neighbor_table"]))
    (t1, _, g1, *_), _ = tables["subm_s1"]
    drop = torch.from_numpy(np.random.RandomState(1).rand(*t1.shape)
                            < 0.3).cuda()
    face1 = face_sites(g1, t1.shape[1], 12000, 2)
    face_z = face_sites((5, 200, 176), 4000, 3000, 3)
    empty_sample = t1.clone()
    empty_sample[0] = sparse.INVALID
    nbr_cases = dict(tables)
    nbr_cases.update({
        "faces_subm": ((face1, face1, g1, g1, (3, 3, 3)), {}),
        "faces_down_s2": ((face1, face_sites((21, 800, 704), 16000, 9000,
                                             4), g1, (21, 800, 704),
                           (3, 3, 3), (2, 2, 2), (1, 1, 1), False), {}),
        "faces_down_z": ((face_z, face_sites((2, 200, 176), 4000, 2000, 5),
                          (5, 200, 176), (2, 200, 176), (3, 1, 1),
                          (2, 1, 1), (0, 0, 0), False), {}),
        "invalid_rows": ((t1, torch.where(drop, sparse.INVALID, t1), g1, g1,
                          (3, 3, 3)), {}),
        "empty_sample": ((empty_sample, empty_sample, g1, g1, (3, 3, 3)), {}),
    })
    lines = check_neighbor_tables(nbr_cases)
    if lines["empty_sample"]["hits"] >= lines["subm_s1"]["hits"]:
        fail("kernels / neighbor_table: the empty sample found neighbours")
    path = [lines[k] for k in SECOND_LOOKUPS]
    report["neighbor_table"] = {
        "name": "neighbor_table",
        "route": "cuda",
        "source": "de6d_tpu_torch/csrc/lookup.cu",
        "replaces": "de6d_tpu/ops/pallas/lookup.py:80",
        "max_abs_err": 0.0,
        # per served batch: the 8 launches
        **{k: sum(ln[k] for ln in path) for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": "bytes",
        "stage1_subm": {k: lines["subm_s1"][k] for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms")},
        "cases": lines,
    }

    # the standalone lookup on the same tables' neighbour keys
    look = {k: (a[0], lk.neighbor_keys_plain(a[1], *a[2:], **kw).reshape(
        a[1].shape[0], -1).contiguous()) for k, (a, kw) in tables.items()}
    q1 = look["subm_s1"][1]
    rng = np.random.RandomState(0)

    def synthetic(v, q):
        tables = np.full((8, v), sparse.INVALID, np.int32)
        queries = np.empty((8, q), np.int32)
        for b in range(8):
            u = np.unique(rng.randint(0, 41 * 1600 * 1408, v + v // 8))[:v]
            tables[b, :len(u)] = u
            queries[b] = np.where(rng.random_sample(q) < 0.5,
                                  u[rng.randint(0, len(u), q)],
                                  rng.randint(0, 41 * 1600 * 1408, q))
        return torch.from_numpy(tables).cuda(), torch.from_numpy(
            queries).cuda()

    first, last = t1[:, :1], t1.gather(1, (t1 != sparse.INVALID).sum(
        1, keepdim=True).clamp(min=1) - 1)
    ar = torch.arange(2048, device=t1.device, dtype=torch.int32)
    outside = torch.cat([first - 1 - ar, last + 1 + ar,
                         torch.full_like(first, sparse.INVALID - 1)], dim=1)
    cases = dict(look)
    cases.update({
        "empty_table": (torch.full_like(t1, sparse.INVALID), q1),
        "invalid_queries": (t1, torch.full_like(q1, sparse.INVALID)),
        "outside_the_keys": (t1, outside.contiguous()),
        # windows of random queries outgrow shared memory: the
        # device-memory search
        "v40000": synthetic(40000, 27 * 40000 // 8),
        "v120000": synthetic(120000, 27 * 120000 // 8),
    })
    lines = check_lookup({k: (t.contiguous(), q.contiguous())
                          for k, (t, q) in cases.items()})
    if lines["empty_table"]["hits"] or lines["invalid_queries"]["hits"] or (
            lines["outside_the_keys"]["hits"]):
        fail("kernels / lookup: hits where none can be")
    path = [lines[k] for k in SECOND_LOOKUPS]
    report["lookup"] = {
        "name": "lookup",
        "route": "cuda",
        "source": "de6d_tpu_torch/csrc/lookup.cu",
        "replaces": "de6d_tpu/ops/pallas/lookup.py:80",
        "max_abs_err": 0.0,
        # the 8 served tables' neighbour keys (no launch on the served
        # path since the neighbour table generates its keys)
        **{k: sum(ln[k] for ln in path) for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms")},
        "bound_by": "bytes",
        "stage1": {k: lines["subm_s1"][k] for k in (
            "ms", "device_ms", "plain_ms", "library_ms", "bound_ms")},
        "cases": lines,
    }
    n, lo = report["neighbor_table"], report["lookup"]
    print(f"kernels / lookup: per served batch (8 tables) neighbor_table "
          f"{n['ms']:.4f} ms (device {n['device_ms']:.4f} ms; composed "
          f"plain path {n['plain_ms']:.4f} ms, "
          f"keys + searchsorted {n['library_ms']:.4f} ms, bound "
          f"{n['bound_ms']:.5f} ms); lookup on the same keys "
          f"{lo['ms']:.4f} ms (device {lo['device_ms']:.4f} ms; "
          f"searchsorted {lo['library_ms']:.4f} ms, "
          f"bound {lo['bound_ms']:.5f} ms)", flush=True)

    # the fused NMS on SECOND's candidates, the cascade's 1024 prefix
    post_cfg = mc["POST_PROCESSING"]
    boxes, scores, _ = select_candidates(out, post_cfg)
    counts = (scores > NEG_INF / 2).sum(-1).to(torch.int32)
    nms_cfg = post_cfg["NMS_CONFIG"]
    report["nms"]["cases"].update(check_nms(
        {"second_prefix": (boxes[:, :CASCADE_K0].contiguous(),
                           counts.clamp(max=CASCADE_K0))},
        float(nms_cfg["NMS_THRESH"]), int(nms_cfg["NMS_POST_MAXSIZE"])))

    convs = dict(zip(SECOND_CONVS, (a for a, _ in calls["sparse_conv"])))
    f3, i3, h3, w3, v3 = convs["subm_s3a"]

    def weights(k, cin, cout):
        return torch.from_numpy((rng.randn(k, cin, cout) / np.sqrt(
            k * cin)).astype(np.float32)).cuda()

    def feats(cin):
        return torch.from_numpy(rng.randn(*f3.shape[:2], cin).astype(
            np.float32)).cuda()

    w48, f48 = weights(27, 48, 40), feats(48)
    # the first 128-row tile of every sample without a hit, the second
    # with one
    h_edge, i_edge = h3.clone(), i3.clone()
    h_edge[:, :256] = False
    h_edge[:, 130, 13] = True
    i_edge[:, 130, 13] = 0
    i_rand = torch.from_numpy(rng.randint(0, f3.shape[1], i3.shape).astype(
        np.int32)).cuda()
    h_rand = torch.from_numpy(rng.random_sample(i3.shape) < 0.2).cuda()
    cases = dict(convs)
    cases.update({f"{k}_fp32": tuple(
        a.float() if a.is_floating_point() else a for a in convs[k])
        for k in SECOND_CONVS})
    cases.update({
        "cin48_cout40_fp32": (f48, i3, h3, w48, v3),
        "cin48_cout40_bf16": (f48.bfloat16(), i3, h3, w48.bfloat16(), v3),
        "cin1_cout1_k5_bf16": (feats(1).bfloat16(), i3[..., :5].contiguous(),
                               h3[..., :5].contiguous(),
                               weights(5, 1, 1).bfloat16(), v3),
        "cin64_cout128_k27_bf16": (f3, i3, h3,
                                   weights(27, 64, 128).bfloat16(), v3),
        "no_hit_and_one_hit_tiles_bf16": (f3, i_edge, h_edge, w3, v3),
        "random_table_bf16": (f3, i_rand, h_rand, w3, v3),
    })
    lines = check_sparse_conv(cases, variant_ms=SECOND_CONVS)
    path = [lines[k] for k in SECOND_CONVS]
    report["sparse_conv"] = {
        "name": "sparse_conv",
        "route": "cuda",
        "source": "de6d_tpu_torch/csrc/sparse_conv.cu",
        "replaces": "de6d_tpu/ops/pallas/sparse_gather.py:161",
        "max_abs_err": max(ln["max_abs_err"] for ln in path),
        # per served batch: the 12 bf16 layers
        **{k: sum(ln[k] for ln in path) for k in (
            "ms", "plain_ms", "bound_ms", "bound_dense_at_caps_ms")},
        "bound_by": "bytes" if all(ln["bound_by"] == "bytes" for ln in path)
        else "operations",
        "library_ms": None,
        "variants_by_layer": {k: lines[k]["variant"] for k in SECOND_CONVS},
        "cases": lines,
    }
    r = report["sparse_conv"]
    print(f"kernels / sparse_conv: per served batch (12 bf16 layers) "
          f"{r['ms']:.4f} ms (the earlier mma.sync kernel: "
          f"{EARLIER_CONV_MS} ms on an H100 80GB HBM3 at 700 W, PERF.md), "
          f"plain {r['plain_ms']:.3f} ms, bound "
          f"{r['bound_ms']:.5f} ms at the scans' sites, "
          f"{r['bound_dense_at_caps_ms']:.5f} ms dense at the caps",
          flush=True)
    del calls, cases, look, convs, tables, nbr_cases
    return model, mc, nc


def phase_second_parity(report):
    import numpy as np
    import torch

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        post_processing,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, mc, nc = build_model("float32", "cuda", SECOND_CFG, SECOND_PARAMS)
    pts, mask = load_second_scans()
    with torch.no_grad():
        out = model({"points": torch.from_numpy(pts[:2]).cuda(),
                     "points_mask": torch.from_numpy(mask[:2]).cuda()})
        post = post_processing(out, mc["POST_PROCESSING"], nc)
    try:
        res = check_second_parity(out, post, dict(np.load(SECOND_REF)),
                                  mc["POST_PROCESSING"])
    except RuntimeError as e:
        fail(str(e))
    report["parity_second"] = res
    d = res["max_abs_diff"]
    print(f"parity / second: fp32 (TF32 off) on 2 scans matches the JAX "
          f"reference: stage keys identical (sites {res['stage_sites']}), "
          f"live candidates {res['candidates_live']}, "
          f"{len(res['candidates_swapped'])} swapped at certified near-ties, "
          f"counts {res['counts']}, max |d| candidate score "
          f"{d['cand_scores']:.3g}, candidate box {d['cand_boxes']:.3g}, box "
          f"{d['pred_boxes']:.3g}, score {d['pred_scores']:.3g} (tol "
          f"{PARITY_TOL})", flush=True)


def check_second_parity(out, post, ref, post_cfg, tol=PARITY_TOL):
    """SECOND against the JAX reference ``ref`` (the fixture's arrays).

    1. Every stage's sorted site keys (``keys_1`` .. ``keys_5``) and so its
       active-site count identical.
    2. Candidates (the top ``NMS_PRE_MAXSIZE`` gated scores, the NMS
       input): the same number above ``SCORE_THRESH``; the port's score of
       every reference candidate's anchor within ``tol`` of the
       reference's (the largest difference is ``delta``). A position may
       hold another anchor than the reference's only at a near-tie: the
       port's scores of the two anchors within ``2 * delta`` (fp32 sums
       in another order move scores by ulps). Anchors in both lists:
       boxes within ``tol``, labels equal.
    3. Detections: counts and labels equal, boxes and scores within
       ``tol``.
    "Within ``tol``" is absolute below 1 and relative above.
    Returns a report; raises RuntimeError where a check fails."""
    import numpy as np

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        rank_candidates, select_candidates,
    )
    from de6d_tpu_torch.ops.nms import NEG_INF

    tag = "parity / second"
    stages = []
    for s, keys in enumerate(second_stage_keys(out), start=1):
        got, want = keys.cpu().numpy(), ref[f"keys_{s}"]
        if got.shape != want.shape or not np.array_equal(got, want):
            raise RuntimeError(f"{tag}: stage {s} keys differ from the "
                               "reference")
        stages.append((want != np.iinfo(np.int32).max).sum(-1).tolist())

    masked, labels, top, order = rank_candidates(out, post_cfg)
    boxes, _, cand_labels = select_candidates(out, post_cfg)
    masked, top, order = (t.cpu().numpy() for t in (masked, top, order))
    boxes, cand_labels = boxes.cpu().numpy(), cand_labels.cpu().numpy()
    ref_order = ref["cand_order"].astype(np.int64)
    ref_scores = ref["cand_scores"]
    diffs = {}
    swapped, delta = [], 0.0
    live = (ref_scores > NEG_INF / 2).sum(-1)
    got_live = (top > NEG_INF / 2).sum(-1)
    if not np.array_equal(live, got_live):
        raise RuntimeError(f"{tag}: {got_live.tolist()} candidates above "
                           f"the score gate, reference {live.tolist()}")
    for b, n in enumerate(live.tolist()):
        delta = max(delta, close_to(
            tag, "candidate scores", masked[b, ref_order[b, :n]],
            ref_scores[b, :n], tol, f" of sample {b}"))
    near = 2 * delta + 1e-7
    for b, n in enumerate(live.tolist()):
        for j in np.nonzero(order[b, :n] != ref_order[b, :n])[0].tolist():
            p, r = int(order[b, j]), int(ref_order[b, j])
            gap = abs(float(masked[b, p]) - float(masked[b, r]))
            if gap > near:
                raise RuntimeError(
                    f"{tag}: candidate {j} of sample {b} (port anchor {p}, "
                    f"reference {r}) is no near-tie: score gap {gap:.3g} > "
                    f"{near:.3g}")
            swapped.append({"sample": b, "position": j, "port": p,
                            "ref": r, "score_gap": gap})
        slot = {int(a): j for j, a in enumerate(order[b, :n])}
        pairs = [(slot[int(a)], j) for j, a in enumerate(ref_order[b, :n])
                 if int(a) in slot]
        gi = np.array([g for g, _ in pairs], np.int64)
        ri = np.array([r for _, r in pairs], np.int64)
        diffs["cand_boxes"] = max(diffs.get("cand_boxes", 0.0), close_to(
            tag, "candidate boxes", boxes[b, gi], ref["cand_boxes"][b, ri],
            tol, f" of sample {b}"))
        if not np.array_equal(cand_labels[b, gi], ref["cand_labels"][b, ri]):
            raise RuntimeError(f"{tag}: candidate labels of sample {b} "
                               "differ")
    diffs["cand_scores"] = delta

    got = {k: v.cpu().numpy() for k, v in post.items()}
    if not np.array_equal(got["pred_count"], ref["pred_count"]):
        raise RuntimeError(f"{tag}: counts {got['pred_count']} vs "
                           f"{ref['pred_count']}")
    for k in ("pred_boxes", "pred_scores"):
        diffs[k] = 0.0
    for b, c in enumerate(ref["pred_count"].tolist()):
        if not np.array_equal(got["pred_labels"][b, :c],
                              ref["pred_labels"][b, :c]):
            raise RuntimeError(f"{tag}: labels of scan {b} differ")
        for k in ("pred_boxes", "pred_scores"):
            diffs[k] = max(diffs[k], close_to(tag, k, got[k][b, :c],
                                              ref[k][b, :c], tol))
    return {"counts": got["pred_count"].tolist(), "stage_sites": stages,
            "candidates_live": live.tolist(),
            "candidates_swapped": swapped, "max_abs_diff": diffs}


# ---------------------------------------------------------------------
# SECOND training: the sparse-conv backward, parity, train_model,
# tools/train.py, the eval
# ---------------------------------------------------------------------

SECOND_TRAIN_REF = ROOT / "de6d_tpu_torch/testdata/second_train_jax_ref.npz"
SECOND_EVAL_REF = ROOT / "de6d_tpu_torch/testdata/second_eval_jax_ref.npz"
# a SECOND train step's hand-kernel launches: a table for each stage's
# submanifold layers and for each strided layer; 12 forward convs; the
# data gradient of every conv but conv_input (MeanVFE's output needs
# none), by the forward kernel, the 7 submanifold ones on their own table
# through the mirrored offsets; 12 weight gradients; a transposed table
# for each of the 4 strided layers' data gradients
SECOND_TRAIN_LAUNCHES = {"neighbor_table": 8, "sparse_conv": 12,
                         "sparse_conv_dgrad": 11,
                         "sparse_conv_dgrad_mirrored": 7,
                         "sparse_conv_wgrad": 12, "transposed_table": 4}


class MirroredDgrad:
    """``sparse_conv_dgrad.mirrored`` (the data gradients that ran on their
    own table through the mirrored offsets) read and reset as a
    ``launches`` count, beside the kernels' own."""

    @property
    def launches(self):
        from de6d_tpu_torch.ops.kernels import sparse_conv

        return sparse_conv.sparse_conv_dgrad.mirrored

    @launches.setter
    def launches(self, n):
        from de6d_tpu_torch.ops.kernels import sparse_conv

        sparse_conv.sparse_conv_dgrad.mirrored = n


# the gradients on the card against their plain versions on the same
# inputs, relative to each result's largest |entry|: fp32 sums of up to
# 27 x 64 (data) or 10^5 (weights) products in another order; bf16
# results are one rounding of an fp32 sum (CONV_TOL)
GRAD_TOL = {"float32": 1e-5, "bfloat16": CONV_TOL["bfloat16"]}
# How far an fp32 evaluation of the fixture's full-width SECOND step lies
# from a float64 evaluation of the same step (the port's, every layer in
# float64), the larger of the JAX package's and the port's on the CPU
# (tests/test_torch_second_train.py::test_full_width_gradients_against_
# float64), rounded up: gradients 9.61e-3 of a leaf's largest |entry|
# (JAX 9.60e-3 over the fixture's stored entries, the port 1.01e-3),
# loss terms 7.60e-6 relative (JAX 7.59e-6: the focal loss's fp32 sum over
# 4 x 211,200 anchors; the port 1.41e-7), the gradient norm 9.57e-5
# relative (JAX 9.56e-5; the port 1.30e-6).
SECOND_TRAIN_F64 = {"grad": 9.61e-3, "loss": 7.60e-6, "grad_norm": 9.57e-5}
# Tolerances of the card's fp32 step against the JAX fp32 step: each fp32
# evaluation lies within the distance above of the float64 one (the phase
# checks the card's own distance), so the two lie within twice that of
# each other. BatchNorm statistics at 2e-4 relative + 1e-5 and regression
# targets at 1e-5, as in :data:`TRAIN_TOL`; the losses of 3 Adam steps at
# 1e-4 relative and the parameters after them within the learning rates
# summed, as there.
SECOND_TRAIN_TOL = {**{k: 2 * v for k, v in SECOND_TRAIN_F64.items()},
                    "stats_rtol": 2e-4, "stats_atol": 1e-5,
                    "reg_targets": 1e-5, "losses": 1e-4}


def second_train_batch(dev):
    """The fixture's batch: the JAX loader's first batch of 4 on
    ``data/kitti``'s train split (``second.yaml``, one worker)."""
    import numpy as np
    import torch

    with np.load(SECOND_TRAIN_REF) as ref:
        return {k: torch.from_numpy(ref[k]).to(dev)
                for k in ("points", "points_mask", "gt_boxes")}


def second_opt_cfg():
    from de6d_tpu_torch.config import cfg_from_yaml_file

    return dict(cfg_from_yaml_file(SECOND_CFG).OPTIMIZATION)


@contextlib.contextmanager
def plain_sparse_conv():
    """Within the block the sparse convs of ``de6d_tpu_torch.ops.sparse``
    run their plain version under torch's autograd on any device: the
    float64 reference step on the card, whose kernels take fp32 and bf16
    only."""
    from de6d_tpu_torch.ops import sparse as sp
    from de6d_tpu_torch.ops.kernels.sparse_conv import sparse_conv_plain

    orig = sp.sparse_conv

    def plain(features, idx, hit, weights, valid, transpose=None):
        return sparse_conv_plain(features, idx, hit, weights, valid)

    sp.sparse_conv = plain
    try:
        yield
    finally:
        sp.sparse_conv = orig


def second_model_f64(dev):
    """SECOND with the trained weights, every layer computing in float64
    (the anchors and the assigner's thresholds stay fp32, as the targets
    read them)."""
    import torch

    model = build_model("float32", dev, SECOND_CFG, SECOND_PARAMS)[0]
    model.double()
    for mod in model.modules():
        if isinstance(getattr(mod, "dtype", None), torch.dtype):
            mod.dtype = torch.float64
    head = model.dense_head
    for name in ("anchors", "matched_thr", "unmatched_thr"):
        setattr(head, name, getattr(head, name).float())
    return model


def second_gradients(model, batch):
    """One train-mode forward and backward: (output, gradients as flat
    float64 numpy per parameter, loss terms)."""
    model.train()
    model.zero_grad(set_to_none=True)
    out = model(dict(batch))
    loss, tb = model.get_training_loss(out)
    loss.backward()
    grads = {n: p.grad.detach().double().cpu().numpy().reshape(-1)
             for n, p in model.named_parameters()}
    return out, grads, {k: float(v.detach()) for k, v in tb.items()}


def check_second_train_parity(dev, measure_f64=True, steps=3):
    """SECOND's train step in fp32 from the trained weights on the
    fixture's batch against the JAX step stored in
    ``second_train_jax_ref.npz``: every stage's site keys identical;
    labels identical; regression targets, the loss terms, the gradient
    norm, every gradient (against its leaf's largest |entry|) and the
    ``MaskedBatchNorm`` statistics after the step within
    :data:`SECOND_TRAIN_TOL`; the losses of ``steps`` Adam steps and the
    parameters after them; with ``measure_f64``, this device's own fp32
    step no farther from its float64 step than :data:`SECOND_TRAIN_F64`
    (the tolerances' premise). Returns a report; raises RuntimeError where
    a check fails."""
    import numpy as np

    from de6d_tpu_torch.ops.sparse import INVALID
    from de6d_tpu_torch.train import (
        build_optimizer_and_schedule, create_train_state, make_train_step,
    )

    tol = SECOND_TRAIN_TOL
    tag = "parity / train_second"
    ref = dict(np.load(SECOND_TRAIN_REF))
    batch = second_train_batch(dev)
    model = build_model("float32", dev, SECOND_CFG, SECOND_PARAMS)[0]
    opt, sched = build_optimizer_and_schedule(second_opt_cfg(), model, 1)
    state = create_train_state(model, opt)
    out, grads, metrics = second_gradients(model, batch)
    metrics["grad_norm"] = float(opt.step())
    state.step += 1
    losses = [metrics["loss"]]
    stats = {n: b.cpu().numpy().copy() for n, b in model.named_buffers()
             if "running" in n}
    for s, keys in enumerate(second_stage_keys(out)):
        if not np.array_equal(keys.cpu().numpy(), ref[f"keys_{s + 1}"]):
            raise RuntimeError(f"{tag}: stage {s + 1}'s site keys differ")
    labels = out["box_cls_labels"].reshape(-1).cpu().numpy()
    nz = np.flatnonzero(labels)
    if not (np.array_equal(nz, ref["labels_idx"])
            and np.array_equal(labels[nz], ref["labels_val"])):
        raise RuntimeError(f"{tag}: labels differ ({nz.size} non-zero vs "
                           f"{ref['labels_idx'].size})")
    reg = out["box_reg_targets"].detach().reshape(-1, 7).cpu().numpy()[
        ref["fg_idx"]]
    d_reg = float(np.abs(reg - ref["reg_targets_fg"]).max(initial=0))
    if d_reg > tol["reg_targets"]:
        raise RuntimeError(f"{tag}: regression targets off by {d_reg}")
    rel = {}
    for k, v in metrics.items():
        want = float(ref[f"metric/{k}"])
        rel[k] = abs(v - want) / max(abs(want), 1e-12)
        if rel[k] > tol["grad_norm" if k == "grad_norm" else "loss"]:
            raise RuntimeError(f"{tag}: {k} {v} vs {want} ({rel[k]:.3g} "
                               "relative)")
    grad_err = 0.0
    g32 = {n: g.astype(np.float32) for n, g in grads.items()}
    for name, (err, scale) in leaf_report(ref, "grad", g32,
                                          tol["grad"]).items():
        e = float(err.max(initial=0)) / max(scale, 1e-30)
        if e > tol["grad"]:
            raise RuntimeError(f"{tag}: gradient {name} off by {e:.3g} of "
                               f"its leaf's max {scale}")
        grad_err = max(grad_err, e)
    stat_err = 0.0
    for name, b in stats.items():
        want = ref[f"stats/{name}"]
        if not np.allclose(b, want, rtol=tol["stats_rtol"],
                           atol=tol["stats_atol"]):
            raise RuntimeError(f"{tag}: {name} after the step off by "
                               f"{np.abs(b - want).max()}")
        stat_err = max(stat_err, float(np.abs(b - want).max()))
    step = make_train_step(model, opt)
    for _ in range(steps - 1):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    loss_rel = np.abs(np.asarray(losses) / ref["losses"] - 1)
    if loss_rel.max() > tol["losses"]:
        raise RuntimeError(f"{tag}: losses {losses} vs "
                           f"{ref['losses'].tolist()}")
    params = {n: p.detach().cpu().numpy().reshape(-1)
              for n, p in model.named_parameters()}
    lr_sum = sum(sched(k) for k in range(steps))
    worst = 0.0
    for name, (err, _) in leaf_report(ref, "params3", params).items():
        if err.max(initial=0) > lr_sum:
            raise RuntimeError(f"{tag}: parameters {name} after {steps} "
                               f"steps off by {err.max()} (learning rates "
                               f"summed {lr_sum})")
        worst = max(worst, float(err.max(initial=0)))
    f64 = None
    if measure_f64:
        # the bound's premise: this device's fp32 step lies no farther
        # from the float64 step than the CPU runs did
        fresh = build_model("float32", dev, SECOND_CFG, SECOND_PARAMS)[0]
        _, g32_own, m32 = second_gradients(fresh, batch)
        del fresh
        with plain_sparse_conv():
            _, g64, m64 = second_gradients(second_model_f64(dev), batch)
        f64 = f64_distances(g32_own, m32, g64, m64)
        for k, v in f64.items():
            if v > SECOND_TRAIN_F64[k]:
                raise RuntimeError(
                    f"{tag}: the {k} of this device's fp32 step lies "
                    f"{v:.3g} from the float64 step, more than the CPU "
                    f"runs' {SECOND_TRAIN_F64[k]:.3g} the tolerance rests "
                    "on")
    return {"f64_distance": f64, "labels_nonzero": int(nz.size),
            "positives": int((labels > 0).sum()),
            "stage_sites": [int((k != INVALID).sum())
                            for k in second_stage_keys(out)],
            "max_reg_target_diff": d_reg, "metrics": metrics,
            "metrics_rel_diff": rel, "losses": losses,
            "losses_rel_diff": loss_rel.tolist(),
            "max_grad_diff_of_leaf_max": grad_err,
            "max_batch_stats_diff": stat_err, "params3_max_diff": worst,
            "lr_sum": lr_sum}


def phase_second_train_parity(report):
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        r = check_second_train_parity("cuda")
    except RuntimeError as e:
        fail(str(e))
    report["second_train_parity"] = r
    print(f"parity / train_second: fp32 (TF32 off) step on the fixture's "
          f"batch matches the JAX step: stage keys identical (sites "
          f"{r['stage_sites']}), {r['labels_nonzero']} labelled anchors "
          f"({r['positives']} positive) identical, regression targets "
          f"{r['max_reg_target_diff']:.3g}; loss terms and grad_norm within "
          f"{max(r['metrics_rel_diff'].values()):.3g} relative (loss "
          f"{r['metrics']['loss']:.6f}, grad_norm "
          f"{r['metrics']['grad_norm']:.6f}), gradients within "
          f"{r['max_grad_diff_of_leaf_max']:.3g} of their leaf's max, "
          f"MaskedBatchNorm and BatchNorm statistics "
          f"{r['max_batch_stats_diff']:.3g}; losses of 3 Adam steps "
          f"{[round(x, 6) for x in r['losses']]} (within "
          f"{max(r['losses_rel_diff']):.3g}), parameters after them within "
          f"{r['params3_max_diff']:.3g} (learning rates summed "
          f"{r['lr_sum']:.3g}); tolerances "
          f"{ {k: SECOND_TRAIN_TOL[k] for k in SECOND_TRAIN_F64} }; this "
          f"card's fp32 step from its float64 step: "
          f"{ {k: float(f'{v:.3g}') for k, v in r['f64_distance'].items()} }",
          flush=True)


def rel_err(got, want):
    """Largest |got - want| relative to want's largest |entry|; inf where
    want is all zero and got is not."""
    d = float((got.float() - want.float()).abs().max()) if want.numel() else 0
    scale = float(want.float().abs().max()) if want.numel() else 0
    return d / scale if scale > 0 else (0.0 if d == 0 else float("inf"))


def check_sparse_conv_grad(cases):
    """cases: {label: (features, idx, hit, weights, valid, transpose,
    grad_out)} → a result per case: the data gradient (the forward kernel
    on the table's transpose that ``transpose`` gives; for None, a table
    that is no layer's, on the scattered transpose,
    ``sparse_conv_transpose_plain`` on the card) and the weight gradient
    on the card, each within :data:`GRAD_TOL` of its plain version's
    largest |entry|; the weight gradient bit-equal over two runs; on a
    submanifold table (``Submanifold``: the table itself through the
    mirrored offsets) the data gradient bit-equal to the same kernel on
    the scattered transpose, which is the table through the mirrored
    offsets; on a strided one the transposed-table kernel equal to its
    plain version and to the scattered transpose."""
    import torch

    from de6d_tpu_torch.ops.kernels import lookup
    from de6d_tpu_torch.ops.kernels import sparse_conv as sc

    lines = {}
    for label, (f, idx, hit, w, valid, tr, dy) in cases.items():
        v = f.shape[1]
        tol = GRAD_TOL[str(f.dtype).split(".")[-1]]
        scattered = sc.sparse_conv_transpose_plain(idx, hit, valid, v)
        on_scattered = sc.sparse_conv(dy, scattered[0], scattered[1],
                                      w.transpose(1, 2).contiguous(),
                                      scattered[2])
        dg = on_scattered if tr is None else sc.sparse_conv_dgrad(
            dy, idx, hit, w, valid, v, tr)
        wg = sc.sparse_conv_wgrad(f, dy, idx, hit, valid)
        wg2 = sc.sparse_conv_wgrad(f, dy, idx, hit, valid)
        want = {"dgrad": sc.sparse_conv_dgrad_plain(dy, idx, hit, w, valid,
                                                    v),
                "wgrad": sc.sparse_conv_wgrad_plain(f, dy, idx, hit, valid)}
        got = {"dgrad": dg, "wgrad": wg}
        torch.cuda.synchronize()
        err = {k: rel_err(got[k], want[k]) for k in got}
        abs_err = {k: float((got[k].float() - want[k].float()).abs().max())
                   for k in got}
        for k, e in err.items():
            if not e <= tol:
                fail(f"kernels / sparse_conv_grad {label}: {k} differs from "
                     f"the plain version by {e:.3g} of its max (tol {tol})")
        if not torch.equal(wg, wg2):
            fail(f"kernels / sparse_conv_grad {label}: two runs of the "
                 "weight-gradient kernel differ")
        line = {"max_rel_err": err, "max_abs_err": abs_err,
                "hits": int((hit & valid[..., None]).sum()),
                "transpose": type(tr).__name__,
                "shape": f"{str(f.dtype).split('.')[-1]} feats "
                         f"{tuple(f.shape)}, table {tuple(idx.shape)}, W "
                         f"{tuple(w.shape)}"}
        if isinstance(tr, sc.Submanifold):
            if not (torch.equal(scattered[1], hit.flip(-1))
                    and torch.equal(scattered[0], torch.where(
                        scattered[1], idx.flip(-1), 0))):
                fail(f"kernels / sparse_conv_grad {label}: the transpose of "
                     "a submanifold table is not the table through the "
                     "mirrored offsets")
            if not torch.equal(dg, on_scattered):
                fail(f"kernels / sparse_conv_grad {label}: the mirrored data "
                     "gradient differs from the kernel on the scattered "
                     "transpose")
            try:
                sc.raise_mirror_fault()
            except ValueError:
                fail(f"kernels / sparse_conv_grad {label}: the mirrored data "
                     "gradient's kernel found a fault in a submanifold table")
            line["mirrored_bit_equal"] = True
        if isinstance(tr, sc.Strided):
            table = lookup.transposed_table(*tr)
            plain = lookup.transposed_table_plain(*tr)
            if not all(torch.equal(a, b) and torch.equal(a, c)
                       for a, b, c in zip(table, plain, scattered)):
                fail(f"kernels / sparse_conv_grad {label}: the transposed "
                     "table differs from its plain version or the "
                     "scattered transpose")
            line["transposed_table_equal"] = True
        lines[label] = line
    return lines


def check_mirror_fault(case):
    """case: a submanifold layer's (features, idx, hit, weights, valid,
    transpose, grad_out) → {kind: True} for the tables that break the
    submanifold contract (``valid`` a strict subset of the rows that
    asked; valid rows that did not ask): the mirrored data gradient's
    kernel sets its fault word and ``sparse_conv.raise_mirror_fault``
    raises once the launch has finished, then is clear."""
    import torch

    from de6d_tpu_torch.ops.kernels import sparse_conv as sc

    f, idx, hit, w, valid, tr, dy = case
    subset = valid.clone()
    subset[:, 1::4] = False
    unasked = hit.clone()
    unasked[:, ::3] = False
    out = {}
    for kind, (h, rows) in {"valid_subset": (hit, subset),
                            "valid_not_asking": (unasked, valid)}.items():
        sc.sparse_conv_dgrad(dy, idx, h, w, rows, f.shape[1], tr)
        torch.cuda.synchronize()
        try:
            sc.raise_mirror_fault()
        except ValueError:
            sc.raise_mirror_fault()  # cleared
            out[kind] = True
        else:
            fail(f"kernels / sparse_conv_grad: a table with {kind} rows "
                 "raised no fault in the mirrored data gradient")
    return out


def time_sparse_conv_grad(layers):
    """layers: {label: (features, idx, hit, weights, valid, transpose,
    grad_out)} of the train step (fp32) → (per kind and layer, per step):
    the forward, dgrad (with its table's transpose: none for a
    submanifold layer, the transposed table for a strided one; all but
    conv_input), wgrad and the transposition (``transposed_table`` for a
    strided layer; 0 launches for a submanifold one): ms by events and in
    a CUDA graph, the plain version's ms (``sparse_conv_plain``; autograd
    through it for the feature or the weight gradient;
    ``transposed_table_plain``), the bound from :func:`sparse_conv.work`
    / :func:`sparse_conv.work_backward` / :func:`lookup.transposed_bytes`,
    and the transposition's latency floor (an empty kernel's time in a
    graph a launch); per step, the 11 data gradients and the
    transposition each timed as one sequence of launches.
    """
    import torch

    from de6d_tpu_torch.ops.kernels import lookup
    from de6d_tpu_torch.ops.kernels import sparse_conv as sc

    empty_ms = graph_ms(lambda: lookup.empty_kernel("cuda"))
    rows = {"forward": {}, "dgrad": {}, "wgrad": {}, "transpose": {}}
    dgrads, tables = [], []
    for label, (f, idx, hit, w, valid, tr, dy) in layers.items():
        v = f.shape[1]
        work = sc.work_backward(f, idx, hit, w, valid)
        work["forward"] = sc.work(f, idx, hit, w, valid)
        fp = f.clone().requires_grad_(True)
        wp = w.clone().requires_grad_(True)
        with torch.enable_grad():
            out = sc.sparse_conv_plain(fp, idx, hit, wp, valid)
        fns = {
            "forward": (lambda: sc.sparse_conv(f, idx, hit, w, valid),
                        lambda: sc.sparse_conv_plain(f, idx, hit, w, valid)),
            "wgrad": (lambda: sc.sparse_conv_wgrad(f, dy, idx, hit, valid),
                      lambda: torch.autograd.grad(out, wp, dy,
                                                  retain_graph=True)),
        }
        if label != "subm_s1_in":
            dgrad = (lambda dy=dy, idx=idx, hit=hit, w=w, valid=valid, v=v,
                     tr=tr: sc.sparse_conv_dgrad(dy, idx, hit, w, valid, v,
                                                 tr))
            dgrads.append(dgrad)
            fns["dgrad"] = (dgrad, lambda: torch.autograd.grad(
                out, fp, dy, retain_graph=True))
        for kind, (fn, plain) in fns.items():
            nbytes, ops = work[kind]
            t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
            rows[kind][label] = {
                "ms": time_ms(fn, 10), "graph_ms": graph_ms(fn),
                "plain_ms": time_ms(plain, 3),
                "bound_ms": max(t_ops, t_bytes) * 1e3,
                "bound_by": "operations" if t_ops > t_bytes else "bytes",
                "bytes": nbytes, "flops": ops}
        if label != "subm_s1_in" and isinstance(tr, sc.Strided):
            nbytes = lookup.transposed_bytes(tr.keys_sorted,
                                             tr.out_keys_sorted,
                                             idx.shape[2])
            table = (lambda tr=tr: lookup.transposed_table(*tr))
            tables.append(table)
            rows["transpose"][label] = {
                "launches": 1, "ms": time_ms(table, 10),
                "graph_ms": graph_ms(table),
                "plain_ms": time_ms(
                    lambda: lookup.transposed_table_plain(*tr), 3),
                "scatter_plain_ms": time_ms(
                    lambda: sc.sparse_conv_transpose_plain(idx, hit, valid,
                                                           v), 3),
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "latency_floor_ms": empty_ms,
                "bound_by": "bytes", "bytes": nbytes}
        elif label != "subm_s1_in":  # the table itself, mirrored
            rows["transpose"][label] = dict.fromkeys(
                ("launches", "ms", "graph_ms", "plain_ms", "scatter_plain_ms",
                 "bound_ms", "latency_floor_ms", "bytes"), 0)
            rows["transpose"][label]["bound_by"] = "bytes"
        del out, fp, wp

    def run_all(fns):
        return lambda: [fn() for fn in fns]

    steps = {kind: {"launches": len(fns), "ms": time_ms(run_all(fns), 10),
                    "graph_ms": graph_ms(run_all(fns))}
             for kind, fns in (("dgrad", dgrads), ("transpose", tables))}
    steps["empty_kernel_graph_ms"] = empty_ms
    return rows, steps


def recorded_second_train_convs(dev):
    """The 12 convs of one fp32 train-mode forward of SECOND (trained
    weights) on the fixture's batch, in call order, as (features, idx,
    hit, weights, valid, transpose) with the tensors detached; transpose
    is what the conv hands its backward (``sparse_conv.Submanifold`` /
    ``Strided``; None from a tree whose convs pass none)."""
    import torch

    model = build_model("float32", dev, SECOND_CFG, SECOND_PARAMS)[0]
    model.train()
    with torch.enable_grad(), recorded_sparse_calls() as calls:
        out = model(dict(second_train_batch(dev)))
    if len(calls["sparse_conv"]) != 12:
        fail(f"kernels / sparse_conv_grad: {len(calls['sparse_conv'])} convs "
             "in one forward, expected 12")
    convs = {}
    for label, (args, kwargs) in zip(SECOND_CONVS, calls["sparse_conv"]):
        transpose = kwargs.get("transpose", (args[5:] or (None,))[0])
        convs[label] = tuple(a.detach() for a in args[:5]) + (transpose,)
    return convs


def phase_sparse_conv_grad(report):
    """``kernels / sparse_conv_grad``: the data gradient (the forward
    kernel on the table's transpose: a submanifold layer's own table
    through the mirrored offsets, a strided layer's transposed table),
    the weight-gradient kernel and the transposed-table kernel against
    their plain versions on the card at the 12 layers of a SECOND train
    step on the fixture's batch (B = 4, a seeded cotangent), fp32 and
    bf16; the mirrored data gradients bit-equal to the kernel on the
    scattered transpose; the edge cases: a layer without a hit, every row
    invalid, V = 1, a sample without sites, a non-contiguous cotangent;
    ms by events and in a CUDA graph, the plain versions' ms, the bounds;
    the step's transposition and its 11 data gradients each as one
    sequence; the same timings of the fp32 forward at those 12 layers
    (``sparse_conv_fp32`` in the kernels line, with its max |d| against
    the plain version)."""
    import numpy as np
    import torch

    from de6d_tpu_torch.ops.kernels import sparse_conv as sc

    torch.backends.cuda.matmul.allow_tf32 = False
    convs = recorded_second_train_convs("cuda")
    kinds = {label: type(c[5]).__name__ for label, c in convs.items()}
    want = {label: "Strided" if label.startswith("down") else "Submanifold"
            for label in convs}
    if kinds != want:
        fail(f"kernels / sparse_conv_grad: the convs hand their backward "
             f"{kinds}, expected {want}")
    gen = torch.Generator(device="cuda").manual_seed(13)
    layers = {}
    for label, (f, idx, hit, w, valid, tr) in convs.items():
        dy = torch.randn((*idx.shape[:2], w.shape[2]), generator=gen,
                         device="cuda")
        layers[label] = (f, idx, hit, w, valid, tr, dy)

    def bf16(case):
        return tuple(a.bfloat16() if torch.is_tensor(a)
                     and a.is_floating_point() else a for a in case)

    cases = dict(layers)
    cases.update({f"{k}_bf16": bf16(c) for k, c in layers.items()})
    f, idx, hit, w, valid, tr, dy = layers["subm_s3a"]
    rng = np.random.RandomState(4)
    one = (torch.from_numpy(rng.randn(4, 1, 16).astype(np.float32)).cuda(),
           torch.zeros((4, 1, 27), dtype=torch.int32, device="cuda"),
           torch.zeros((4, 1, 27), dtype=torch.bool, device="cuda"),
           torch.from_numpy(rng.randn(27, 16, 16).astype(np.float32)).cuda(),
           torch.ones((4, 1), dtype=torch.bool, device="cuda"),
           sc.Submanifold(),
           torch.from_numpy(rng.randn(4, 1, 16).astype(np.float32)).cuda())
    one[2][:, :, 13] = True  # a site is its own neighbour at the centre
    empty_hit, empty_valid = hit.clone(), valid.clone()
    empty_hit[1], empty_valid[1] = False, False  # sample 1 without sites
    edges = {  # tables that are no layer's: no transpose
        "no_hit": (f, idx, torch.zeros_like(hit), w, valid, None, dy),
        "all_invalid": (f, idx, hit, w, torch.zeros_like(valid), None, dy),
        "v1": one,
        "empty_sample": (f, idx, empty_hit, w, empty_valid, tr, dy),
        "noncontiguous_dy": (f, idx, hit, w, valid, tr, dy.transpose(
            1, 2).contiguous().transpose(1, 2)),
    }
    cases.update(edges)
    cases.update({f"{k}_bf16": bf16(c) for k, c in edges.items()})
    lines = check_sparse_conv_grad(cases)
    contract = check_mirror_fault(layers["subm_s3a"])
    rows, steps = time_sparse_conv_grad(layers)
    name = {"forward": "sparse_conv_fp32", "dgrad": "sparse_conv_dgrad",
            "wgrad": "sparse_conv_wgrad", "transpose": "transposed_table"}
    note = {"forward": "csrc/sparse_conv.cu (fp32, variant simt, at a "
                       "train step's layers)",
            "dgrad": "csrc/sparse_conv.cu (the forward kernel on the "
                     "table's transpose: a submanifold layer's own table "
                     "through the mirrored offsets, a strided layer's "
                     "transposed table, whose time it includes)",
            "wgrad": "csrc/sparse_conv.cu",
            "transpose": "csrc/lookup.cu (transposed_table_kernel: a "
                         "strided layer's data-gradient table gathered "
                         "from its output keys, every entry written once; "
                         "the submanifold layers launch none)"}
    for kind, per in rows.items():
        # over the train step's layers (fp32, its dtype)
        if kind == "forward":
            err = max(float((sc.sparse_conv(*layers[k][:5])
                             - sc.sparse_conv_plain(*layers[k][:5])).abs()
                            .max()) for k in layers)
        else:
            err = max((lines[k]["max_abs_err"][kind] for k in layers
                       if kind in lines[k]["max_abs_err"]), default=0.0)
        report[name[kind]] = {
            "name": name[kind], "route": "cuda",
            "source": "de6d_tpu_torch/" + note[kind].split(" ")[0],
            # the forward replaces the Pallas gather-GEMM; the gradients
            # what JAX differentiates, the XLA gather-GEMM (a strided
            # layer's for the transposed table), no TPU kernel
            "replaces": {"forward": "de6d_tpu/ops/pallas/sparse_gather.py:161",
                         "transpose": "de6d_tpu/ops/sparse.py:299"}.get(
                kind, "de6d_tpu/ops/sparse.py:149"),
            "max_abs_err": 0.0 if kind == "transpose" else err,
            **{k: sum(r[k] for r in per.values())
               for k in ("ms", "graph_ms", "plain_ms", "bound_ms")},
            "bound_by": "operations" if any(
                r["bound_by"] == "operations" for r in per.values())
            else "bytes",
            "library_ms": None,
            "layers": per, "note": note[kind],
        }
    t = report["transposed_table"]
    t["latency_floor_ms"] = sum(r["latency_floor_ms"]
                                for r in rows["transpose"].values())
    t["step"] = steps["transpose"]
    report["sparse_conv_dgrad"]["step"] = steps["dgrad"]
    report["sparse_conv_grad_steps"] = steps
    report["sparse_conv_grad_cases"] = lines
    report["sparse_conv_grad_contract_faults"] = contract
    fw, d, w_ = (report[name[k]] for k in ("forward", "dgrad", "wgrad"))
    print(f"kernels / sparse_conv_grad: {len(cases)} cases (the 12 train-"
          f"step layers and the edge cases {sorted(edges)}, fp32 and bf16) "
          f"within {GRAD_TOL} of the plain versions, the weight gradient "
          f"bit-equal over two runs, the submanifold layers' mirrored data "
          f"gradients bit-equal to the kernel on the scattered transpose, "
          f"the strided layers' transposed tables equal to it, tables "
          f"that break the submanifold contract raise ({sorted(contract)})"
          f"; a train "
          f"step's 12 fp32 forwards {fw['ms']:.4f} ms by events, "
          f"{fw['graph_ms']:.4f} in a graph (plain {fw['plain_ms']:.3f}, "
          f"bound {fw['bound_ms']:.5f}, max |d| {fw['max_abs_err']:.3g}); "
          f"11 data gradients with their tables' transposes "
          f"{d['ms']:.4f} ms by events, {d['graph_ms']:.4f} in a graph "
          f"(as one sequence {d['step']['ms']:.4f} / "
          f"{d['step']['graph_ms']:.4f}; plain {d['plain_ms']:.3f}, bound "
          f"{d['bound_ms']:.5f}); 12 weight gradients {w_['ms']:.4f} / "
          f"{w_['graph_ms']:.4f} ms (plain {w_['plain_ms']:.3f}, bound "
          f"{w_['bound_ms']:.5f}); the step's transposition, "
          f"{t['step']['launches']} transposed tables (the 7 submanifold "
          f"layers 0 launches): {t['ms']:.4f} / {t['graph_ms']:.4f} ms (as "
          f"one sequence {t['step']['ms']:.4f} / "
          f"{t['step']['graph_ms']:.4f}; plain {t['plain_ms']:.3f}, bound "
          f"{t['bound_ms']:.5f}, latency floor {t['latency_floor_ms']:.5f}: "
          f"an empty kernel {steps['empty_kernel_graph_ms']:.5f} ms in a "
          f"graph a launch)", flush=True)
    for kind, per in rows.items():
        print(f"kernels / sparse_conv_grad {kind} by layer (ms, graph ms, "
              f"bound ms): " + ", ".join(
                  f"{k} {r['ms']:.4f}/{r['graph_ms']:.4f}/"
                  f"{r['bound_ms']:.5f}" for k, r in per.items()),
              flush=True)


def phase_train_second(report, kernels, profile):
    """``train / second``: :func:`measure_train` with ``second.yaml`` as
    shipped (fp32, cuDNN's TF32 off as ``tools/train.py`` sets it) at
    batch 4 from the trained weights over the fixture's frames: exactly
    :data:`SECOND_TRAIN_LAUNCHES` a step and no other kernel launch."""
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(None, "cuda", SECOND_CFG, SECOND_PARAMS)[0]
    out, rows = measure_train(
        "train / second", model, second_train_batch("cuda"),
        second_opt_cfg(), kernels, SECOND_TRAIN_LAUNCHES)
    ours = {k: sum(us for name, us, _ in rows if k in name)
            for k in ("neighbor_table_kernel", "sparse_conv_gather_kernel",
                      "sparse_conv_wgrad", "transposed_table_kernel")}
    out.update(compute_dtype="float32 (second.yaml; TF32 off)",
               kernels_device_us_per_step=ours,
               profile_top=[list(r) for r in rows[:25]])
    report["train_second"] = out
    print(train_line("train / second", out, "(fp32, second.yaml, TF32 "
                     "off) at full width through train_model")
          + "; hand-written "
          f"kernels { {k: f'{us:.1f} us' for k, us in ours.items()}}",
          flush=True)
    for name, us, c in rows[:12 if profile else 6]:
        print(f"train / second profile: {us:10.1f} us  x{c:6.1f}  "
              f"{name[:90]}")


# ---------------------------------------------------------------------
# PV-RCNN: FPS and suppression-mask kernels at its shapes, serve, parity
# ---------------------------------------------------------------------

def pvrcnn_proposals(out, roi_cfg):
    """The proposal layer's candidates, the NMS input: the top
    ``NMS_PRE_MAXSIZE`` anchors by score (no score gate), their decoded
    boxes and the anchor scores (B, A)."""
    import torch

    from de6d_tpu_torch.ops.nms import stable_top_k

    scores = torch.sigmoid(out["rpn_cls_preds"]).amax(dim=-1)
    pre = min(int(roi_cfg["NMS_PRE_MAXSIZE"]), scores.shape[1])
    _, order = stable_top_k(scores, pre)
    boxes = out["rpn_box_preds"]
    cand = torch.gather(boxes, 1, order[..., None].expand(
        -1, -1, boxes.shape[-1])).contiguous()
    return cand, order, scores


def phase_pvrcnn_kernels(report):
    """FPS at PV-RCNN's keypoint shape (8 x 16384 -> 2048 on the clipped
    scans) and the mask and resolve kernels on its 8 x 1024 proposals and
    8 x 100 final candidates, from one bf16 forward of the served model."""
    import torch

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        select_candidates,
    )
    from de6d_tpu_torch.ops.nms import NEG_INF

    model, mc, nc = build_model("bfloat16", "cuda", PVRCNN_CFG, PVRCNN_SEED)
    pts, mask = load_pvrcnn_scans()
    points = torch.from_numpy(pts).cuda()
    valid = torch.from_numpy(mask).cuda()
    with torch.no_grad():
        out = model({"points": points, "points_mask": valid})
    n_kp = int(mc["PFE"]["NUM_KEYPOINTS"])
    lines = check_fps({"pvrcnn_keypoints": (
        points[..., :3].contiguous(), valid, n_kp, None)}, report,
        variant_ms=("pvrcnn_keypoints",))
    report["fps"]["cases"].update(lines)
    report["fps"]["pvrcnn_ms_per_batch"] = lines["pvrcnn_keypoints"]["ms"]

    roi_cfg = mc["ROI_HEAD"]["NMS_CONFIG"]["TEST"]
    num_rois = int(roi_cfg["NMS_POST_MAXSIZE"])
    cand, _, _ = pvrcnn_proposals(out, roi_cfg)
    b, pre = cand.shape[:2]
    all_live = torch.full((b,), pre, dtype=torch.int32, device="cuda")
    post_cfg = mc["POST_PROCESSING"]
    nms_cfg = post_cfg["NMS_CONFIG"]
    fin_boxes, fin_scores, _ = select_candidates(out, post_cfg)
    fin_counts = (fin_scores > NEG_INF / 2).sum(-1).to(torch.int32)
    lines = check_nms_mask({
        "pvrcnn_proposals": (cand, all_live, float(roi_cfg["NMS_THRESH"]),
                             num_rois),
        "pvrcnn_final": (fin_boxes.contiguous(), fin_counts,
                         float(nms_cfg["NMS_THRESH"]),
                         min(int(nms_cfg["NMS_POST_MAXSIZE"]),
                             fin_boxes.shape[1])),
    })
    report["nms_mask"]["cases"].update(lines)
    report["nms_mask"]["pvrcnn_ms_per_batch"] = sum(
        ln["ms"] + ln["resolve_ms"] for ln in lines.values())
    report["pvrcnn_rois"] = {"shape": list(out["rois"].shape),
                             "valid": out["roi_valid"].sum(-1).tolist()}
    fl, ml = report["fps"]["cases"]["pvrcnn_keypoints"], lines
    print(f"kernels / pv_rcnn: FPS {fl['shape']} {fl['ms']:.4f} ms (bound "
          f"{fl['bound_ms']:.5f}, latency floor "
          f"{fl['latency_floor_ms']:.4f}), mask + resolve on the {b} x {pre} "
          f"proposals {ml['pvrcnn_proposals']['ms']:.4f} + "
          f"{ml['pvrcnn_proposals']['resolve_ms']:.4f} ms, on the {b} x "
          f"{fin_boxes.shape[1]} final candidates "
          f"{ml['pvrcnn_final']['ms']:.4f} + "
          f"{ml['pvrcnn_final']['resolve_ms']:.4f} ms; RoIs per scan "
          f"{report['pvrcnn_rois']['valid']}", flush=True)
    return model, mc, nc


def grid_sphere_rois(kp, kp_valid, rois, ref_rois, grid_size, radii):
    """(R,) bool: the RoIs whose grouping can part from the reference's.
    ``kp`` (K, 3) keypoints (identical to the reference's), ``rois`` and
    ``ref_rois`` (R, 7) the port's and the reference's RoIs from the same
    anchors. A keypoint joins the group of a grid point when its fp32
    ``d²`` lies below ``r²``; a grid point of the port's RoI lies within
    ``shift`` of the reference's (the grid displacement between the two
    RoIs plus two ulps of the coordinates, for a cos or sin that rounds
    otherwise in the reference), and ``d²`` is ``|c|² + |p|² - 2c·p``, a
    few ulps of ``|c|² + |p|²`` off the exact value. A RoI is returned
    when a valid keypoint's exact ``d²`` to one of its grid points lies
    within that band of a radius's square."""
    import torch

    from de6d_tpu_torch.models.roi_heads.pvrcnn_head import roi_grid_points

    g = roi_grid_points(rois[None, :, :7], grid_size)[0].double()
    g_ref = roi_grid_points(ref_rois[None, :, :7], grid_size)[0].double()
    shift = ((g - g_ref).norm(dim=-1).amax(dim=-1)
             + 2.0 ** -22 * g.abs().amax(dim=(-1, -2)))[:, None, None]
    p = kp.double()
    on = torch.zeros(g.shape[0], dtype=torch.bool, device=g.device)
    for r0 in range(0, g.shape[0], 10):  # RoIs in chunks: (10, G³, K)
        gc = g[r0:r0 + 10]
        d2 = ((gc[:, :, None, :] - p[None, None]) ** 2).sum(-1)
        slack = 8 * 2.0 ** -24 * ((gc * gc).sum(-1)[..., None]
                                  + (p * p).sum(-1))
        sh = shift[r0:r0 + 10]
        for r in radii:
            lo = torch.clamp(r - sh, min=0.0) ** 2 - slack
            hi = (r + sh) ** 2 + slack
            near = (d2 >= lo) & (d2 <= hi) & kp_valid[None, None]
            on[r0:r0 + 10] |= near.flatten(1).any(dim=1)
    return on


def check_pvrcnn_parity(out, post, ref, model_cfg, tol=PARITY_TOL):
    """PV-RCNN against the JAX reference ``ref`` (the fixture's arrays).

    1. Keypoints (d-fps on the raw points, no learned input): identical
       picks. Keypoint scores within ``tol``.
    2. Proposals: the port's anchor scores at the reference's stored
       window of its best anchors within ``tol`` (largest difference
       ``delta``). The top ``NMS_PRE_MAXSIZE`` order may hold another
       anchor than the reference's only at a near-tie: the two anchors'
       reference scores within ``2 * delta`` (both must lie in the
       stored window). The decoded boxes of anchors in both lists within
       ``tol``.
    3. RoIs, by the anchor each came from: counts equal; a list may part
       from the reference's only at a near-tie (:func:`pair_roi_lists`).
    4. RoIs from the same anchor: boxes within ``tol``; ``rcnn_cls`` and
       ``rcnn_reg`` within ``tol``, and in the slots past the count (zero
       boxes, pooled and scored as in JAX) too — except a RoI with a
       keypoint on a grouping sphere of one of its grid points
       (:func:`grid_sphere_rois`), whose pooled groups may differ; those
       are counted and reported.
    5. Detections of a sample whose RoI list counts as the reference's
       and none of whose RoIs on a sphere moved: counts and labels equal,
       boxes and scores within ``tol``, slot by slot, or as a set
       (:func:`match_detections`) where the list parted at a tie (tied
       detections may then trade places). Other samples' detections are
       reported as not compared.
    "Within ``tol``" is absolute for values below 1 and relative above.
    Returns a report; raises RuntimeError where a check fails."""
    import numpy as np
    import torch

    from de6d_tpu_torch.ops.nms import stable_top_k

    tag = "parity / pv_rcnn"

    def close(name, got, want, where=""):
        return close_to(tag, name, got, want, tol, where)

    diffs = {}
    if not np.array_equal(out["keypoint_idx"].cpu().numpy(),
                          ref["keypoint_idx"]):
        raise RuntimeError(f"{tag}: keypoint picks (d-fps) differ from the "
                           "reference")
    diffs["point_cls_scores"] = close(
        "keypoint scores", out["point_cls_scores"].cpu().numpy(),
        ref["point_cls_scores"])

    roi_cfg = model_cfg["ROI_HEAD"]["NMS_CONFIG"]["TEST"]
    cand, order_t, scores_t = pvrcnn_proposals(out, roi_cfg)
    scores = scores_t.cpu().numpy()
    win_order = ref["prop_order"].astype(np.int64)  # (B, window)
    win_scores = ref["prop_scores"]
    delta = diffs["anchor_scores"] = close(
        "anchor scores", np.take_along_axis(scores, win_order, axis=1),
        win_scores)
    near = 2 * delta + 1e-7
    stored = [dict(zip(o.tolist(), s.tolist()))
              for o, s in zip(win_order, win_scores)]

    def tie_gap(b, p, r):
        if p not in stored[b] or r not in stored[b]:
            raise RuntimeError(
                f"{tag}: anchor {p if p not in stored[b] else r} of sample "
                f"{b} lies outside the reference's stored window of "
                f"{win_order.shape[1]} anchors")
        return abs(stored[b][p] - stored[b][r])

    order = order_t.cpu().numpy()
    pre = order.shape[1]
    swapped = 0
    for b, k in zip(*np.nonzero(order != win_order[:, :pre])):
        swapped += 1
        if tie_gap(b, int(order[b, k]), int(win_order[b, k])) > near:
            raise RuntimeError(f"{tag}: proposal candidate {k} of sample {b} "
                               "differs from the reference and is no "
                               "near-tie")
    cand = cand.cpu().numpy()
    diffs["proposal_boxes"] = 0.0
    for b in range(order.shape[0]):
        slot = {int(a): j for j, a in enumerate(order[b])}
        pairs = [(slot[int(a)], j) for j, a in enumerate(win_order[b, :pre])
                 if int(a) in slot]
        gi = np.array([g for g, _ in pairs], np.int64)
        ri = np.array([r for _, r in pairs], np.int64)
        diffs["proposal_boxes"] = max(diffs["proposal_boxes"], close(
            "proposal boxes", cand[b, gi], ref["prop_boxes"][b, ri],
            f" of sample {b}"))

    roi_idx = out["roi_point_idx"].cpu().numpy()
    roi_cnt = out["roi_valid"].sum(-1).cpu().numpy()
    got = {k: v.cpu().numpy() for k, v in post.items()}
    for k in ("rois", "rcnn_cls", "rcnn_reg"):
        got[k] = out[k].cpu().numpy()
    pool = model_cfg["ROI_HEAD"]["ROI_GRID_POOL"]
    radii = [float(r) for r in pool["POOL_RADIUS"]]
    partings, on_spheres, skipped = [], [], []
    for k in ("rois", "rcnn_cls", "rcnn_reg", "pred_boxes", "pred_scores"):
        diffs[k] = 0.0
    for b in range(roi_idx.shape[0]):
        c = int(ref["roi_count"][b])
        if int(roi_cnt[b]) != c:
            raise RuntimeError(f"{tag}: {roi_cnt[b]} RoIs in sample {b}, "
                               f"reference {c}")
        gi, ri, whole, parting = pair_roi_lists(
            tag, b, roi_idx[b, :c], ref["roi_idx"][b, :c],
            got["rois"][b, :c], ref["rois"][b, :c],
            lambda p, r: tie_gap(b, p, r), near, tol, "anchor")
        if parting is not None:
            partings.append(parting)
        # the slots past the count hold zero boxes in both
        rest = np.arange(c, roi_idx.shape[1])
        gi, ri = np.concatenate([gi, rest]), np.concatenate([ri, rest])
        where = f" of sample {b}"
        diffs["rois"] = max(diffs["rois"], close(
            "rois", got["rois"][b, gi], ref["rois"][b, ri], where))
        ref_rois = torch.as_tensor(ref["rois"][b, ri],
                                   device=out["rois"].device)
        on = grid_sphere_rois(
            out["point_coords"][b], out["point_valid"][b],
            out["rois"][b, torch.as_tensor(gi, device=ref_rois.device)],
            ref_rois, int(pool["GRID_SIZE"]), radii).cpu().numpy()

        def rel(k):
            want = ref[k][b, ri].astype(np.float64)
            d = np.abs(got[k][b, gi] - want) / np.maximum(1.0, np.abs(want))
            return d.reshape(len(gi), -1).max(axis=1)

        moved = on & ((rel("rcnn_cls") > tol) | (rel("rcnn_reg") > tol))
        on_spheres.append({"sample": b, "rois": int(on.sum()),
                           "moved": int(moved.sum())})
        for k in ("rcnn_cls", "rcnn_reg"):
            diffs[k] = max(diffs[k], close(
                k, got[k][b, gi[~on]], ref[k][b, ri[~on]], where))
        if not whole or moved.any():
            skipped.append(b)
            continue
        n = int(ref["pred_count"][b])
        if int(got["pred_count"][b]) != n:
            raise RuntimeError(f"{tag}: counts {got['pred_count']} vs "
                               f"{ref['pred_count']}")
        # RoIs in another order (tied anchors) reach the final NMS in
        # another order too: then tied detections may trade places
        take = (np.arange(n) if parting is None else match_detections(
            tag, {k: got[k][b, :n] for k in ("pred_boxes", "pred_scores",
                                             "pred_labels")},
            {k: ref[k][b, :n] for k in ("pred_boxes", "pred_scores",
                                        "pred_labels")}, tol, where))
        if not np.array_equal(got["pred_labels"][b, take],
                              ref["pred_labels"][b, :n]):
            raise RuntimeError(f"{tag}: labels{where} differ")
        for k in ("pred_boxes", "pred_scores"):
            diffs[k] = max(diffs[k], close(k, got[k][b, take],
                                           ref[k][b, :n], where))
    return {"counts": got["pred_count"].tolist(),
            "roi_counts": roi_cnt.tolist(), "max_abs_diff": diffs,
            "candidates_swapped": swapped, "partings": partings,
            "rois_on_a_sphere": on_spheres,
            "detections_not_compared": skipped}


def match_detections(tag, got, ref, tol, where=""):
    """One sample's detections (``pred_boxes``, ``pred_scores``,
    ``pred_labels``) against the reference's as a set: for each reference
    detection in turn, the first unmatched port detection with its label,
    its score within ``tol`` and its box within ``tol`` (relative above
    1). Returns the port rows in reference order; RuntimeError where a
    reference detection has no match."""
    import numpy as np

    def within(a, want):
        want = np.asarray(want, np.float64)
        return (np.abs(np.asarray(a, np.float64) - want)
                <= tol * np.maximum(1.0, np.abs(want)))

    free = np.ones(len(got["pred_scores"]), bool)
    take = []
    for j in range(len(ref["pred_scores"])):
        ok = (free & (got["pred_labels"] == ref["pred_labels"][j])
              & within(got["pred_scores"], ref["pred_scores"][j])
              & within(got["pred_boxes"], ref["pred_boxes"][j]).all(-1))
        if not ok.any():
            raise RuntimeError(f"{tag}: detection {j}{where} has no match "
                               "among the port's")
        i = int(np.argmax(ok))
        free[i] = False
        take.append(i)
    return np.array(take, np.int64)


def phase_pvrcnn_parity(report):
    import numpy as np
    import torch

    from de6d_tpu_torch.models.detectors.detector3d_template import (
        post_processing,
    )

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    model, mc, nc = build_model("float32", "cuda", PVRCNN_CFG, PVRCNN_SEED)
    pts, mask = load_pvrcnn_scans()
    with torch.no_grad():
        out = model({"points": torch.from_numpy(pts[:2]).cuda(),
                     "points_mask": torch.from_numpy(mask[:2]).cuda()})
        post = post_processing(out, mc["POST_PROCESSING"], nc)
        try:
            res = check_pvrcnn_parity(out, post, dict(np.load(PVRCNN_REF)),
                                      mc)
        except RuntimeError as e:
            fail(str(e))
    report["parity_pv_rcnn"] = res
    d = res["max_abs_diff"]
    print(f"parity / pv_rcnn: fp32 (TF32 off) on 2 scans matches the JAX "
          f"reference: keypoint picks identical, "
          f"{res['candidates_swapped']} proposal candidates swapped at "
          f"near-ties, {len(res['partings'])} RoI lists parted, RoIs with a "
          f"keypoint on a grouping sphere {res['rois_on_a_sphere']}, "
          f"detections not compared for samples "
          f"{res['detections_not_compared']}, RoIs {res['roi_counts']}, "
          f"detections {res['counts']}, max |d| keypoint score "
          f"{d['point_cls_scores']:.3g}, anchor score "
          f"{d['anchor_scores']:.3g}, RoI {d['rois']:.3g}, rcnn_cls "
          f"{d['rcnn_cls']:.3g}, rcnn_reg {d['rcnn_reg']:.3g}, box "
          f"{d['pred_boxes']:.3g}, score {d['pred_scores']:.3g} (tol "
          f"{PARITY_TOL})", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    # the CLIs write output/ under the current directory, as the JAX
    # ones do: run them in this checkout, wherever the script was started
    os.chdir(ROOT)
    from de6d_tpu_torch.ops.kernels import (
        build, canvas, fps, lookup, matrix_fps, nms_fused, nms_mask,
        sparse_conv,
    )

    profile = "--profile" in sys.argv[1:]
    t_start = time.perf_counter()
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}

    so = build.build()
    report["build"] = {k: v for k, v in build.build_info.items()
                       if k != "ptxas"}
    print(f"build: {so.name} in {build.build_info['seconds']:.1f} s "
          f"(cached: {build.build_info['cached']})", flush=True)
    for line in build.build_info.get("ptxas", "").splitlines():
        if ("registers" in line or "Compiling entry" in line
                or "spill" in line):
            print(f"build:   {line.strip()}")

    check_grad_guard(report)
    nms = nms_fused.nms_keep_batched
    model, mc = phase_kernels("cuda", report)
    pts, mask = load_scans()
    report["serve"] = phase_serve(
        "serve", model, mc, 3, pts, mask,
        {"canvas": canvas.scatter_canvas, "nms": nms}, 7, profile)
    del model
    phase_parity("cuda", report)
    phase_canvas_grad(report)
    phase_train_parity(report)
    every_kernel = {"canvas": canvas.scatter_canvas,
                    "canvas_grad": canvas.scatter_canvas_grad,
                    "nms": nms, "nms_mask": nms_mask.nms_suppression_mask,
                    "nms_resolve": nms_mask.nms_resolve, "fps": fps.fps,
                    "matrix_fps": matrix_fps.matrix_fps,
                    "lookup": lookup.lookup,
                    "neighbor_table": lookup.neighbor_table,
                    "sparse_conv": sparse_conv.sparse_conv,
                    "sparse_conv_dgrad": sparse_conv.sparse_conv_dgrad,
                    "sparse_conv_wgrad": sparse_conv.sparse_conv_wgrad,
                    "sparse_conv_dgrad_mirrored": MirroredDgrad(),
                    "transposed_table": lookup.transposed_table}
    phase_train(report, every_kernel, profile)
    phase_pipeline(report)
    ckpt = phase_train_kitti(report, every_kernel)
    phase_eval_kitti(report, every_kernel, ckpt)

    model, mc = phase_det6d_kernels(report)
    pts, mask = load_det6d_scans()
    report["serve_det6d"] = phase_serve(
        "serve / det6d", model, mc, 1, pts, mask,
        {"fps": fps.fps, "nms": nms}, 9, profile,
        per_batch={"fps": 3, "nms": 1})
    del model
    phase_det6d_parity(report)
    phase_det6d_train_parity(report)
    phase_det6d_train(report, every_kernel, profile)
    phase_det6d_train_slopedkitti(report, every_kernel)
    phase_det6d_eval(report, every_kernel)

    model, mc = phase_rcnn_kernels(report)
    pts, mask = load_rcnn_scans()
    report["serve_pointrcnn"] = phase_serve(
        "serve / pointrcnn", model, mc, 3, pts, mask,
        {"nms_mask": nms_mask.nms_suppression_mask,
         "nms_resolve": nms_mask.nms_resolve, "fps": fps.fps, "nms": nms},
        7, profile,
        per_batch={"nms_mask": 2, "nms_resolve": 2, "fps": 6, "nms": 0})
    del model
    phase_rcnn_parity(report)

    ffps = matrix_fps.matrix_fps
    model, mc = phase_ssd3d_kernels(report)
    pts, mask = load_ssd3d_scans()
    report["serve_3dssd"] = phase_serve(
        "serve / 3dssd", model, mc, 1, pts, mask,
        {"matrix_fps": ffps, "fps": fps.fps, "nms": nms}, 7, profile,
        per_batch={"matrix_fps": 2, "fps": 2, "nms": 1})
    del model
    phase_point_parity("parity / 3dssd", SSD3D_CFG, SSD3D_SEED, SSD3D_REF,
                       report)

    model, mc, nc = build_model("bfloat16", "cuda", IASSD_CFG, IASSD_SEED)
    phase_nms_case("iassd", model, mc, pts, mask, report)
    report["serve_iassd"] = phase_serve(
        "serve / iassd", model, mc, nc, pts, mask,
        {"matrix_fps": ffps, "fps": fps.fps, "nms": nms}, 7, profile,
        per_batch={"matrix_fps": 0, "fps": 2, "nms": 1}, serve_s=2.0)
    del model
    phase_point_parity("parity / iassd", IASSD_CFG, IASSD_SEED, IASSD_REF,
                       report)

    model, mc, nc = phase_second_kernels(report)
    pts, mask = load_second_scans()
    report["serve_second"] = phase_serve(
        "serve / second", model, mc, nc, pts, mask,
        {"neighbor_table": lookup.neighbor_table, "lookup": lookup.lookup,
         "sparse_conv": sparse_conv.sparse_conv, "nms": nms}, 7, profile,
        per_batch={"neighbor_table": 8, "lookup": 0, "sparse_conv": 12},
        serve_s=2.0)
    del model
    phase_second_parity(report)
    phase_sparse_conv_grad(report)
    phase_second_train_parity(report)
    phase_train_second(report, every_kernel, profile)
    second_eval = (("neighbor_table", 8), ("sparse_conv", 12))
    ckpt = phase_train_kitti(report, every_kernel, SECOND_CFG,
                             "train / second_kitti", "train_second_kitti",
                             tuple(SECOND_TRAIN_LAUNCHES.items()),
                             second_eval)
    phase_eval_kitti(report, every_kernel, ckpt, SECOND_CFG, SECOND_PARAMS,
                     SECOND_EVAL_REF, "eval / second_kitti",
                     "eval_second_kitti", second_eval, (1, 2))

    model, mc, nc = phase_pvrcnn_kernels(report)
    pts, mask = load_pvrcnn_scans()
    report["serve_pv_rcnn"] = phase_serve(
        "serve / pv_rcnn", model, mc, nc, pts, mask,
        {"fps": fps.fps, "nms_mask": nms_mask.nms_suppression_mask,
         "nms_resolve": nms_mask.nms_resolve,
         "neighbor_table": lookup.neighbor_table,
         "sparse_conv": sparse_conv.sparse_conv, "nms": nms,
         "canvas": canvas.scatter_canvas, "lookup": lookup.lookup,
         "matrix_fps": matrix_fps.matrix_fps}, 7, profile,
        per_batch={"fps": 1, "nms_mask": 2, "nms_resolve": 2,
                   "neighbor_table": 8, "sparse_conv": 12, "nms": 0,
                   "canvas": 0, "lookup": 0, "matrix_fps": 0})
    del model
    phase_pvrcnn_parity(report)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    report["seconds"] = time.perf_counter() - t_start
    by_path = {"pointpillar": report["serve"]["launches"],
               "det6d": report["serve_det6d"]["launches"],
               "pointrcnn": report["serve_pointrcnn"]["launches"],
               "3dssd": report["serve_3dssd"]["launches"],
               "iassd": report["serve_iassd"]["launches"],
               "second": report["serve_second"]["launches"],
               "pv_rcnn": report["serve_pv_rcnn"]["launches"],
               "pointpillar_train": report["train"]["launches"],
               "pointpillar_train_kitti": report["train_kitti"]["launches"],
               "pointpillar_eval_kitti": report["eval_kitti"]["launches"],
               "det6d_train": report["train_det6d"]["launches"],
               "det6d_train_slopedkitti":
                   report["train_det6d_slopedkitti"]["launches"],
               "det6d_eval_slopedkitti": report["eval_det6d"]["launches"],
               "second_train": report["train_second"]["launches"],
               "second_train_kitti":
                   report["train_second_kitti"]["launches"],
               "second_eval_kitti": report["eval_second_kitti"]["launches"]}
    kernels = []
    # the sparse conv's launches split by dtype: the train paths run it in
    # fp32 (second.yaml), the others in bf16
    fp32_paths = ("second_train", "second_train_kitti")
    for key in ("canvas", "canvas_grad", "nms", "nms_mask", "fps",
                "matrix_fps", "lookup", "neighbor_table", "sparse_conv",
                "sparse_conv_fp32", "sparse_conv_dgrad", "sparse_conv_wgrad",
                "transposed_table"):
        k = {f: report[key][f] for f in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if key == "sparse_conv_fp32":
            per = {p: by_path[p]["sparse_conv"] for p in fp32_paths}
        else:  # sparse_conv: the bf16 paths' launches
            per = {p: n[key] for p, n in by_path.items()
                   if key in n and not (key == "sparse_conv"
                                        and p in fp32_paths)}
        k["launches"] = sum(per.values())
        k["launches_by_path"] = per
        kernels.append(k)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
