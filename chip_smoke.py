"""Smoke test of the PyTorch/CUDA port (``de6d_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown

Phases, one status line each; any failure exits non-zero:

1. build          — compile ``de6d_tpu_torch/csrc/*.cu`` for sm_90a.
   grad guard     — ``scatter_canvas`` and ``sparse_conv`` on the card
                    raise on a requires-grad input under ``enable_grad``
                    and run under ``no_grad``; their CPU plain versions
                    backpropagate (:func:`check_grad_guard`).
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

The line before the last is the card's name and power limit, the one
before it a JSON summary of the kernels, the last line
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import copy
import json
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
    the slots' own compute-dtype overrides are dropped: fp32 everywhere."""
    from de6d_tpu_torch import weights
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models import build_network

    cfg = cfg_from_yaml_file(cfg_path)
    mc = copy.deepcopy(cfg.MODEL)
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
    """The kernels that carry a differentiable function in the JAX package
    (canvas, sparse conv) refuse a requires-grad input on the card while
    grad is enabled, run under ``no_grad``, and their CPU plain versions
    stay differentiable."""
    import numpy as np
    import torch

    from de6d_tpu_torch.ops.kernels import canvas, sparse_conv

    rng = np.random.RandomState(3)
    ny, nx, v, c = 6, 5, 12, 8
    lin = torch.from_numpy(np.concatenate(
        [np.sort(rng.choice(ny * nx, 9, replace=False)),
         [ny * nx] * 3]).astype(np.int32)[None])
    feat = torch.from_numpy(rng.standard_normal((1, v, c)).astype(np.float32))
    q, k, cin, cout = 7, 3, 8, 16
    conv_in = (
        torch.from_numpy(rng.standard_normal((1, v, cin)).astype(np.float32)),
        torch.from_numpy(rng.randint(0, v, (1, q, k)).astype(np.int32)),
        torch.from_numpy(rng.random_sample((1, q, k)) < 0.7),
        torch.from_numpy(rng.standard_normal((k, cin, cout)).astype(
            np.float32)),
        torch.ones(1, q, dtype=torch.bool),
    )
    calls = {
        "scatter_canvas": (lambda f: canvas.scatter_canvas(
            f, lin.to(f.device), ny, nx), (0,)),
        "sparse_conv": (lambda *a: sparse_conv.sparse_conv(*a), (0, 3)),
    }
    for name, (fn, grad_args) in calls.items():
        args = (feat,) if name == "scatter_canvas" else conv_in
        cpu = [a.clone().requires_grad_(i in grad_args) for i, a in
               enumerate(args)]
        fn(*cpu).float().sum().backward()
        if any(cpu[i].grad is None for i in grad_args):
            fail(f"grad guard: the CPU plain {name} lost its gradient")
        for i in grad_args:
            dev = [a.cuda().requires_grad_(j == i) for j, a in
                   enumerate(args)]
            with torch.enable_grad():
                try:
                    fn(*dev)
                except RuntimeError as err:
                    if "backward" not in str(err):
                        raise
                else:
                    fail(f"grad guard: {name} on the card took argument {i} "
                         "requiring grad under enable_grad")
            with torch.no_grad():
                got = fn(*dev)
            want = fn(*[a.detach() for a in cpu])
            torch.cuda.synchronize()
            if not torch.allclose(got.cpu(), want, atol=1e-5, rtol=1e-5):
                fail(f"grad guard: {name} under no_grad differs from plain")
    report["grad_guard"] = sorted(calls)
    print("grad guard: scatter_canvas and sparse_conv raise on a "
          "requires-grad input under enable_grad and run under no_grad on "
          "the card; their CPU plain versions backpropagate", flush=True)


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
        same = roi_idx[b, :c] == ref["roi_idx"][b, :c]
        if int(roi_cnt[b]) != c:
            raise RuntimeError(f"parity / pointrcnn: {roi_cnt[b]} RoIs in "
                               f"sample {b}, reference {c}")
        # a swap of two tied candidates leaves the set of RoIs as it was;
        # twin points (same coordinates and features) give the same box
        # in every slot: either way the list counts as the reference's
        same_set = np.array_equal(np.sort(roi_idx[b, :c]),
                                  np.sort(ref["roi_idx"][b, :c]))
        twins = bool((np.abs(got["rois"][b, :c] - ref["rois"][b, :c])
                      <= tol).all())
        whole = same_set or twins
        if not same.all():
            j = int(np.argmin(same))
            p, r = int(roi_idx[b, j]), int(ref["roi_idx"][b, j])
            gap = tie_gap(b, p, r)
            partings.append({"sample": b, "slot": j, "port": p, "ref": r,
                             "score_gap": gap, "allowed": near,
                             "same_set": same_set, "same_boxes": twins})
            print(f"parity / pointrcnn: sample {b} parts from the "
                  f"reference at RoI {j} (port point {p}, reference point "
                  f"{r}); score gap {gap:.3g} vs {near:.3g}; same set of "
                  f"RoIs: {same_set}, same box in every slot: {twins}",
                  flush=True)
            if gap > near:
                raise RuntimeError(
                    f"parity / pointrcnn: RoI {j} of sample {b} is no "
                    "near-tie")
        if twins and not same_set:  # slot by slot
            gi = ri = np.arange(c)
        else:  # RoIs from the same point, reference slot → port slot
            slot = {int(p): j for j, p in enumerate(roi_idx[b, :c])}
            pairs = [(slot[int(p)], j)
                     for j, p in enumerate(ref["roi_idx"][b, :c])
                     if int(p) in slot]
            gi = np.array([g for g, _ in pairs], np.int64)
            ri = np.array([r for _, r in pairs], np.int64)
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
    ``de6d_tpu_torch.ops.sparse`` is recorded with its inputs, in call
    order, and then run as usual."""
    from de6d_tpu_torch.ops import sparse as sp

    calls = {"neighbor_table": [], "sparse_conv": []}
    orig = (sp.neighbor_table, sp.sparse_conv)

    def table(*args, **kwargs):
        calls["neighbor_table"].append((args, kwargs))
        return orig[0](*args, **kwargs)

    def conv(*args):
        calls["sparse_conv"].append(args)
        return orig[1](*args)

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

    convs = dict(zip(SECOND_CONVS, calls["sparse_conv"]))
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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
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

    model, mc = phase_det6d_kernels(report)
    pts, mask = load_det6d_scans()
    report["serve_det6d"] = phase_serve(
        "serve / det6d", model, mc, 1, pts, mask,
        {"fps": fps.fps, "nms": nms}, 9, profile,
        per_batch={"fps": 3, "nms": 1})
    del model
    phase_det6d_parity(report)

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
               "second": report["serve_second"]["launches"]}
    kernels = []
    for key in ("canvas", "nms", "nms_mask", "fps", "matrix_fps", "lookup",
                "neighbor_table", "sparse_conv"):
        k = {f: report[key][f] for f in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
        per = {p: n[key] for p, n in by_path.items() if key in n}
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
