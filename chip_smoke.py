"""Smoke test of the PyTorch/CUDA port (``de6d_tpu_torch``) on one
NVIDIA card.

    python3 chip_smoke.py            # from the repository root
    python3 chip_smoke.py --profile  # also a torch.profiler breakdown

Phases, one status line each; any failure exits non-zero:

1. build   — compile ``de6d_tpu_torch/csrc/*.cu`` for sm_90a.
2. kernels — each CUDA kernel against its plain PyTorch version on the
             card at the main path's shapes (canvas bit-exact in bf16 and
             fp32; NMS keep flags identical on the realistic candidates
             of the first served batch and on a SCORE_THRESH 0 worst
             case), with timings and the card's bound.
3. serve   — ``StreamingDetector`` with ``configs/kitti_models/
             pointpillar.yaml`` in bf16, the trained
             ``bench_assets/pointpillar_params.npz`` and the 8 real scans
             of ``bench_assets/scans.npz`` at batch 8; both kernels'
             launch counters must rise.
4. parity  — the port in fp32 (TF32 off) on 2 scans against the stored
             JAX reference ``de6d_tpu_torch/testdata/pointpillar_jax_ref.npz``.

The line before the last is the card's name and power limit, the one
before it a JSON summary of the kernels, the last line
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

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

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
# H100 SXM fp32 outside the tensor cores, an FMA counted as two; the
# NMS library is built with -fmad=false, so its instructions issue at
# most at half this rate (33.5e12 per second).
FP32_FLOPS = 67e12
PARITY_TOL = 1e-3  # metres / score units, see the parity phase
SERVE_S = 5.0  # length of the pipelined serve window
SERIAL_BATCHES = 10
PROFILE_BATCHES = 20


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


def spec_from_cfg(cfg):
    from de6d_tpu_torch.models.detectors.detector3d_template import (
        DatasetSpec,
    )

    vox = [p for p in cfg.DATA_CONFIG.DATA_PROCESSOR
           if p["NAME"] == "transform_points_to_voxels"][0]
    return DatasetSpec(
        class_names=tuple(cfg.CLASS_NAMES),
        point_feature_dim=4,
        point_cloud_range=tuple(float(x) for x in
                                cfg.DATA_CONFIG.POINT_CLOUD_RANGE),
        voxel_size=tuple(float(x) for x in vox["VOXEL_SIZE"]),
        max_voxels=int(vox["MAX_NUMBER_OF_VOXELS"]["test"]),
        max_points_per_voxel=int(vox["MAX_POINTS_PER_VOXEL"]),
    )


def build_model(compute_dtype, dev):
    from de6d_tpu_torch import weights
    from de6d_tpu_torch.config import cfg_from_yaml_file
    from de6d_tpu_torch.models import build_network

    cfg = cfg_from_yaml_file(CFG)
    mc = copy.deepcopy(cfg.MODEL)
    mc["COMPUTE_DTYPE"] = compute_dtype
    model = build_network(mc, len(cfg.CLASS_NAMES), spec_from_cfg(cfg),
                          device=dev)
    weights.load_into(model, weights.load_flax_npz(PARAMS))
    return model, mc, len(cfg.CLASS_NAMES)


def load_scans():
    """The real scans as (8, N, 4) plus the bench's padding mask."""
    import numpy as np

    pts = np.load(SCANS)["points"].astype(np.float32)
    return pts, ~np.all(pts == 0, axis=-1)


# ---------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------

def nms_iou_count(boxes, counts, keep, thresh, post_k):
    """IoUs the NMS kernel evaluates on this input: per live column, the
    kept boxes tested up to the first suppressor, plus the live pairs of
    each diagonal tile. Replays the kernel's walk on the host."""
    import torch

    from de6d_tpu_torch.ops import iou3d
    from de6d_tpu_torch.ops.kernels.nms_fused import BLK

    total = 0
    packed = iou3d.pack_bev(boxes)
    for b in range(boxes.shape[0]):
        cnt = int(counts[b])
        kept = []
        for col0 in range(0, boxes.shape[1], BLK):
            if not (col0 < cnt and len(kept) < post_k):
                break
            cols = packed[b, :, col0:min(col0 + BLK, cnt)]
            n_live = cols.shape[1]
            if kept:
                idx = torch.tensor(kept, device=boxes.device)
                over = iou3d.pairwise_iou_packed(packed[b][:, idx], cols) > thresh
                hit = over.any(dim=0)
                first = torch.where(hit, over.int().argmax(dim=0) + 1,
                                    len(kept))
                total += int(first.sum())
                n_live = int((~hit).sum())
            total += n_live * (n_live - 1) // 2
            kb = keep[b, col0:col0 + BLK].nonzero().flatten() + col0
            kept.extend(kb.tolist())
    return total


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


def check_nms(cases, thresh, post_k, report):
    """cases: {label: (boxes (B, P, 7), counts (B,))}; the first case is
    the main path's and is timed for the JSON line."""
    import torch

    from de6d_tpu_torch.ops import iou3d
    from de6d_tpu_torch.ops.kernels import nms_fused
    from de6d_tpu_torch.ops.nms import _compact

    lines = {}
    for label, (boxes, counts) in cases.items():
        got = nms_fused.nms_keep_batched(boxes, counts, thresh, post_k)
        ref = nms_fused.nms_keep_batched_plain(boxes, counts, thresh, post_k)
        torch.cuda.synchronize()
        gs, gc = _compact(got, post_k)
        rs, rc = _compact(ref, post_k)
        if not (torch.equal(gc, rc) and torch.equal(gs, rs)):
            fail(f"nms {label}: selections differ from the plain version")
        err = float((got.int() - ref.int()).abs().max())
        ious = nms_iou_count(boxes, counts, ref, thresh, post_k)
        b, p = boxes.shape[:2]
        nbytes = 9 * 4 * int(counts.clamp(max=p).sum()) + b * p + b * 4
        flops = ious * nms_fused.FLOPS_PER_IOU
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS) * 1e3
        packed = iou3d.pack_bev(boxes).contiguous()
        lines[label] = {
            "max_abs_err": err,
            "ms": time_ms(lambda: nms_fused.nms_keep_batched(
                boxes, counts, thresh, post_k), 20),
            "kernel_ms": time_ms(lambda: nms_fused.nms_keep_packed(
                packed, counts, thresh, post_k), 20),
            "plain_ms": time_ms(lambda: nms_fused.nms_keep_batched_plain(
                boxes, counts, thresh, post_k), 2, warmup=1),
            "bound_ms": bound_ms,
            "bound_by": ("operations" if flops / FP32_FLOPS
                         > nbytes / HBM_BYTES_PER_S else "bytes"),
            "ious": ious,
            "kept": gc.tolist(),
            "shape": f"boxes ({b}, {p}, 7), live {counts.tolist()}",
        }
        print(f"kernels: nms {label}: identical selections, "
              f"{lines[label]['ms']:.4f} ms (kernel alone "
              f"{lines[label]['kernel_ms']:.4f} ms), plain "
              f"{lines[label]['plain_ms']:.2f} ms, bound "
              f"{bound_ms:.5f} ms, {ious} IoUs", flush=True)
    main = lines[next(iter(cases))]
    report["nms"] = {
        "name": "nms_keep_batched",
        "route": "cuda",
        "source": "de6d_tpu_torch/csrc/nms_fused.cu",
        "replaces": "de6d_tpu/ops/pallas/nms_fused.py:205",
        **{k: main[k] for k in ("max_abs_err", "ms", "kernel_ms", "plain_ms",
                                "bound_ms", "bound_by")},
        "library_ms": None,
        "cases": lines,
    }


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
        check_nms(cases, float(nms_cfg["NMS_THRESH"]),
                  int(nms_cfg["NMS_POST_MAXSIZE"]), report)
    return model, mc


# ---------------------------------------------------------------------
# serve and parity
# ---------------------------------------------------------------------

def phase_serve(model, mc, dev, report, profile):
    import numpy as np
    import torch

    from de6d_tpu_torch.ops.kernels import canvas, nms_fused
    from de6d_tpu_torch.serving.streaming import StreamingDetector

    pts, mask = load_scans()
    frames = [p[m] for p, m in zip(pts, mask)]  # padding rows dropped
    det = StreamingDetector(model, mc, 3, max_points=pts.shape[1],
                            device=dev)
    canvas.scatter_canvas.launches = 0
    nms_fused.nms_keep_batched.launches = 0
    warm = det.detect_batch(frames)
    lat = []
    for _ in range(SERIAL_BATCHES):
        s = time.perf_counter()
        det.detect_batch(frames)
        lat.append(time.perf_counter() - s)
    n_req = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < SERVE_S:
        det.submit_batch(frames)  # finished frames wait in the detector
        n_req += 1
    results = []
    while (r := det.result()) is not None:
        results.append(r)
    wall = time.perf_counter() - t0
    launches = {"canvas": canvas.scatter_canvas.launches,
                "nms": nms_fused.nms_keep_batched.launches}
    if len(results) != n_req * len(frames):
        fail(f"serve: {len(results)} results for {n_req * len(frames)} scans")
    for r in warm + results:
        if not (np.isfinite(r["boxes"]).all() and r["boxes"].shape[1] == 7
                and len(r["boxes"]) <= 500):
            fail("serve: non-finite or malformed boxes")
    if min(launches.values()) == 0:
        fail(f"serve: a kernel was not launched on the main path {launches}")
    counts = [len(r["boxes"]) for r in results]
    sps = n_req * len(frames) / wall
    serial_ms = float(np.median(lat)) * 1e3
    batches = n_req + 1 + SERIAL_BATCHES
    report["serve"] = {
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
    print(f"serve: {sps:.2f} scans/s pipelined (depth {det.depth}, "
          f"{n_req} batches in {wall:.2f} s), {1e3 / sps:.3f} ms/scan, "
          f"serial batch-of-8 median {serial_ms:.2f} ms over "
          f"{SERIAL_BATCHES}, mean pred_count {np.mean(counts):.2f}, "
          f"launches {launches} over {batches} batches", flush=True)
    if profile:
        phase_profile(det, frames, serial_ms, report)


def phase_profile(det, frames, serial_ms, report):
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
    report["profile"] = {"batches": n, "device_us_per_batch": total,
                         "idle_share_of_serial_batch": idle,
                         "top": [list(r) for r in rows[:25]]}
    print(f"profile: {total:.1f} us device time per batch of 8 over {n} "
          f"batches ({len(rows)} kernels); idle {idle:.1%} of the median "
          f"serial batch", flush=True)
    for name, us, n in rows[:12]:
        print(f"profile:   {us:10.1f} us  x{n:5.1f}  {name[:90]}")


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


def main():
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is False)")
    from de6d_tpu_torch.ops.kernels import build

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
        if "registers" in line or "Compiling entry" in line:
            print(f"build:   {line.strip()}")

    model, mc = phase_kernels("cuda", report)
    phase_serve(model, mc, "cuda", report, profile)
    del model
    phase_parity("cuda", report)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    report["nvidia_smi"] = smi
    report["seconds"] = time.perf_counter() - t_start
    launches = report["serve"]["launches"]
    kernels = []
    for key in ("canvas", "nms"):
        k = {f: report[key][f] for f in (
            "name", "route", "source", "replaces", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")}
        k["launches"] = launches[key]
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
