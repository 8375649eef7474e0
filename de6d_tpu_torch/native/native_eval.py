"""ctypes binding + on-demand build for the native eval kernel.

Port copy of ``de6d_tpu/native/native_eval.py``. Builds
libkitti_match.so with g++ on first use (never at import) into
``de6d_tpu_torch/build/``, named by a hash of the source and the flags.
Falls back gracefully (available() → False) when no compiler is
present; callers then use the bit-identical Python kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "kitti_match.cpp"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_BUILD_DIR = _HERE.parent / "build"
_lib = None
_tried = False


def _so_path() -> Path:
    tag = hashlib.sha1(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libkitti_match_{tag.hexdigest()[:12]}.so"


def _build(so: Path):
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(so.name + ".tmp")
    subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                   check=True, capture_output=True)
    tmp.replace(so)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = _so_path()
        if not so.exists():
            _build(so)
        lib = ctypes.CDLL(str(so))
        lib.fused_statistics.restype = None
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def fused_statistics(overlaps, gt_datas_list, dt_datas_list, ignored_gts,
                     ignored_dets, dontcares, metric, min_overlap,
                     thresholds, compute_aos):
    """Same contract as the Python fallback in kitti_eval.py."""
    lib = _load()
    n_frames = len(overlaps)
    gt_nums = np.array([g.shape[0] for g in gt_datas_list], np.int32)
    dt_nums = np.array([d.shape[0] for d in dt_datas_list], np.int32)
    dc_nums = np.array([d.shape[0] for d in dontcares], np.int32)

    ov_sizes = np.array([o.size for o in overlaps], np.int64)
    ov_offsets = np.concatenate([[0], np.cumsum(ov_sizes)[:-1]])
    gt_offsets = np.concatenate([[0], np.cumsum(gt_nums.astype(np.int64))[:-1]])
    dt_offsets = np.concatenate([[0], np.cumsum(dt_nums.astype(np.int64))[:-1]])
    dc_offsets = np.concatenate([[0], np.cumsum(dc_nums.astype(np.int64))[:-1]])

    def cat(arrs, width, dtype=np.float64):
        if sum(a.shape[0] for a in arrs) == 0:
            return np.zeros((1, width), dtype)
        return np.ascontiguousarray(
            np.concatenate([a.reshape(-1, width) for a in arrs], 0), dtype
        )

    overlaps_flat = (
        np.concatenate([np.ascontiguousarray(o, np.float64).ravel() for o in overlaps])
        if sum(o.size for o in overlaps)
        else np.zeros(1)
    )
    gt_flat = cat(gt_datas_list, 5)
    dt_flat = cat(dt_datas_list, 6)
    dc_flat = cat(dontcares, 4)
    igt_flat = (
        np.ascontiguousarray(np.concatenate(ignored_gts), np.int64)
        if sum(len(x) for x in ignored_gts) else np.zeros(1, np.int64)
    )
    idt_flat = (
        np.ascontiguousarray(np.concatenate(ignored_dets), np.int64)
        if sum(len(x) for x in ignored_dets) else np.zeros(1, np.int64)
    )
    thr = np.ascontiguousarray(thresholds, np.float64)
    pr = np.zeros((len(thresholds), 4), np.float64)

    c_double_p = ctypes.POINTER(ctypes.c_double)
    c_int_p = ctypes.POINTER(ctypes.c_int)
    c_int64_p = ctypes.POINTER(ctypes.c_int64)

    def dp(a):
        return a.ctypes.data_as(c_double_p)

    def ip(a):
        return np.ascontiguousarray(a).ctypes.data_as(c_int_p)

    def lp(a):
        return np.ascontiguousarray(a, np.int64).ctypes.data_as(c_int64_p)

    lib.fused_statistics(
        dp(overlaps_flat), lp(ov_offsets),
        ip(gt_nums), ip(dt_nums), ctypes.c_int(n_frames),
        dp(gt_flat), lp(gt_offsets),
        dp(dt_flat), lp(dt_offsets),
        lp(igt_flat), lp(idt_flat),
        dp(dc_flat), ip(dc_nums), lp(dc_offsets),
        ctypes.c_int(metric), ctypes.c_double(float(min_overlap)),
        dp(thr), ctypes.c_int(len(thresholds)), ctypes.c_int(int(compute_aos)),
        dp(pr),
    )
    return pr
