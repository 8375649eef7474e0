"""Builds and loads the hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` into an object, and the objects are
linked into one shared library under ``de6d_tpu_torch/build/``, named by
a hash of the sources and flags. The library has a plain C interface
and is loaded with ``ctypes``; nothing here includes PyTorch's headers.
The build happens on first use, never at import.

``-fmad=false`` keeps ``nvcc`` from contracting ``a*b+c`` into FMAs so
the NMS kernels' IoU and the FPS kernel's distances round exactly like
their plain PyTorch versions; the sparse convolution writes its fp32
multiply-adds as explicit ``__fmaf_rn``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
SOURCES = ("canvas.cu", "nms_fused.cu", "nms_mask.cu", "fps.cu",
           "matrix_fps.cu", "lookup.cu", "sparse_conv.cu")
# included by the sources; part of the hash
HEADERS = ("iou_bev.cuh", "nms_pretest.cuh", "block_argmax.cuh",
           "cluster_argmax.cuh", "func_attr.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_lock = threading.Lock()
_lib = None
# facts about the last build in this process (for chip_smoke's report)
build_info: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
        Path("/usr/local/cuda/bin/nvcc")
    ]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile (if needed) and return the path of the shared library."""
    key = _digest()
    so = BUILD_DIR / f"libde6d_kernels_{key}.so"
    if so.exists():
        build_info.update(path=str(so), seconds=0.0, cached=True)
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name),
                   "-o", str(obj)]
            procs.append((name, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )))
        logs = {}
        for name, _, proc in procs:
            logs[name] = proc.communicate()[0]
        failed = [n for n, _, p in procs if p.returncode != 0]
        if failed:
            raise RuntimeError(
                "nvcc failed for " + ", ".join(failed) + ":\n"
                + "\n".join(logs[n] for n in failed)
            )
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp_so),
             *(str(o) for _, o, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_so, so)
    build_info.update(
        path=str(so), seconds=time.perf_counter() - t0, cached=False,
        ptxas="\n".join(logs[n] for n in SOURCES),
    )
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library with every entry point's C signature."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            handle.de6d_scatter_canvas.argtypes = [p, p, p, i, i, i, i, p]
            handle.de6d_scatter_canvas.restype = i
            handle.de6d_scatter_canvas_grad.argtypes = [p, p, p, i, i, i, i, p]
            handle.de6d_scatter_canvas_grad.restype = i
            handle.de6d_nms_keep_batched.argtypes = [
                p, i, p, p, p, i, i, f, i, i, p,
            ]
            handle.de6d_nms_keep_batched.restype = i
            handle.de6d_nms_pack_bev.argtypes = [p, i, p, i, i, p]
            handle.de6d_nms_pack_bev.restype = i
            handle.de6d_nms_mask.argtypes = [p, p, p, i, i, f, p]
            handle.de6d_nms_mask.restype = i
            handle.de6d_nms_resolve.argtypes = [p, p, p, p, i, i, i, p]
            handle.de6d_nms_resolve.restype = i
            handle.de6d_fps.argtypes = [p, p, p, p, i, i, i, i, p]
            handle.de6d_fps.restype = i
            handle.de6d_fps_dispatch.argtypes = [i, i, i]
            handle.de6d_fps_dispatch.restype = i
            handle.de6d_fps_threads.argtypes = [i, i]
            handle.de6d_fps_threads.restype = i
            handle.de6d_fps_cluster_rounds.argtypes = [i, i, i, i, p, p]
            handle.de6d_fps_cluster_rounds.restype = i
            handle.de6d_fps_argmax_rounds.argtypes = [i, i, p, p]
            handle.de6d_fps_argmax_rounds.restype = i
            handle.de6d_matrix_fps.argtypes = [p, p, p, i, i, i, i, p]
            handle.de6d_matrix_fps.restype = i
            handle.de6d_matrix_fps_dispatch.argtypes = [i, i]
            handle.de6d_matrix_fps_dispatch.restype = i
            handle.de6d_matrix_fps_threads.argtypes = [i, i]
            handle.de6d_matrix_fps_threads.restype = i
            handle.de6d_lookup.argtypes = [p, p, p, p, i, i, i, p]
            handle.de6d_lookup.restype = i
            handle.de6d_neighbor_table.argtypes = [
                p, p, p, p, i, i, i, ctypes.POINTER(i), p,
            ]
            handle.de6d_neighbor_table.restype = i
            handle.de6d_sparse_conv.argtypes = [
                p, p, p, p, p, p, i, i, i, i, i, i, i, i, p,
            ]
            handle.de6d_sparse_conv.restype = i
            handle.de6d_sparse_conv_plan.argtypes = [i, i, i, i, i, p]
            handle.de6d_sparse_conv_plan.restype = i
            handle.de6d_sparse_conv_last_variant.argtypes = []
            handle.de6d_sparse_conv_last_variant.restype = i
            handle.de6d_sparse_conv_wgrad.argtypes = [
                p, p, p, p, p, p, p, i, i, i, i, i, i, i, ctypes.c_longlong,
                i, p,
            ]
            handle.de6d_sparse_conv_wgrad.restype = i
            handle.de6d_sparse_conv_transpose.argtypes = [
                p, p, p, p, p, p, i, i, i, i, p,
            ]
            handle.de6d_sparse_conv_transpose.restype = i
            _lib = handle
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")

