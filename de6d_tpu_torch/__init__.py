"""PyTorch/CUDA port of ``de6d_tpu`` for NVIDIA Hopper.

Module paths mirror the JAX package so each module's counterpart is
easy to find. Public layouts follow the JAX package too: BEV canvases
are NHWC ``(B, ny, nx, C)``, boxes are ``(..., 7)``, voxel coords are
``(z, y, x)``. The package imports torch, numpy and yaml only — never
jax, flax or anything under ``de6d_tpu``.

Entry points default to ``device="cuda"`` and raise on a machine
without a card; pass ``device="cpu"`` explicitly to run the plain
PyTorch versions of the kernels.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path"
        )
    return dev
