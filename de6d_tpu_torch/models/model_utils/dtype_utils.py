"""Compute-dtype plumbing (counterpart of
``de6d_tpu/models/model_utils/dtype_utils.py``).

Opt in per model with ``MODEL.COMPUTE_DTYPE: bfloat16``;
:func:`de6d_tpu_torch.models.build_network` threads the choice into
every module-slot cfg as ``_COMPUTE_DTYPE``. Parameters stay fp32 and
are cast at use; heads cast raw predictions back to fp32 before
decode/NMS.
"""

from __future__ import annotations

import torch

_DTYPES = {
    "float32": torch.float32,
    "fp32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def compute_dtype(model_cfg) -> torch.dtype:
    """Compute dtype for a module-slot cfg (default fp32); unknown names
    raise instead of silently running fp32."""
    name = str(model_cfg.get("_COMPUTE_DTYPE", "float32")).lower()
    if name not in _DTYPES:
        raise ValueError(
            f"Unknown COMPUTE_DTYPE {name!r}; expected one of {sorted(_DTYPES)}"
        )
    return _DTYPES[name]
