"""Model factory (counterpart of ``de6d_tpu/models/__init__.py``).

``build_network(model_cfg, num_class, dataset, device, generator)``
returns an eval-mode ``nn.Module`` composed from the registry by cfg NAME
strings, on ``device`` (default ``"cuda"``), its layers drawn as flax
initialises them; from ``generator`` (a CPU ``torch.Generator``, or a
``numpy.random.Generator`` for the same weights on every machine) where
one is given, else from torch's global generator.
"""

from __future__ import annotations

from .. import resolve_device
from ..registry import DETECTORS
from .model_utils.layers import init_flax_
from . import backbones_2d  # noqa: F401  (registers modules)
from . import backbones_3d  # noqa: F401
from . import dense_heads  # noqa: F401
from . import detectors  # noqa: F401
from . import roi_heads  # noqa: F401

_MODULE_SLOTS = (
    "VFE", "BACKBONE_3D", "MAP_TO_BEV", "PFE", "BACKBONE_2D",
    "DENSE_HEAD", "POINT_HEAD", "ROI_HEAD",
)


def build_network(model_cfg, num_class, dataset, device="cuda",
                  generator=None):
    # thread the model-level compute dtype into every module slot
    dtype_name = str(model_cfg.get("COMPUTE_DTYPE", "float32"))
    if dtype_name != "float32":
        for slot in _MODULE_SLOTS:
            if slot in model_cfg:
                model_cfg[slot]["_COMPUTE_DTYPE"] = dtype_name
    cls = DETECTORS.get(model_cfg["NAME"])
    model = cls(model_cfg=model_cfg, num_class=num_class, dataset=dataset)
    if generator is not None:
        init_flax_(model, generator)
    return model.to(resolve_device(device)).eval()
