"""Datasets and the host input pipeline (counterpart of
``de6d_tpu/datasets``): ``DatasetTemplate``, ``build_dataloader`` and the
KITTI and SlopedKITTI datasets, registered in ``registry.DATASETS``. The
other adapters (nuScenes, Waymo, Lyft, Pandaset) are not ported yet."""

from .dataset import DatasetTemplate
from .loader import build_dataloader
from .kitti import kitti_dataset  # noqa: F401  (registry)
from .slopedkitti import slopedkitti_dataset  # noqa: F401  (registry)

__all__ = ["DatasetTemplate", "build_dataloader"]
