from . import map_to_bev  # noqa: F401
from .base_bev_backbone import BaseBEVBackbone

__all__ = ["BaseBEVBackbone", "map_to_bev"]
