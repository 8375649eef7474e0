"""Simple name→class registries used to compose detectors from yaml
(copy of ``de6d_tpu/registry.py``: modules register under the cfg
``NAME:`` string)."""

from __future__ import annotations


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._map: dict[str, type] = {}

    def register(self, cls=None, *, name: str | None = None):
        def _do(c):
            key = name or c.__name__
            if key in self._map and self._map[key] is not c:
                raise KeyError(f"duplicate {self.name} registry entry: {key}")
            self._map[key] = c
            return c

        return _do(cls) if cls is not None else _do

    def get(self, key: str):
        if key not in self._map:
            raise KeyError(
                f"unknown {self.name} '{key}'; known: {sorted(self._map)}"
            )
        return self._map[key]

    def __contains__(self, key):
        return key in self._map

    def keys(self):
        return sorted(self._map)


DETECTORS = Registry("detector")
VFE = Registry("vfe")
BACKBONES_3D = Registry("backbone_3d")
MAP_TO_BEV = Registry("map_to_bev")
PFE = Registry("pfe")
BACKBONES_2D = Registry("backbone_2d")
DENSE_HEADS = Registry("dense_head")
POINT_HEADS = Registry("point_head")
ROI_HEADS = Registry("roi_head")
DATASETS = Registry("dataset")
BOX_CODERS = Registry("box_coder")
