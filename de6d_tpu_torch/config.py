"""YAML-driven configuration system (the port's own copy of
``de6d_tpu/config.py``; the port imports nothing from the JAX package).

Recursive dict merge, ``_BASE_CONFIG_`` file inheritance, dotted-key
CLI overrides with literal-eval typing, and a self-contained
attribute-dict class instead of easydict.
"""

from __future__ import annotations

import ast
import copy
from pathlib import Path

import yaml


class Config(dict):
    """A dict with attribute access, recursively applied."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = {} if d is None else dict(d)
        d.update(kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Config._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, Config._wrap(v))

    def __setattr__(self, k, v):
        self[k] = v

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __delattr__(self, k):
        try:
            del self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def get(self, k, default=None):
        return super().get(k, default)

    def to_dict(self):
        def unwrap(v):
            if isinstance(v, Config):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return type(v)(unwrap(x) for x in v)
            return v

        return unwrap(self)


def merge_new_config(config: Config, new_config: dict) -> Config:
    """Recursively merge ``new_config`` into ``config`` (in place).

    Mirrors reference merge_new_config (config.py:51-68) including
    ``_BASE_CONFIG_`` expansion: the base yaml is loaded first, then
    overridden by the remaining keys.
    """
    if "_BASE_CONFIG_" in new_config:
        with open(new_config["_BASE_CONFIG_"], "r") as f:
            base = yaml.safe_load(f)
        merge_new_config(config, base)

    for key, val in new_config.items():
        if key == "_BASE_CONFIG_":
            continue
        if isinstance(val, dict):
            if key not in config or not isinstance(config[key], dict):
                config[key] = Config()
            merge_new_config(config[key], val)
        else:
            config[key] = copy.deepcopy(Config._wrap(val))
    return config


def cfg_from_yaml_file(cfg_file, config: Config | None = None) -> Config:
    """Load a yaml file (with _BASE_CONFIG_ inheritance) into a Config."""
    config = Config() if config is None else config
    with open(cfg_file, "r") as f:
        new_config = yaml.safe_load(f)
    merge_new_config(config, new_config)

    cfg_path = Path(cfg_file).resolve()
    config.TAG = cfg_path.stem
    # exp group path: path components between .../configs/ and the file
    parts = cfg_path.parts
    if "configs" in parts:
        i = len(parts) - 1 - parts[::-1].index("configs")
        config.EXP_GROUP_PATH = "/".join(parts[i + 1 : -1])
    else:
        config.EXP_GROUP_PATH = ""
    return config


def cfg_from_list(cfg_list, config: Config) -> None:
    """Set config keys via dotted-path CLI list, e.g.
    ``["MODEL.DENSE_HEAD.NMS_CONFIG.NMS_THRESH", "0.7"]``.

    Values are literal-eval'd when possible (reference config.py:16-48).
    """
    assert len(cfg_list) % 2 == 0, cfg_list
    for key, raw in zip(cfg_list[0::2], cfg_list[1::2]):
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        subtree = config
        key_parts = key.split(".")
        for part in key_parts[:-1]:
            assert part in subtree, f"config key path not found: {key}"
            subtree = subtree[part]
        last = key_parts[-1]
        if last in subtree and subtree[last] is not None:
            old = subtree[last]
            if isinstance(old, (list, tuple)) and isinstance(value, str):
                value = type(old)(ast.literal_eval(x) for x in value.split(","))
            else:
                assert old is None or isinstance(value, type(old)) or True
        subtree[last] = Config._wrap(value)


# Global config object (reference keeps one too, config.py:83-85).
ROOT_DIR = Path(__file__).resolve().parent.parent
cfg = Config()
cfg.ROOT_DIR = ROOT_DIR
cfg.LOCAL_RANK = 0
