"""YAML experiment configs → attribute namespaces.

Copy of `encodec_tpu/train/config.py` (`ConfigNamespace`, `config_to_dict`,
`load_config`, `parse_segment`). PyYAML is imported inside `load_config`
only: a machine without it can still build a model from a config given as
a dict (`ConfigNamespace(d)`) or load a `.json` config.
"""

from __future__ import annotations

import json
import os
import typing as tp


class ConfigNamespace:
    """Recursive dict → attribute access."""

    def __init__(self, dictionary: tp.Dict[str, tp.Any]):
        for key, value in dictionary.items():
            if isinstance(value, dict):
                value = ConfigNamespace(value)
            setattr(self, key, value)

    def get(self, key, default=None):
        return getattr(self, key, default)

    def __repr__(self):
        return f"ConfigNamespace({self.__dict__})"


def config_to_dict(cfg) -> dict:
    if isinstance(cfg, ConfigNamespace):
        return {k: config_to_dict(v) for k, v in cfg.__dict__.items()}
    return cfg


def load_config(filepath: str, log_dir: tp.Optional[str] = None) -> ConfigNamespace:
    """Load a YAML config (or JSON, by the `.json` suffix, which needs no
    PyYAML); optionally snapshot it into `log_dir` for resume, in the same
    format."""
    if filepath.endswith(".json"):
        with open(filepath, "r") as fh:
            config_dict = json.load(fh)
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            with open(os.path.join(log_dir, "config.json"), "w") as fh:
                json.dump(config_dict, fh)
        return ConfigNamespace(config_dict)
    import yaml

    with open(filepath, "r") as fh:
        config_dict = yaml.safe_load(fh)
    if log_dir:
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "config.yaml"), "w") as fh:
            yaml.dump(config_dict, fh)
    return ConfigNamespace(config_dict)


def parse_segment(value) -> tp.Optional[float]:
    """The reference stores segment as the *string* 'None' and eval()s it;
    parse it safely instead."""
    if value is None or value == "None":
        return None
    return float(value)
