"""YAML + dotlist config system — a copy of
``animate_anything_tpu/core/config.py``.

The CLI surface: ``--config file.yaml [--eval] key.subkey=value ...``, where
trailing dotlist entries override YAML keys (OmegaConf's semantics on plain
dicts, without interpolation).
"""

from __future__ import annotations

import copy
import json
from typing import Any, Iterable, Mapping

import yaml


class Config(dict):
    """A dict with attribute access, recursive wrapping, and deep merge.

    ``cfg.train_data.width`` == ``cfg["train_data"]["width"]``.  Missing
    attribute access raises AttributeError (not KeyError) so hasattr works.
    """

    def __init__(self, data: Mapping[str, Any] | None = None, **kw: Any):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = v
        for k, v in kw.items():
            self[k] = v

    # -- wrapping ---------------------------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, _wrap(value))

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(key) from e

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    # -- helpers ----------------------------------------------------------
    def get_path(self, dotted: str, default: Any = None) -> Any:
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node

    def set_path(self, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        node: Config = self
        for part in parts[:-1]:
            if part not in node or not isinstance(node[part], Config):
                node[part] = Config()
            node = node[part]
        node[parts[-1]] = value

    def merge(self, other: Mapping[str, Any]) -> "Config":
        for k, v in other.items():
            if k in self and isinstance(self[k], Config) and isinstance(v, Mapping):
                self[k].merge(v)
            else:
                self[k] = v
        return self

    def to_dict(self) -> dict:
        def unwrap(v: Any) -> Any:
            if isinstance(v, Config):
                return v.to_dict()
            if isinstance(v, list):
                return [unwrap(x) for x in v]
            return v

        return {k: unwrap(v) for k, v in self.items()}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)

    def __repr__(self) -> str:  # compact, stable
        return f"Config({json.dumps(self.to_dict(), default=str)})"


def _wrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value
    if isinstance(value, Mapping):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return [_wrap(v) for v in value]
    return value


def _parse_value(text: str) -> Any:
    """YAML-typed scalar parse: '1'→int, '1e-4'→float, 'true'→bool, else str.

    YAML 1.1 only floats '1.0e-4' (with a dot), so exponent-only literals get a
    dedicated float fallback — the reference relies on OmegaConf accepting
    'learning_rate=5e-6' style overrides."""
    try:
        value = yaml.safe_load(text)
    except yaml.YAMLError:
        return text
    if isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            return value
    return value


def merge_dotlist(cfg: Config, dotlist: Iterable[str]) -> Config:
    """Apply ``key.subkey=value`` overrides (reference CLI parity)."""
    for item in dotlist:
        if "=" not in item:
            raise ValueError(f"dotlist override must look like key=value, got {item!r}")
        key, _, raw = item.partition("=")
        cfg.set_path(key.strip(), _parse_value(raw))
    return cfg


def load_config(path: str, overrides: Iterable[str] = ()) -> Config:
    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"config root must be a mapping: {path}")
    cfg = Config(data)
    merge_dotlist(cfg, overrides)
    return cfg
