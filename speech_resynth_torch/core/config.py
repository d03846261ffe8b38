"""YAML config tree with ``${a.b}`` interpolation.

The port's copy of speech_resynth_tpu/core/config.py: nested dot access,
absolute-path interpolation inside strings, and ``cfg.key`` / ``cfg["key"]``
access. PyYAML is imported only by ``load_config``; ``config_from_dict``
works without it.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Iterator, Mapping

_INTERP_RE = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


class Config(Mapping[str, Any]):
    """Nested mapping with attribute access and interpolation."""

    def __init__(self, data: dict, _root: "Config | None" = None):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_root", _root if _root is not None else self)

    # -- mapping protocol ---------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._wrap(self._data[key])

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        if key.startswith("_"):
            raise AttributeError(key)
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"config has no key {key!r}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        self._data[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        try:
            return self[key]
        except KeyError:
            return default

    # -- internals ----------------------------------------------------------
    def _wrap(self, value: Any) -> Any:
        if isinstance(value, dict):
            return Config(value, self._root)
        if isinstance(value, str):
            return self._interpolate(value)
        if isinstance(value, list):
            return [self._wrap(v) for v in value]
        return value

    def _interpolate(self, s: str) -> Any:
        m = _INTERP_RE.fullmatch(s)
        if m:  # whole-string interpolation keeps the referenced type
            return self._resolve(m.group(1))
        return _INTERP_RE.sub(lambda m: str(self._resolve(m.group(1))), s)

    def _resolve(self, dotted: str) -> Any:
        node: Any = self._root
        for part in dotted.split("."):
            node = node[part]
        return node

    def to_dict(self) -> dict:
        """Fully resolved plain dict (interpolations applied)."""
        out: dict = {}
        for k in self._data:
            v = self[k]
            if isinstance(v, Config):
                v = v.to_dict()
            elif isinstance(v, list):
                v = [x.to_dict() if isinstance(x, Config) else x for x in v]
            out[k] = v
        return out

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def load_config(path: str | Path) -> Config:
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    if not isinstance(data, dict):
        raise ValueError(f"config root must be a mapping: {path}")
    return Config(data)


def config_from_dict(data: dict) -> Config:
    return Config(dict(data))
