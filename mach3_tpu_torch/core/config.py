"""YAML configuration manager.

Equivalent of the reference's ``Manager`` (``Manager/Manager.h:16-63``)
plus the typed-getter helpers of ``Manager/YamlHelper.h:36-434``:

* typed access with defaults and throw-with-context (``Get``/``GetFromManager``),
* config override strings ``Key:Subkey:Value`` (``YamlHelper.h``: ``OverrideConfig``),
* recursive node merging for ``--override second.yaml`` (``MergeNodes``),
* round-trip of the full config into output files so a fit is reproducible from
  its own artifacts (``Manager/Manager.cpp`` saves config as TMacro; we embed the
  YAML string in every chain output).
"""
from __future__ import annotations

import copy
import io
from typing import Any, Iterable, Mapping, Sequence

import yaml

from .exceptions import ConfigError

_MISSING = object()


def _parse_scalar(text: str) -> Any:
    """Parse a CLI override value: int, then float (so '1e6' is numeric — YAML
    1.1 would keep it a string), then YAML scalar rules (bools, lists, null)."""
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def merge_trees(base: Any, override: Any) -> Any:
    """Recursively merge ``override`` into ``base`` (reference ``MergeNodes``).

    Mappings merge key-by-key; anything else in ``override`` replaces ``base``.
    """
    if isinstance(base, Mapping) and isinstance(override, Mapping):
        merged = dict(base)
        for key, val in override.items():
            merged[key] = merge_trees(base[key], val) if key in base else copy.deepcopy(val)
        return merged
    return copy.deepcopy(override)


class Config:
    """A nested YAML configuration tree with typed, path-based access."""

    def __init__(self, tree: Mapping[str, Any] | None = None, source: str = "<dict>"):
        self._tree: dict[str, Any] = dict(tree or {})
        self.source = source

    # ------------------------------------------------------------------ IO
    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path) as f:
            tree = yaml.safe_load(f) or {}
        if not isinstance(tree, Mapping):
            raise ConfigError(f"Top level of {path} is not a mapping")
        return cls(tree, source=path)

    @classmethod
    def from_yaml(cls, text: str, source: str = "<string>") -> "Config":
        tree = yaml.safe_load(io.StringIO(text)) or {}
        return cls(tree, source=source)

    def to_yaml(self) -> str:
        return yaml.safe_dump(self._tree, sort_keys=False)

    @property
    def tree(self) -> dict[str, Any]:
        return self._tree

    # ------------------------------------------------------------- access
    @staticmethod
    def _split(path: str | Sequence[str]) -> list[str]:
        if isinstance(path, str):
            return path.replace(":", ".").split(".")
        return list(path)

    def get(self, path: str | Sequence[str], default: Any = _MISSING) -> Any:
        """Typed getter. Raises ``ConfigError`` naming the full path when a
        required key is missing (reference ``YamlHelper.h:290-350``)."""
        node: Any = self._tree
        keys = self._split(path)
        for i, key in enumerate(keys):
            if isinstance(node, Mapping) and key in node:
                node = node[key]
            elif isinstance(node, Sequence) and not isinstance(node, str) and key.isdigit():
                idx = int(key)
                if idx >= len(node):
                    node = _MISSING
                else:
                    node = node[idx]
            else:
                node = _MISSING
            if node is _MISSING:
                if default is _MISSING:
                    raise ConfigError(
                        f"Missing config key '{'.'.join(keys[: i + 1])}' in {self.source}"
                    )
                return default
        return node

    def has(self, path: str | Sequence[str]) -> bool:
        return self.get(path, default=_MISSING_SENTINEL) is not _MISSING_SENTINEL

    def sub(self, path: str | Sequence[str]) -> "Config":
        node = self.get(path)
        if not isinstance(node, Mapping):
            raise ConfigError(f"Config key '{path}' is not a mapping in {self.source}")
        return Config(node, source=f"{self.source}:{path}")

    # ---------------------------------------------------------- overrides
    def override(self, *specs: str) -> "Config":
        """Apply ``Key:Subkey:Value`` CLI overrides (``MaCh3Factory.cpp:41-80``).

        The last ``:``-separated token is the value; everything before is the path.
        Returns self for chaining.
        """
        for spec in specs:
            parts = spec.split(":")
            if len(parts) < 2:
                raise ConfigError(f"Override '{spec}' must be Key:Value or Key:Sub:Value")
            *keys, raw_value = parts
            node = self._tree
            for key in keys[:-1]:
                node = node.setdefault(key, {})
                if not isinstance(node, dict):
                    raise ConfigError(f"Override '{spec}' walks through non-mapping '{key}'")
            node[keys[-1]] = _parse_scalar(raw_value)
        return self

    def merge(self, other: "Config | Mapping[str, Any]") -> "Config":
        tree = other.tree if isinstance(other, Config) else other
        self._tree = merge_trees(self._tree, tree)
        return self

    def __repr__(self) -> str:
        return f"Config({self.source})"


_MISSING_SENTINEL = object()


def load_configs(paths: Iterable[str], overrides: Sequence[str] = ()) -> Config:
    """Load one or more YAML files, merging later ones in, then apply overrides."""
    cfg: Config | None = None
    for p in paths:
        nxt = Config.from_file(p)
        cfg = nxt if cfg is None else cfg.merge(nxt)
    if cfg is None:
        cfg = Config()
    cfg.override(*overrides)
    return cfg
