"""Named parameter-value sets ("tunes").

Port of ``mach3_tpu/params/tunes.py`` (numpy), the equivalent of
``Parameters/ParameterTunes.h/.cpp``: YAML-defined
named value sets (e.g. "PostND", "Asimov") applied to a ParameterSet by name.

YAML schema::

    Tunes:
      - Name: PostND
        Values:
          norm_ccqe: 1.05
          spl_maqe: 0.3
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np

from ..core.config import Config
from ..core.exceptions import ConfigError
from .parameterset import ParameterSet


class ParameterTunes:
    def __init__(self, cfg: Config | Mapping[str, Any]):
        if not isinstance(cfg, Config):
            cfg = Config(cfg)
        self.tunes: dict[str, dict[str, float]] = {}
        for entry in cfg.get("Tunes"):
            e = Config(entry)
            name = str(e.get("Name"))
            if name in self.tunes:
                raise ConfigError(f"Duplicate tune '{name}'")
            self.tunes[name] = {str(k): float(v) for k, v in dict(e.get("Values")).items()}

    def names(self) -> list[str]:
        return list(self.tunes)

    def get_tune(self, name: str) -> dict[str, float]:
        if name not in self.tunes:
            raise ConfigError(f"Unknown tune '{name}' (have: {', '.join(self.tunes)})")
        return self.tunes[name]

    def apply(self, ps: ParameterSet, name: str, base: np.ndarray | None = None) -> np.ndarray:
        """Return a parameter vector with the tune's values set (others from
        ``base`` or the prefit)."""
        theta = np.array(base if base is not None else ps.prefit, np.float64)
        for pname, val in self.get_tune(name).items():
            theta[ps.index_of(pname)] = val
        return theta
