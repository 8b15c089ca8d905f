"""Generator interaction-mode translation.

Port of ``mach3_tpu/core/modes.py`` (numpy), the equivalent of
``Manager/MaCh3Modes.h/.cpp``: a YAML-defined mapping
from generator mode IDs (NEUT/GENIE/...) to analysis mode categories, with
per-mode metadata (fancy name, plot colour, NC flag, spline suffix).

YAML schema (mirrors the reference ``MaCh3Modes.h:52-79``)::

    Title: NEUT modes
    GeneratorName: NEUT
    Modes:
      - Name: CCQE
        FancyName: "CCQE"
        GeneratorMaping: [1]
        IsNC: false
        PlotColor: 600
        SplineSuffix: ccqe
      - ...
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from .config import Config
from .exceptions import ConfigError


@dataclasses.dataclass
class ModeInfo:
    """Per-mode metadata (``MaCh3ModeInfo``, ``MaCh3Modes.h:37-50``)."""

    name: str
    fancy_name: str
    index: int
    generator_ids: list[int]
    is_nc: bool = False
    plot_color: int | str = 0
    spline_suffix: str = ""


class MaCh3Modes:
    """Mode registry + generator-ID lookup table."""

    def __init__(self, cfg: Config | Mapping[str, Any]):
        if not isinstance(cfg, Config):
            cfg = Config(cfg)
        self.title = str(cfg.get("Title", "Modes"))
        self.generator = str(cfg.get("GeneratorName", "Generator"))
        self.modes: list[ModeInfo] = []
        self._by_name: dict[str, ModeInfo] = {}
        for i, entry in enumerate(cfg.get("Modes")):
            e = Config(entry)
            info = ModeInfo(
                name=str(e.get("Name")),
                fancy_name=str(e.get("FancyName", e.get("Name"))),
                index=i,
                generator_ids=[int(x) for x in e.get("GeneratorMaping", [])],
                is_nc=bool(e.get("IsNC", False)),
                plot_color=e.get("PlotColor", 0),
                spline_suffix=str(e.get("SplineSuffix", "")),
            )
            if info.name in self._by_name:
                raise ConfigError(f"Duplicate mode name {info.name}")
            self.modes.append(info)
            self._by_name[info.name] = info

        # Generator-ID -> mode-index lookup (kMaCh3_nModes = unknown sentinel).
        max_id = max((max(m.generator_ids, default=0) for m in self.modes), default=0)
        self._gen_table = np.full(max_id + 1, self.n_modes, np.int32)
        for m in self.modes:
            for g in m.generator_ids:
                if g < 0:
                    raise ConfigError(f"Negative generator id {g} for {m.name}")
                self._gen_table[g] = m.index

    @property
    def n_modes(self) -> int:
        return len(self.modes)

    def get_mode(self, name: str) -> ModeInfo:
        """``GetMode(name)``; unknown names raise."""
        if name not in self._by_name:
            raise ConfigError(f"Unknown mode '{name}' in {self.title}")
        return self._by_name[name]

    def mode_from_generator(self, generator_id: int | np.ndarray) -> np.ndarray:
        """``GetModeFromGenerator``: vectorised generator-ID translation;
        out-of-table IDs map to the unknown sentinel (n_modes)."""
        g = np.asarray(generator_id, np.int64)
        clipped = np.clip(g, 0, len(self._gen_table) - 1)
        out = self._gen_table[clipped]
        return np.where((g < 0) | (g >= len(self._gen_table)), self.n_modes, out)

    def nc_mode_indices(self) -> list[int]:
        return [m.index for m in self.modes if m.is_nc]
