"""Style layer for all plots — the reference StyleManager equivalent (port
of ``mach3_tpu/plotting/style.py``).

The counterpart of ``Plotting/PlottingUtils/StyleManager.h``: the
reference loads a style YAML (palettes, "fancy" TLatex parameter names,
histogram/legend styling) and applies it to ROOT objects. Here the same
config drives matplotlib: a colour palette, rcParams overrides, and pretty
(math-text) parameter labels with sensible physics defaults.

Style YAML schema::

    Style:
      Palette: ["#1f77b4", "#ff7f0e", ...]   # or a named mpl colormap
      rcParams:
        font.size: 11
        axes.grid: true
      PrettyNames:
        xsec_norm_ccqe: "CCQE norm"
        osc_delta_cp: "$\\delta_{CP}$"

All entries are optional; ``StyleManager()`` with no config gives the
defaults used throughout ``plotting/plots.py``.
"""
from __future__ import annotations

import contextlib
import re
from typing import Any, Iterable, Mapping

from ..core.config import Config
from ..core.logging import get_logger

_log = get_logger("plotting")

#: Built-in pretty names for the standard oscillation block (matched after
#: stripping any handler prefix like ``osc_`` / ``xsec_``).
_DEFAULT_PRETTY = {
    "sin2th12": r"$\sin^2\theta_{12}$",
    "sin2th13": r"$\sin^2\theta_{13}$",
    "sin2th23": r"$\sin^2\theta_{23}$",
    "delta_cp": r"$\delta_{CP}$",
    "dm2_21": r"$\Delta m^2_{21}$",
    "dm2_31": r"$\Delta m^2_{31}$",
}

_DEFAULT_PALETTE = [
    "#4477aa", "#ee6677", "#228833", "#ccbb44",
    "#66ccee", "#aa3377", "#bbbbbb", "#000000",
]

_DEFAULT_RC = {
    "figure.dpi": 110,
    "axes.grid": True,
    "grid.alpha": 0.3,
    "legend.frameon": False,
    "axes.prop_cycle": None,  # filled from the palette in apply()
}


class StyleManager:
    """Palette + rcParams + pretty-name lookup, YAML-configurable."""

    def __init__(self, config: Config | Mapping[str, Any] | str | None = None):
        if isinstance(config, str):
            config = Config.from_file(config)
        if isinstance(config, Config):
            raw = config.get("Style", default={}) or {}
        elif config:
            raw = dict(config).get("Style", dict(config))
        else:
            raw = {}
        palette = raw.get("Palette", _DEFAULT_PALETTE)
        if isinstance(palette, str):  # a named matplotlib colormap
            import matplotlib.cm as cm
            import matplotlib.colors as mcolors

            cmap = cm.get_cmap(palette)
            palette = [mcolors.to_hex(cmap(i / 7)) for i in range(8)]
        self.palette: list[str] = list(palette)
        self.rcparams: dict[str, Any] = dict(raw.get("rcParams", {}) or {})
        self.pretty: dict[str, str] = dict(_DEFAULT_PRETTY)
        self.pretty.update(raw.get("PrettyNames", {}) or {})

    # ------------------------------------------------------------- colours
    def color(self, i: int) -> str:
        return self.palette[i % len(self.palette)]

    def cycle(self) -> list[str]:
        return list(self.palette)

    # -------------------------------------------------------------- labels
    def pretty_name(self, name: str) -> str:
        """Fancy label for a parameter: exact match first, then with the
        handler prefix stripped, else the raw name with underscores escaped
        (matplotlib mathtext treats bare ``_`` as subscript errors)."""
        if name in self.pretty:
            return self.pretty[name]
        stripped = re.sub(r"^(xsec|osc|flux|det|detector)_", "", name)
        if stripped in self.pretty:
            return self.pretty[stripped]
        return name.replace("_", " ")

    def pretty_names(self, names: Iterable[str]) -> list[str]:
        return [self.pretty_name(n) for n in names]

    # ------------------------------------------------------------ rcParams
    def apply(self) -> None:
        """Push palette + rcParams into matplotlib global state."""
        import matplotlib as mpl
        from cycler import cycler

        rc = {**_DEFAULT_RC, **self.rcparams}
        rc["axes.prop_cycle"] = cycler(color=self.palette)
        for k, v in rc.items():
            try:
                mpl.rcParams[k] = v
            except (KeyError, ValueError) as e:
                _log.warning("Ignoring invalid rcParam %s=%r (%s)", k, v, e)

    @contextlib.contextmanager
    def context(self):
        """Scoped application (restores previous matplotlib state)."""
        import matplotlib as mpl

        with mpl.rc_context():
            self.apply()
            yield self
