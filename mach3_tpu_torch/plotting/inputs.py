"""Fitter-agnostic input reading with translation configs (port of
``mach3_tpu/plotting/inputs.py``).

The equivalent of ``Plotting/PlottingUtils/InputManager.h:195-230``: the
reference reads fit outputs from *different fitting frameworks* and uses a
"translation config" to map parameter names across them, so plots can overlay
e.g. a MaCh3 chain against another fitter's scan.

Inputs are chain/scan ``.npz`` files (either package's) plus anything
conforming to the simple dict protocol; translation configs are YAML::

    Translations:
      OtherFitter:
        delta_cp: dcp
        sin2th23: theta23_sq
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np

from ..core.config import Config
from ..core.exceptions import ConfigError
from ..core.logging import get_logger

_log = get_logger("plotting")


@dataclasses.dataclass
class FitInput:
    """One loaded fit result: draws and/or scans keyed by canonical names."""

    label: str
    names: list[str]
    draws: np.ndarray | None = None  # [N, P] flattened posterior draws
    scans: dict[str, np.ndarray] | None = None  # name -> [2, K] (values, dllh)

    def index_of(self, name: str) -> int:
        try:
            return self.names.index(name)
        except ValueError:
            raise ConfigError(f"Parameter '{name}' not in input '{self.label}'") from None


class InputManager:
    """Load chain/scan files and align parameter names via translations."""

    def __init__(self, translation_config: Config | Mapping[str, Any] | None = None):
        if translation_config is not None and not isinstance(translation_config, Config):
            translation_config = Config(translation_config)
        self._translations: dict[str, dict[str, str]] = {}
        if translation_config is not None:
            for fitter, mapping in dict(translation_config.get("Translations", {})).items():
                self._translations[fitter] = {str(k): str(v) for k, v in dict(mapping).items()}
        self.inputs: list[FitInput] = []

    def translate(self, fitter: str, canonical: str) -> str:
        """Canonical -> fitter-specific parameter name."""
        return self._translations.get(fitter, {}).get(canonical, canonical)

    def add_chain(self, path: str, label: str | None = None, fitter: str = "", burn_in: float = 0.2) -> FitInput:
        from ..diagnostics.chain_io import load_chain

        draws, meta, _ = load_chain(path)
        theta = draws["theta"]
        if theta.ndim == 3:
            theta = theta[int(burn_in * theta.shape[0]) :].reshape(-1, theta.shape[-1])
        names = list(meta["names"])
        if fitter in self._translations:
            reverse = {v: k for k, v in self._translations[fitter].items()}
            names = [reverse.get(n, n) for n in names]
        fi = FitInput(label=label or path, names=names, draws=theta)
        self.inputs.append(fi)
        _log.info("Loaded chain %s: %d draws, %d params", path, len(theta), len(names))
        return fi

    def add_llh_scan(self, path: str, label: str | None = None, fitter: str = "") -> FitInput:
        """Load an npz produced by mach3-llhscan (scan1d_* arrays)."""
        with np.load(path, allow_pickle=False) as f:
            names = [str(n) for n in f["names"]]
            values = f["scan1d_values"]
            total = f["scan1d_total"]
        if fitter in self._translations:
            reverse = {v: k for k, v in self._translations[fitter].items()}
            names = [reverse.get(n, n) for n in names]
        scans = {
            n: np.stack([values[i], total[i] - total[i].min()])
            for i, n in enumerate(names)
        }
        fi = FitInput(label=label or path, names=names, scans=scans)
        self.inputs.append(fi)
        return fi

    def overlay_scans(self, canonical_names: list[str]):
        """Figure overlaying 1D LLH scans across all loaded inputs
        (``PlotLLH.cpp`` multi-fitter overlay)."""
        from .plots import _mpl

        plt = _mpl()
        n = len(canonical_names)
        cols = min(3, n)
        rows = (n + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(4.5 * cols, 3 * rows), squeeze=False)
        for k, name in enumerate(canonical_names):
            ax = axes[k // cols][k % cols]
            for fi in self.inputs:
                if fi.scans and name in fi.scans:
                    v, d = fi.scans[name]
                    ax.plot(v, d, label=fi.label)
                elif fi.draws is not None and name in fi.names:
                    # posterior -> effective -2lnL profile via histogram
                    x = fi.draws[:, fi.index_of(name)]
                    counts, edges = np.histogram(x, bins=60)
                    centers = 0.5 * (edges[:-1] + edges[1:])
                    with np.errstate(divide="ignore"):
                        dllh = -np.log(np.maximum(counts, 1e-300) / counts.max())
                    ax.plot(centers, dllh, ls="--", label=f"{fi.label} (posterior)")
            ax.set_title(name, fontsize=9)
            ax.set_ylabel(r"$\Delta(-\ln L)$", fontsize=8)
            if k == 0:
                ax.legend(fontsize=7)
        for k in range(n, rows * cols):
            axes[k // cols][k % cols].axis("off")
        fig.tight_layout()
        return fig
