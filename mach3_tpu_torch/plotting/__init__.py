"""Matplotlib plotting of chains, scans and diagnostics (port of
``mach3_tpu/plotting``; numpy on the host, matplotlib imported when a plot
is drawn)."""
from .style import StyleManager
from .plots import (
    plot_diagnostics,
    plot_llh_scans,
    plot_matrix,
    plot_posterior_comparison,
    plot_posteriors_1d,
    plot_prefit_postfit,
    plot_sigma_variations,
    plot_triangle,
    plot_violins,
)

__all__ = [
    "StyleManager",
    "plot_diagnostics",
    "plot_llh_scans",
    "plot_matrix",
    "plot_posterior_comparison",
    "plot_posteriors_1d",
    "plot_prefit_postfit",
    "plot_sigma_variations",
    "plot_triangle",
    "plot_violins",
]
