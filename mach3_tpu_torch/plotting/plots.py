"""Matplotlib plotting suite (port of ``mach3_tpu/plotting/plots.py``).

The equivalent of the reference's ROOT plotting stack
(``Plotting/PlottingUtils``, ``GetPostfitParamPlots.cpp``, ``PlotLLH.cpp``,
``PlotSigmaVariation.cpp``, ``MatrixPlotter.cpp``; triangle/violin machinery in
``MCMCProcessor``). All functions take processed arrays (from
``diagnostics.processor`` / ``fitters.scans``) and return matplotlib figures.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def _mpl():
    """matplotlib's pyplot on the Agg backend, imported at the first plot
    (the package imports without matplotlib; drawing needs it)."""
    try:
        import matplotlib
    except ImportError as err:
        raise ImportError("plotting needs matplotlib, which is not installed") from err

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_posteriors_1d(proc, indices: Sequence[int] | None = None, bins: int = 80):
    """Grid of 1D posteriors with arithmetic/HPD markers (``MakePostfit``)."""
    plt = _mpl()
    indices = list(indices) if indices is not None else list(range(proc.n_params))
    n = len(indices)
    cols = min(4, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows), squeeze=False)
    for k, i in enumerate(indices):
        ax = axes[k // cols][k % cols]
        centers, counts = proc.posterior_1d(i, bins=bins)
        s = proc.summary(i)
        ax.fill_between(centers, counts, step="mid", alpha=0.6)
        ax.axvline(s.arithmetic_mean, color="C1", ls="--", lw=1, label="mean")
        ax.axvline(s.hpd_mode, color="C3", ls=":", lw=1, label="HPD mode")
        lo, hi = proc.credible_interval(i)
        ax.axvspan(lo, hi, color="C0", alpha=0.15)
        ax.set_title(proc.names[i], fontsize=9)
        if k == 0:
            ax.legend(fontsize=7)
    for k in range(n, rows * cols):
        axes[k // cols][k % cols].axis("off")
    fig.tight_layout()
    return fig


def plot_posterior_comparison(
    procs, labels: Sequence[str], indices: Sequence[int] | None = None, bins: int = 80
):
    """Overlay 1D posteriors from several chains — the reference
    ``ProcessMCMC`` multi-chain comparison mode
    (``Diagnostics/ProcessMCMC.cpp``). Parameters are matched by name through
    the first chain's ordering."""
    plt = _mpl()
    ref = procs[0]
    indices = list(indices) if indices is not None else list(range(ref.n_params))
    n = len(indices)
    cols = min(4, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows), squeeze=False)
    for k, i in enumerate(indices):
        ax = axes[k // cols][k % cols]
        name = ref.names[i]
        for p, (proc, lab) in enumerate(zip(procs, labels)):
            j = proc.names.index(name) if name in proc.names else None
            if j is None:
                continue
            centers, counts = proc.posterior_1d(j, bins=bins)
            ax.step(centers, counts, where="mid", color=f"C{p}", label=lab, lw=1.2)
        ax.set_title(name, fontsize=9)
        if k == 0:
            ax.legend(fontsize=7)
    for k in range(n, rows * cols):
        axes[k // cols][k % cols].axis("off")
    fig.tight_layout()
    return fig


def plot_triangle(proc, indices: Sequence[int], bins: int = 50, masses=(0.6827, 0.9545)):
    """Triangle plot: 1D posteriors on the diagonal, 2D credible regions below
    (``MCMCProcessor`` triangle machinery)."""
    plt = _mpl()
    k = len(indices)
    fig, axes = plt.subplots(k, k, figsize=(2.4 * k, 2.4 * k), squeeze=False)
    for r in range(k):
        for c in range(k):
            ax = axes[r][c]
            if c > r:
                ax.axis("off")
                continue
            if r == c:
                centers, counts = proc.posterior_1d(indices[r], bins=bins)
                ax.fill_between(centers, counts, step="mid", alpha=0.7)
                ax.set_yticks([])
            else:
                xc, yc, counts, _ = proc.credible_region_2d(indices[c], indices[r], bins=bins)
                levels = []
                flat = np.sort(counts.ravel())[::-1]
                cum = np.cumsum(flat)
                for m in sorted(masses, reverse=True):
                    pos = np.searchsorted(cum, m * flat.sum())
                    levels.append(flat[min(pos, len(flat) - 1)])
                levels = sorted(set(levels))
                if len(levels) > 1 or (len(levels) == 1 and counts.max() > levels[0]):
                    ax.contourf(
                        xc, yc, counts.T, levels=levels + [counts.max() + 1], alpha=0.7
                    )
            if r == k - 1:
                ax.set_xlabel(proc.names[indices[c]], fontsize=8)
            if c == 0 and r > 0:
                ax.set_ylabel(proc.names[indices[r]], fontsize=8)
            ax.tick_params(labelsize=6)
    fig.tight_layout()
    return fig


def plot_prefit_postfit(
    names: Sequence[str],
    prefit: np.ndarray,
    prefit_err: np.ndarray,
    summaries,
    normalise: bool = True,
):
    """Prefit vs postfit parameter comparison (``GetPostfitParamPlots.cpp``)."""
    plt = _mpl()
    n = len(names)
    post_mean = np.array([s.arithmetic_mean for s in summaries])
    post_err = np.array([s.arithmetic_std for s in summaries])
    if normalise:
        shift, scale = prefit, np.where(prefit_err > 0, prefit_err, 1.0)
    else:
        shift, scale = np.zeros(n), np.ones(n)
    x = np.arange(n)
    fig, ax = plt.subplots(figsize=(max(8, 0.45 * n), 4.5))
    ax.errorbar(
        x - 0.12, (prefit - shift) / scale, yerr=prefit_err / scale, fmt="s",
        label="prefit", color="C7", ms=4,
    )
    ax.errorbar(
        x + 0.12, (post_mean - shift) / scale, yerr=post_err / scale, fmt="o",
        label="postfit", color="C0", ms=4,
    )
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=80, fontsize=7)
    ax.set_ylabel("(value - prefit) / prior sigma" if normalise else "value")
    ax.axhline(0, color="k", lw=0.5)
    ax.legend()
    fig.tight_layout()
    return fig


def plot_violins(proc, indices: Sequence[int] | None = None):
    """Violin plot of posteriors (``MCMCProcessor`` violin outputs)."""
    plt = _mpl()
    indices = list(indices) if indices is not None else list(range(proc.n_params))
    data = [proc.flat[:, i] for i in indices]
    fig, ax = plt.subplots(figsize=(max(8, 0.5 * len(indices)), 4.5))
    ax.violinplot(data, showmedians=True)
    ax.set_xticks(np.arange(1, len(indices) + 1))
    ax.set_xticklabels([proc.names[i] for i in indices], rotation=80, fontsize=7)
    fig.tight_layout()
    return fig


def plot_llh_scans(scan: dict, names: Sequence[str], per_sample: bool = False):
    """Overlay total/penalty/per-sample LLH scans (``PlotLLH.cpp``)."""
    plt = _mpl()
    n = scan["values"].shape[0]
    cols = min(4, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows), squeeze=False)
    for k in range(n):
        ax = axes[k // cols][k % cols]
        v = scan["values"][k]
        t = scan["total"][k] - scan["total"][k].min()
        ax.plot(v, t, label="total", color="k")
        ax.plot(v, scan["penalty"][k] - scan["penalty"][k].min(), label="penalty", ls="--")
        if per_sample:
            for si in range(scan["samples"].shape[-1]):
                s = scan["samples"][k, :, si]
                ax.plot(v, s - s.min(), label=f"sample {si}", alpha=0.6)
        ax.set_title(names[k], fontsize=9)
        ax.set_ylabel(r"$\Delta(-\ln L)$", fontsize=8)
        if k == 0:
            ax.legend(fontsize=7)
    for k in range(n, rows * cols):
        axes[k // cols][k % cols].axis("off")
    fig.tight_layout()
    return fig


def plot_sigma_variations(sv: dict, bin_edges: np.ndarray | None, names: Sequence[str]):
    """Spectral ±σ variation ratios (``PlotSigmaVariation.cpp``)."""
    plt = _mpl()
    hists = sv["hists"]  # [P, S, B]
    n = hists.shape[0]
    cols = min(3, n)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4.5 * cols, 3 * rows), squeeze=False)
    x = np.arange(hists.shape[-1]) if bin_edges is None else 0.5 * (
        bin_edges[:-1] + bin_edges[1:]
    )
    nominal_idx = int(np.argmin(np.abs(sv["sigmas"])))
    for k in range(n):
        ax = axes[k // cols][k % cols]
        nom = np.maximum(hists[k, nominal_idx], 1e-12)
        for si, s in enumerate(sv["sigmas"]):
            if si == nominal_idx:
                continue
            ax.step(x, hists[k, si] / nom, where="mid", label=f"{s:+g}$\\sigma$")
        ax.axhline(1.0, color="k", lw=0.5)
        ax.set_title(names[k], fontsize=9)
        ax.set_ylabel("ratio to nominal", fontsize=8)
        if k == 0:
            ax.legend(fontsize=7)
    for k in range(n, rows * cols):
        axes[k // cols][k % cols].axis("off")
    fig.tight_layout()
    return fig


def plot_matrix(matrix: np.ndarray, names: Sequence[str], title: str = "correlation"):
    """Covariance/correlation heatmap (``MatrixPlotter.cpp``)."""
    plt = _mpl()
    n = len(names)
    fig, ax = plt.subplots(figsize=(max(6, 0.3 * n + 2), max(5, 0.3 * n + 1.5)))
    vmax = np.nanmax(np.abs(matrix))
    im = ax.imshow(matrix, cmap="RdBu_r", vmin=-vmax, vmax=vmax)
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    ax.set_xticklabels(names, rotation=85, fontsize=6)
    ax.set_yticklabels(names, fontsize=6)
    ax.set_title(title)
    fig.colorbar(im, ax=ax, shrink=0.8)
    fig.tight_layout()
    return fig


def plot_diagnostics(diag: dict, names: Sequence[str]):
    """Trace/autocorr/ESS overview (``PlotMCMCDiag.cpp``)."""
    plt = _mpl()
    fig, axes = plt.subplots(1, 3, figsize=(14, 4))
    rho = diag["autocorrelation"]  # [L, P]
    for p in range(min(rho.shape[1], 20)):
        axes[0].plot(rho[:, p], alpha=0.5, lw=0.8)
    axes[0].set_title("autocorrelation")
    axes[0].set_xlabel("lag")
    axes[1].bar(range(len(diag["ess"])), diag["ess"])
    axes[1].set_title("ESS")
    axes[1].set_xticks(range(len(names)))
    axes[1].set_xticklabels(names, rotation=85, fontsize=6)
    axes[2].bar(range(len(diag["split_rhat"])), diag["split_rhat"])
    axes[2].axhline(1.05, color="r", ls="--", lw=1)
    axes[2].set_title("split R-hat")
    axes[2].set_xticks(range(len(names)))
    axes[2].set_xticklabels(names, rotation=85, fontsize=6)
    fig.tight_layout()
    return fig
