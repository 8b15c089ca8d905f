"""Histogram utilities (port of ``mach3_tpu/samples/histograms.py``).

The equivalent of ``Samples/HistogramUtils.h/.cpp``: N-dim histogram
projections/integrals, Poisson-fluctuated copies (fast + checked variants),
ratio and normalisation helpers, violin fills. ROOT TH1/TH2Poly objects become
plain arrays + bin-edge tuples. numpy on the host, except
:func:`poisson_fluctuate`, which draws on the generator's device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.precision import ATYPE


def project(hist: np.ndarray, axis: int) -> np.ndarray:
    """Project an N-dim histogram onto one axis (``ProjectPoly`` analogs)."""
    h = np.asarray(hist)
    axes = tuple(i for i in range(h.ndim) if i != axis)
    return h.sum(axis=axes)


def integral(hist: np.ndarray, widths: tuple[np.ndarray, ...] | None = None) -> float:
    """Histogram integral; with widths does the width-weighted version
    (``NoOverflowIntegral``-ish; the flat bin space has no overflow bins)."""
    h = np.asarray(hist, np.float64)
    if widths is None:
        return float(h.sum())
    w = widths[0]
    for ww in widths[1:]:
        w = np.multiply.outer(w, ww)
    return float((h * w).sum())


def poisson_fluctuate(hist, generator: torch.Generator) -> torch.Tensor:
    """Fast Poisson-fluctuated copy (``MakeFluctuatedHistogramAlternative``):
    one draw per bin from ``generator``, on its device, f64 (a batch of
    histograms [..., B] draws each bin of each). The JAX package takes a
    PRNG key here."""
    mc = torch.as_tensor(hist, dtype=ATYPE, device=generator.device).clamp(min=0.0)
    return torch.poisson(mc, generator=generator)


def poisson_fluctuate_by_sampling(hist: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Checked variant (``MakeFluctuatedHistogramStandard``): draw the total
    from Poisson(sum) then distribute bin-by-bin by the normalised content —
    reproduces the reference's event-sampling approach."""
    h = np.asarray(hist, np.float64)
    total = h.sum()
    if total <= 0:
        return np.zeros_like(h)
    n = rng.poisson(total)
    p = (h / total).reshape(-1)
    counts = rng.multinomial(n, p)
    return counts.reshape(h.shape).astype(np.float64)


def ratio(num: np.ndarray, den: np.ndarray) -> np.ndarray:
    """Bin-wise ratio with empty-denominator guard (``RatioHists`` analog)."""
    den = np.asarray(den, np.float64)
    return np.where(den != 0, np.asarray(num, np.float64) / np.where(den == 0, 1, den), 0.0)


def normalise(hist: np.ndarray) -> np.ndarray:
    h = np.asarray(hist, np.float64)
    s = h.sum()
    return h / s if s > 0 else h


def fill_violin(per_throw_hists: np.ndarray, quantiles: np.ndarray | None = None) -> dict:
    """Violin summary from per-throw spectra [T, B] (``FastViolinFill``):
    per-bin quantiles + mean, the data behind violin plots."""
    h = np.asarray(per_throw_hists, np.float64)
    q = quantiles if quantiles is not None else np.array([0.023, 0.159, 0.5, 0.841, 0.977])
    return {
        "quantiles": q,
        "values": np.quantile(h, q, axis=0),  # [Q, B]
        "mean": h.mean(axis=0),
        "std": h.std(axis=0),
    }


def th2poly_to_grid(counts: np.ndarray, x_edges: np.ndarray, y_edges: np.ndarray) -> dict:
    """Package a 2D histogram as the dict our plotting layer consumes
    (replaces TH2Poly conversions; rectangular grids only)."""
    return {"counts": np.asarray(counts), "x_edges": np.asarray(x_edges), "y_edges": np.asarray(y_edges)}
