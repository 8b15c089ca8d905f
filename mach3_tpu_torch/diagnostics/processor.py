"""Posterior processing of MCMC chains.

Port of ``mach3_tpu/diagnostics/processor.py`` (numpy on the host), the
equivalent of the reference's ``MCMCProcessor``
(``Fitters/MCMCProcessor.h:61``, ``.cpp`` 4642 LoC): 1D/2D posteriors with
arithmetic / Gaussian / HPD point estimates and errors, credible
intervals/regions, posterior covariance/correlation, chain thinning and
burn-in, Bayes factors and Savage-Dickey density ratios, prior reweighting.

The reference caches the TTree into ``ParStep[param][entry]`` for OMP
(``MCMCProcessor.cpp:1060``); here chains are already arrays, and every
histogram/moment is a vectorised reduction.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.logging import get_logger

_log = get_logger("processor")


@dataclasses.dataclass
class PosteriorSummary:
    """Point estimates + errors for one parameter (``MakePostfit`` outputs)."""

    name: str
    arithmetic_mean: float
    arithmetic_std: float
    gaussian_mean: float
    gaussian_std: float
    hpd_mode: float
    hpd_err_low: float  # distance from mode to lower HPD bound
    hpd_err_high: float
    median: float


def _hpd_interval(
    centers: np.ndarray, counts: np.ndarray, mass: float = 0.6827
) -> tuple[float, float, float]:
    """Mode + highest-posterior-density interval from a histogram
    (``GetHPD``/credible machinery, ``Fitters/StatisticalUtils``): descend from
    the peak adding bins by height until the target mass is enclosed."""
    total = counts.sum()
    if total <= 0:
        return float(centers[len(centers) // 2]), 0.0, 0.0
    order = np.argsort(counts)[::-1]
    included = np.zeros(len(counts), bool)
    acc = 0.0
    for i in order:
        included[i] = True
        acc += counts[i]
        if acc >= mass * total:
            break
    mode = float(centers[order[0]])
    lo = float(centers[included].min())
    hi = float(centers[included].max())
    return mode, mode - lo, hi - mode


def _gaussian_fit(centers: np.ndarray, counts: np.ndarray) -> tuple[float, float]:
    """Least-squares Gaussian FIT to the histogram bulk — the reference's TF1
    ``gaus`` fit around the peak (``MCMCProcessor::MakePostfit`` Gaussian
    estimator), not moment matching: a fit weights the core and ignores
    asymmetric tails, which moments cannot. Moments seed the fit and remain
    the fallback if the optimiser fails."""
    total = counts.sum()
    if total <= 0:
        return float(centers[len(centers) // 2]), 0.0
    mean = float((centers * counts).sum() / total)
    var = float(((centers - mean) ** 2 * counts).sum() / total)
    sigma = float(np.sqrt(max(var, 1e-300)))
    # Fit window: peak region only (the reference restricts the TF1 range).
    sel = np.abs(centers - mean) < 2.0 * sigma
    if sel.sum() >= 4 and counts[sel].max() > 0:
        try:
            from scipy.optimize import curve_fit

            def gaus(x, a, mu, sig):
                return a * np.exp(-0.5 * ((x - mu) / sig) ** 2)

            p0 = [float(counts[sel].max()), mean, sigma]
            popt, _ = curve_fit(
                gaus, centers[sel], counts[sel], p0=p0, maxfev=2000
            )
            mu_fit, sig_fit = float(popt[1]), abs(float(popt[2]))
            # Sanity: the fit must stay inside the histogram support.
            if (
                centers.min() <= mu_fit <= centers.max()
                and 0 < sig_fit < 5 * sigma
            ):
                return mu_fit, sig_fit
        except Exception as exc:  # singular fits fall back to moments
            # Logged, not silent: a missing/broken scipy would otherwise
            # quietly degrade every Gaussian estimator to moments.
            _log.warning("Gaussian fit fell back to moments: %s", exc)
    # Moment fallback with one 2.5-sigma trimming pass.
    sel = np.abs(centers - mean) < 2.5 * sigma
    if counts[sel].sum() > 0:
        mean = float((centers[sel] * counts[sel]).sum() / counts[sel].sum())
        var = float(((centers[sel] - mean) ** 2 * counts[sel]).sum() / counts[sel].sum())
    return mean, float(np.sqrt(max(var, 0.0)))


class ChainProcessor:
    """Process chain draws [S, C, P] (or [S, P]) into posterior products."""

    def __init__(
        self,
        draws: np.ndarray,
        names: list[str] | None = None,
        burn_in: float | int = 0.2,
        thin: int = 1,
        weights: np.ndarray | None = None,
    ):
        draws = np.asarray(draws, np.float64)
        if draws.ndim == 2:
            draws = draws[:, None, :]
        s = draws.shape[0]
        start = int(burn_in * s) if isinstance(burn_in, float) else int(burn_in)
        self.raw = draws
        self.burn_in = start
        kept = draws[start::thin]
        self.chains = kept  # [S', C, P]
        self.flat = kept.reshape(-1, kept.shape[-1])  # [N, P]
        self.names = names or [f"param_{i}" for i in range(draws.shape[-1])]
        self.weights = (
            np.asarray(weights, np.float64)[start::thin].reshape(-1)
            if weights is not None
            else np.ones(self.flat.shape[0])
        )
        _log.info(
            "ChainProcessor: %d draws x %d chains x %d params (burn-in %d, thin %d)",
            kept.shape[0],
            kept.shape[1],
            kept.shape[2],
            start,
            thin,
        )

    @property
    def n_params(self) -> int:
        return self.flat.shape[1]

    # ------------------------------------------------------------- postfit
    def posterior_1d(
        self, index: int, bins: int = 100, range_: tuple[float, float] | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(centers, counts) weighted 1D posterior histogram."""
        x = self.flat[:, index]
        counts, edges = np.histogram(x, bins=bins, range=range_, weights=self.weights)
        return 0.5 * (edges[:-1] + edges[1:]), counts.astype(np.float64)

    def posterior_2d(
        self, i: int, j: int, bins: int = 60
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        counts, xe, ye = np.histogram2d(
            self.flat[:, i], self.flat[:, j], bins=bins, weights=self.weights
        )
        return 0.5 * (xe[:-1] + xe[1:]), 0.5 * (ye[:-1] + ye[1:]), counts

    def summary(self, index: int, bins: int = 200) -> PosteriorSummary:
        x = self.flat[:, index]
        w = self.weights
        wsum = w.sum()
        mean = float((x * w).sum() / wsum)
        std = float(np.sqrt(((x - mean) ** 2 * w).sum() / wsum))
        centers, counts = self.posterior_1d(index, bins=bins)
        gmean, gstd = _gaussian_fit(centers, counts)
        mode, lo, hi = _hpd_interval(centers, counts)
        order = np.argsort(x)
        cdf = np.cumsum(w[order])
        median = float(x[order][np.searchsorted(cdf, 0.5 * wsum)])
        return PosteriorSummary(
            name=self.names[index],
            arithmetic_mean=mean,
            arithmetic_std=std,
            gaussian_mean=gmean,
            gaussian_std=gstd,
            hpd_mode=mode,
            hpd_err_low=lo,
            hpd_err_high=hi,
            median=median,
        )

    def summaries(self) -> list[PosteriorSummary]:
        return [self.summary(i) for i in range(self.n_params)]

    # ------------------------------------------------------- covariance
    def covariance(self) -> np.ndarray:
        """Posterior covariance (``MakeCovariance_MP``)."""
        return np.cov(self.flat.T, aweights=self.weights)

    def correlation(self) -> np.ndarray:
        cov = np.atleast_2d(self.covariance())
        d = np.sqrt(np.maximum(np.diag(cov), 1e-300))
        return cov / np.outer(d, d)

    # ------------------------------------------------ credible machinery
    def credible_interval(self, index: int, mass: float = 0.6827, bins: int = 200):
        """HPD credible interval bounds (lo, hi)."""
        centers, counts = self.posterior_1d(index, bins=bins)
        mode, lo, hi = _hpd_interval(centers, counts, mass)
        return mode - lo, mode + hi

    def credible_region_2d(self, i: int, j: int, mass: float = 0.6827, bins: int = 60):
        """2D credible-region threshold: returns (xc, yc, counts, level) where
        ``counts >= level`` encloses the requested mass (triangle-plot input)."""
        xc, yc, counts = self.posterior_2d(i, j, bins=bins)
        flat = np.sort(counts.ravel())[::-1]
        cum = np.cumsum(flat)
        k = np.searchsorted(cum, mass * flat.sum())
        level = flat[min(k, len(flat) - 1)]
        return xc, yc, counts, float(level)

    # -------------------------------------------------- model comparison
    def bayes_factor(self, index: int, region_a, region_b) -> float:
        """Posterior-mass ratio between two regions of one parameter
        (``MCMCProcessor.h:158-208`` Bayes-factor tools), e.g. upper vs lower
        octant, or NH (dm31>0) vs IH (dm31<0)."""
        x = self.flat[:, index]
        w = self.weights
        in_a = w[(x >= region_a[0]) & (x < region_a[1])].sum()
        in_b = w[(x >= region_b[0]) & (x < region_b[1])].sum()
        if in_b == 0:
            return np.inf
        return float(in_a / in_b)

    def savage_dickey(self, index: int, point: float, prior_density: float, bins: int = 200) -> float:
        """Savage-Dickey density ratio: posterior density at ``point`` over the
        prior density there — Bayes factor for the point hypothesis."""
        centers, counts = self.posterior_1d(index, bins=bins)
        width = centers[1] - centers[0]
        dens = counts / (counts.sum() * width)
        at = np.interp(point, centers, dens)
        return float(at / prior_density) if prior_density > 0 else np.inf

    def reweight(self, log_weight_fn) -> "ChainProcessor":
        """Prior-reweighted view of the chain (``ReweightMCMC``/prior switch):
        multiplies draw weights by exp(log_weight_fn(theta))."""
        lw = np.array([log_weight_fn(t) for t in self.flat])
        lw -= lw.max()
        new = ChainProcessor.__new__(ChainProcessor)
        new.raw = self.raw
        new.burn_in = self.burn_in
        new.chains = self.chains
        new.flat = self.flat
        new.names = self.names
        new.weights = self.weights * np.exp(lw)
        return new

    def thin(self, factor: int) -> "ChainProcessor":
        new = ChainProcessor.__new__(ChainProcessor)
        new.raw = self.raw
        new.burn_in = self.burn_in
        new.chains = self.chains[::factor]
        new.flat = new.chains.reshape(-1, self.chains.shape[-1])
        new.names = self.names
        new.weights = (
            self.weights.reshape(self.chains.shape[0], self.chains.shape[1])[::factor]
        ).reshape(-1)
        return new
