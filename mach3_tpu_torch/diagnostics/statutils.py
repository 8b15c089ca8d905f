"""Statistical utility functions.

Port of ``mach3_tpu/diagnostics/statutils.py`` (numpy on the host), the
equivalent of ``Fitters/StatisticalUtils.h/.cpp``: Bayes-factor
interpretation scales (Jeffreys, Dunne-Kaboth), BIC, effective sample count,
Bonferroni correction, Anderson-Darling, Wald-Wolfowitz runs test,
Barlow-Beeston beta, chain suboptimality, KL divergence, Fisher combined
p-value.
"""
from __future__ import annotations

import numpy as np

from ..core.precision import LOW_MC_BOUND


def jeffreys_scale(bayes_factor: float) -> str:
    """Jeffreys interpretation of a Bayes factor (``GetJeffreysScale``)."""
    b = bayes_factor
    if b < 1:
        return "Negative"
    if b < 10 ** 0.5:
        return "Barely worth mentioning"
    if b < 10:
        return "Substantial"
    if b < 10 ** 1.5:
        return "Strong"
    if b < 100:
        return "Very strong"
    return "Decisive"


def dunne_kaboth_scale(bayes_factor: float) -> str:
    """Dunne-Kaboth CL-style interpretation (``GetDunneKaboth``)."""
    import math

    b = bayes_factor
    # thresholds from 2/1/0.5-sigma-equivalent posterior odds
    if b < 2.125:
        return "< 1 sigma"
    if b < 20.74:
        return "> 1 sigma"
    if b < 369.4:
        return "> 2 sigma"
    if b < 15800:
        return "> 3 sigma"
    if b < 1745000:
        return "> 4 sigma"
    return "> 5 sigma"


def bic(n_llh: float, n_params: int, n_data: int) -> float:
    """Bayesian information criterion from -logL (``GetBIC``)."""
    return 2.0 * n_llh + n_params * np.log(n_data)


def n_effective(mc: np.ndarray, w2: np.ndarray) -> np.ndarray:
    """Effective MC event count per bin: mc^2 / w2 (``GetNeff``)."""
    mc = np.asarray(mc, np.float64)
    w2 = np.asarray(w2, np.float64)
    return np.where(w2 > 0, mc * mc / np.maximum(w2, 1e-300), 0.0)


def barlow_beeston_beta(data: np.ndarray, mc: np.ndarray, w2: np.ndarray) -> np.ndarray:
    """Per-bin Conway beta scaling (``GetBetaParameter`` analog)."""
    mc = np.maximum(np.asarray(mc, np.float64), LOW_MC_BOUND)
    frac2 = np.asarray(w2, np.float64) / (mc * mc)
    temp = mc * frac2 - 1.0
    temp2 = temp * temp + 4.0 * np.asarray(data, np.float64) * frac2
    return 0.5 * (-temp + np.sqrt(np.maximum(temp2, 0.0)))


def bonferroni(p_value: float, n_tests: int) -> float:
    """Bonferroni-corrected p-value (``GetBonferoniCorrectedpvalue``)."""
    return min(1.0, p_value * n_tests)


def anderson_darling(sample: np.ndarray) -> float:
    """Anderson-Darling A^2 statistic against a normal with sample moments
    (``GetAndersonDarlingTestStat`` analog)."""
    from scipy.stats import norm

    x = np.sort(np.asarray(sample, np.float64))
    n = len(x)
    mu, sigma = x.mean(), x.std(ddof=1)
    u = np.clip(norm.cdf((x - mu) / max(sigma, 1e-300)), 1e-12, 1 - 1e-12)
    i = np.arange(1, n + 1)
    a2 = -n - np.sum((2 * i - 1) * (np.log(u) + np.log(1 - u[::-1]))) / n
    return float(a2)


def runs_test(sequence: np.ndarray) -> float:
    """Wald-Wolfowitz runs-test z-score of an above/below-median sequence
    (``GetNumberOfRuns``/runs machinery)."""
    x = np.asarray(sequence, np.float64)
    med = np.median(x)
    signs = x > med
    n1 = int(signs.sum())
    n2 = len(signs) - n1
    if n1 == 0 or n2 == 0:
        return 0.0
    runs = 1 + int(np.sum(signs[1:] != signs[:-1]))
    mean = 2.0 * n1 * n2 / (n1 + n2) + 1.0
    var = 2.0 * n1 * n2 * (2.0 * n1 * n2 - n1 - n2) / (
        (n1 + n2) ** 2 * (n1 + n2 - 1.0)
    )
    return float((runs - mean) / np.sqrt(max(var, 1e-300)))


def suboptimality(adapted_cov: np.ndarray, target_cov: np.ndarray) -> float:
    """Roberts-Rosenthal suboptimality of a proposal covariance vs the target
    posterior covariance (``GetSubOptimality``): d * sum(lambda_i^-2) /
    (sum(lambda_i^-1))^2 with lambda eigenvalues of (A T^-1)^(1/2)."""
    d = adapted_cov.shape[0]
    m = np.linalg.inv(target_cov) @ adapted_cov
    lam = np.sqrt(np.abs(np.linalg.eigvals(m)))
    inv = 1.0 / np.maximum(lam, 1e-300)
    return float(d * np.sum(inv**2) / np.sum(inv) ** 2)


def kl_divergence(p: np.ndarray, q: np.ndarray) -> float:
    """KL(P||Q) of two histograms (``GetKLDivergence``)."""
    p = np.asarray(p, np.float64)
    q = np.asarray(q, np.float64)
    p = p / max(p.sum(), 1e-30)
    q = q / max(q.sum(), 1e-30)
    mask = p > 0
    return float(np.sum(p[mask] * np.log(p[mask] / np.maximum(q[mask], 1e-300))))


def fisher_combined_pvalue(p_values: np.ndarray) -> float:
    """Fisher's method: combine independent p-values (``FisherCombinedPValue``)."""
    from scipy.stats import chi2

    p = np.clip(np.asarray(p_values, np.float64), 1e-300, 1.0)
    stat = -2.0 * np.sum(np.log(p))
    return float(chi2.sf(stat, df=2 * len(p)))
