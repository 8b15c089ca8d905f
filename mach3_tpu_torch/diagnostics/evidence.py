"""Marginal likelihood (Bayesian evidence) from parallel-tempering runs
(this package's copy of ``mach3_tpu/diagnostics/evidence.py``; numpy on the
host).

The reference's Bayes-factor machinery works on posterior draws only
(``Fitters/MCMCProcessor.cpp`` Savage-Dickey density ratios, bin-count Bayes
factors) because independent single-temperature chains cannot estimate the
normalising constant Z = ∫ prior·like. The tempered ladder of
``fitters/tempering.py`` makes Z accessible with zero extra likelihood
evaluations: every level's untempered sample -logL is already recorded per
step (``out["sample_nll"]``), and two classical estimators run on that array:

* **Thermodynamic integration** (path sampling):
  d log Z(β)/dβ = E_β[log like], integrated over β with the trapezoid rule on
  the ladder's discrete levels — simple, but biased by the quadrature.
* **Stepping-stone** (Xie et al. 2011, importance sampling between adjacent
  levels): log Z = Σ_t log E_{β_t}[ like^{β_{t-1} − β_t} ], each expectation
  estimated with a numerically-stable log-mean-exp over that level's draws.
  Unbiased in the number of draws for fixed ladder; the production choice.

Both need the ladder to span the full β ∈ [0, 1] range — run the sampler with
``PTConfig(beta_zero=True)`` so the hottest level IS the (bound-truncated)
prior. The estimate is then the evidence against the *normalised* truncated
prior: Z = ∫ π(θ) like(θ) dθ with ∫ π = 1. ``log_prior_mass`` converts to the
raw exp(-prior_nll) measure when an absolute normalisation is wanted.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "thermodynamic_log_evidence",
    "stepping_stone_log_evidence",
    "log_prior_mass",
]


def _prep(e_draws: np.ndarray, betas: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Validate and sort: returns (E [T, N] per-level draws, betas ascending)."""
    e = np.asarray(e_draws, np.float64)
    b = np.asarray(betas, np.float64)
    if e.ndim == 2:
        e = e[:, :, None]
    if e.ndim != 3 or e.shape[1] != b.shape[0]:
        raise ValueError(
            f"e_draws must be [steps, n_temps(, walkers)]; got {e.shape} "
            f"vs {b.shape[0]} betas"
        )
    # [T, S*W] level-major; drop non-finite draws per level defensively
    e = np.moveaxis(e, 1, 0).reshape(b.shape[0], -1)
    order = np.argsort(b)
    return e[order], b[order]


def thermodynamic_log_evidence(e_draws: np.ndarray, betas: np.ndarray) -> float:
    """Trapezoid path-sampling estimate of log Z(β_max) − log Z(β_min).

    e_draws: [S, T] or [S, T, W] untempered sample -logL per level (PT output
    ``sample_nll`` after burn-in, reshaped level-major as in
    ``ParallelTempering.log_evidence``); betas: [T] inverse temperatures in
    the sampler's order (descending from 1).
    """
    e, b = _prep(e_draws, betas)
    m = np.nanmean(np.where(np.isfinite(e), e, np.nan), axis=1)  # E_β[E]
    # d log Z / dβ = E_β[log like] = -E_β[E]
    trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 has trapz only
    return float(-trapezoid(m, b))


def stepping_stone_log_evidence(e_draws: np.ndarray, betas: np.ndarray) -> float:
    """Stepping-stone estimate of log Z(β_max) − log Z(β_min).

    Each rung t uses draws at the LOWER β to bridge to the next:
    log r_t = log-mean-exp over draws of −(β_{t+1} − β_t)·E, stabilised by
    subtracting the per-level minimum E before exponentiating.
    """
    e, b = _prep(e_draws, betas)
    total = 0.0
    for t in range(len(b) - 1):
        db = b[t + 1] - b[t]
        x = -db * e[t]
        x = x[np.isfinite(x)]
        if x.size == 0:
            raise ValueError(f"no finite draws at beta={b[t]:.4g}")
        xm = x.max()
        total += xm + np.log(np.mean(np.exp(x - xm)))
    return float(total)


def log_prior_mass(model) -> float:
    """log ∫ exp(-prior_nll(θ)) dθ over the sampled (non-fixed) coordinates.

    The Gaussian block contributes (k/2)·log 2π − ½·log det(Λ_sub) with Λ_sub
    the inverse covariance restricted to non-flat, non-fixed coordinates
    (flat-prior rows/cols are already zeroed in ``PriorModel.inv_cov``).
    Bounded flat-prior coordinates contribute log(hi − lo) each. Bound
    truncation of the Gaussian block is NOT corrected — priors in this
    framework put bounds several σ out (the reference's hard bounds are
    physical-region guards, ``ParameterHandlerBase.cpp:859-867``), so the
    truncated mass is negligible; an unbounded flat prior has infinite mass
    and raises.
    """
    flat = getattr(model, "flat", model)  # a FitModel's whole-vector prior, or a PriorModel

    def host(name, dtype):
        return np.asarray(getattr(flat, name).cpu().numpy(), dtype)

    fixed = host("fixed", bool)
    is_flat = host("flat_prior", bool)
    inv_cov = host("inv_cov", np.float64)
    lo = host("low_bound", np.float64)
    hi = host("up_bound", np.float64)

    total = 0.0
    gauss = ~is_flat & ~fixed
    k = int(gauss.sum())
    if k:
        sub = inv_cov[np.ix_(gauss, gauss)]
        sign, logdet = np.linalg.slogdet(sub)
        if sign <= 0:
            raise ValueError("prior inverse covariance is not positive definite")
        total += 0.5 * k * np.log(2.0 * np.pi) - 0.5 * logdet
    for i in np.nonzero(is_flat & ~fixed)[0]:
        if not (np.isfinite(lo[i]) and np.isfinite(hi[i])):
            raise ValueError(
                f"flat prior on parameter {i} is unbounded: prior mass is "
                "infinite — evidence is only defined against the normalised "
                "(bounded) prior"
            )
        total += np.log(hi[i] - lo[i])
    return float(total)
