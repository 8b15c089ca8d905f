"""Chain post-hoc tools: penalty terms, smearing, prior reweighting.

Port of ``mach3_tpu/diagnostics/chaintools.py`` (numpy on the host): the
equivalents of three reference executables:

* ``Diagnostics/GetPenaltyTerm.cpp`` — recompute the Gaussian prior penalty for
  parameter groups along a chain (no refit needed),
* ``Diagnostics/SmearChain.cpp`` — smear posterior draws with additional
  uncertainty (e.g. an unmodelled systematic),
* ``Diagnostics/ReweightMCMC.cpp`` — reweight a chain to new priors.

All are vectorised over the full chain at once.
"""
from __future__ import annotations

import numpy as np

from ..core.logging import get_logger

_log = get_logger("chaintools")


def penalty_terms(
    draws: np.ndarray,
    prefit: np.ndarray,
    inv_cov: np.ndarray,
    groups: dict[str, list[int]] | None = None,
) -> dict[str, np.ndarray]:
    """Per-step prior penalty (1/2 d^T V^-1 d), total and per parameter group.

    draws: [N, P] flattened chain; groups: name -> parameter indices. A group's
    penalty uses the sub-block of the inverse covariance (matching
    ``GetPenaltyTerm``'s group option).
    """
    d = np.asarray(draws, np.float64) - np.asarray(prefit)[None, :]
    out = {"total": 0.5 * np.einsum("np,pq,nq->n", d, inv_cov, d)}
    for name, idx in (groups or {}).items():
        sub = inv_cov[np.ix_(idx, idx)]
        dd = d[:, idx]
        out[name] = 0.5 * np.einsum("np,pq,nq->n", dd, sub, dd)
    return out


def smear_chain(
    draws: np.ndarray,
    sigmas: np.ndarray | dict[int, float],
    seed: int = 0,
) -> np.ndarray:
    """Add Gaussian smearing to chain draws (``SmearChain``): sigmas is either
    a [P] vector (0 = untouched) or {param_index: sigma}."""
    draws = np.asarray(draws, np.float64)
    p = draws.shape[-1]
    if isinstance(sigmas, dict):
        vec = np.zeros(p)
        for i, s in sigmas.items():
            vec[i] = s
    else:
        vec = np.asarray(sigmas, np.float64)
    rng = np.random.default_rng(seed)
    return draws + vec * rng.normal(size=draws.shape)


def reweight_to_new_prior(
    draws: np.ndarray,
    index: int,
    old_prior: tuple[float, float] | None,
    new_prior: tuple[float, float] | None,
) -> np.ndarray:
    """Per-draw weights switching one parameter's prior (``ReweightMCMC``):
    each prior is (mean, sigma) Gaussian or None for flat. Returns [N] weights
    (normalised to max 1)."""
    x = np.asarray(draws, np.float64)[:, index]

    def logpdf(prior):
        if prior is None:
            return np.zeros_like(x)
        mu, sig = prior
        return -0.5 * ((x - mu) / sig) ** 2

    lw = logpdf(new_prior) - logpdf(old_prior)
    lw -= lw.max()
    return np.exp(lw)
