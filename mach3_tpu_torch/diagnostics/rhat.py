"""Gelman-Rubin R-hat across chains, with split and folded variants (port of
``mach3_tpu/diagnostics/rhat.py``; ``Diagnostics/RHat.cpp``,
``RHat_HighMem.cpp``). numpy on the host: the draws are host arrays.

Shapes: chains [S, C, P] (steps, chains, params).
"""
from __future__ import annotations

import numpy as np


def rhat(chains: np.ndarray) -> np.ndarray:
    """Plain Gelman-Rubin R-hat: [S, C, P] -> [P].

    W = mean of within-chain variances, B/S = between-chain variance of means,
    var+ = (S-1)/S W + B/S;  R-hat = sqrt(var+ / W)  (``RHat.cpp`` estimator).
    """
    chains = np.asarray(chains, np.float64)
    s = chains.shape[0]
    means = chains.mean(axis=0)  # [C, P]
    w = chains.var(axis=0, ddof=1).mean(axis=0)  # [P]
    b_over_s = means.var(axis=0, ddof=1)  # [P]
    var_plus = (s - 1.0) / s * w + b_over_s
    return np.sqrt(var_plus / np.maximum(w, 1e-30))


def split_rhat(chains: np.ndarray) -> np.ndarray:
    """Split-R-hat: halve each chain first (detects within-chain drift)."""
    chains = np.asarray(chains)
    s = chains.shape[0] // 2
    return rhat(np.concatenate([chains[:s], chains[s:2 * s]], axis=1))


def folded_rhat(chains: np.ndarray) -> np.ndarray:
    """Folded split-R-hat (``RHat_HighMem.cpp``): fold about the median to be
    sensitive to scale (tail) differences between chains."""
    chains = np.asarray(chains, np.float64)
    med = np.median(chains.reshape(-1, chains.shape[-1]), axis=0)
    return split_rhat(np.abs(chains - med))


def rank_normalised_rhat(chains: np.ndarray) -> np.ndarray:
    """Vehtari et al. 2021 rank-normalised split-R-hat: ranks over the pooled
    draws, mapped through the normal quantile function, then split-R-hat."""
    from scipy.stats import norm

    chains = np.asarray(chains, np.float64)
    s, c, p = chains.shape
    flat = chains.reshape(s * c, p)
    ranks = np.argsort(np.argsort(flat, axis=0), axis=0) + 1.0
    z = norm.ppf((ranks - 0.375) / (s * c + 0.25))
    return split_rhat(z.reshape(s, c, p))


class StreamingRhat:
    """Low-memory streaming accumulator matching ``RHat.cpp:46-60``: per chain
    keep S1 = sum x and S2 = sum x² only; finalize computes R-hat."""

    def __init__(self, n_params: int):
        self.n_params = n_params
        self.s1: list[np.ndarray] = []
        self.s2: list[np.ndarray] = []
        self.counts: list[int] = []

    def add_chain(self, draws: np.ndarray) -> None:
        draws = np.asarray(draws, np.float64)
        if draws.shape[1] != self.n_params:
            raise ValueError(f"Chain has {draws.shape[1]} params, expected {self.n_params}")
        self.s1.append(draws.sum(axis=0))
        self.s2.append((draws**2).sum(axis=0))
        self.counts.append(draws.shape[0])

    def finalize(self) -> np.ndarray:
        if len(self.counts) < 2:
            raise ValueError("Need at least 2 chains for R-hat")
        n = min(self.counts)  # the reference truncates to the shortest chain
        means = np.stack([s1 / c for s1, c in zip(self.s1, self.counts)])
        variances = np.stack([(s2 - c * m**2) / (c - 1)
                              for s2, c, m in zip(self.s2, self.counts, means)])
        w = variances.mean(axis=0)
        b_over_s = means.var(axis=0, ddof=1)
        var_plus = (n - 1.0) / n * w + b_over_s
        return np.sqrt(var_plus / np.maximum(w, 1e-30))
