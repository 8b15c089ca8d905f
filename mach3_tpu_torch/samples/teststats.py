"""Binned test statistics (port of ``mach3_tpu/samples/teststats.py``).

The reference's library (``Samples/SampleHandlerBase.cpp:35-190``): Poisson
(Stirling), Barlow-Beeston-lite (Conway, arXiv:1103.0354 eq 10-11),
Dembinski-Abdelmotteleb (arXiv:2206.12346), IceCube (arXiv:1901.04645),
Pearson, plus the fixed-variance Gaussian extension. Vectorised over bins,
branchless (``torch.where``), in float64, with the ``_LOW_MC_BOUND_`` clamps
and the ``data == 0`` / ``w2 == 0`` fallbacks of the reference.
"""
from __future__ import annotations

import enum
from typing import Callable

import torch

from ..core.precision import ATYPE, LOW_MC_BOUND
from ..core.special import gammaln


class TestStatistic(enum.Enum):
    """Mirrors the reference ``TestStatistic`` enum (``Samples/SampleStructs.h:105-111``)."""

    POISSON = "Poisson"
    BARLOW_BEESTON = "BarlowBeeston"
    DEMBINSKI_ABDELMOTTELEB = "DembinskiAbdelmotteleb"
    ICECUBE = "IceCube"
    PEARSON = "Pearson"
    GAUSSIAN = "Gaussian"


def _f64(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=ATYPE)


def _div_floor(num: torch.Tensor, den: torch.Tensor, floor: float = 1e-30) -> torch.Tensor:
    """``num / max(den, floor)`` with the floored branch selected (the JAX
    package's AD-safe form; values are identical)."""
    ok = den > floor
    return torch.where(ok, num / torch.where(ok, den, 1.0), num * (1.0 / floor))


def _safe_sqrt(x: torch.Tensor, floor: float = 1e-30) -> torch.Tensor:
    ok = x > floor
    return torch.where(ok, torch.sqrt(torch.where(ok, x, 1.0)), 0.0)


def _safe_log_ratio(data: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
    """data * log(data/mc), with the data==0 limit -> 0 and mc guarded."""
    ratio = _div_floor(data.clamp(min=1e-30), mc)
    return torch.where(data > 0, data * torch.log(ratio), 0.0)


def poisson_llh(data: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
    """Poisson -LLH via Stirling (``SampleHandlerBase.cpp:17-31``)."""
    data, mc = _f64(data), _f64(mc)
    low = torch.full_like(mc, LOW_MC_BOUND)
    general = mc - data + _safe_log_ratio(data, mc)
    at_bound = low - data + _safe_log_ratio(data, low)
    low_mc = torch.where(data > low, at_bound, torch.where(data >= mc, 0.0, general))
    return torch.where(data == 0, mc, torch.where(mc < low, low_mc, general))


def _low_mc_newmc(data: torch.Tensor, mc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Shared low-MC clamp of the Barlow-Beeston-family stats: (newmc,
    mask of bins that short-circuit to 0)."""
    is_low = mc < LOW_MC_BOUND
    newmc = torch.where(is_low & (data > LOW_MC_BOUND), LOW_MC_BOUND, mc)
    zero_mask = is_low & (data <= LOW_MC_BOUND) & (data >= mc)
    return newmc, zero_mask


def barlow_beeston_llh(data: torch.Tensor, mc: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """Barlow-Beeston-lite with Conway's analytic beta (``SampleHandlerBase.cpp:45-90``)."""
    data, mc, w2 = _f64(data), _f64(mc), _f64(w2)
    newmc, zero_mask = _low_mc_newmc(data, mc)
    frac2 = _div_floor(w2, newmc * newmc)
    temp = newmc * frac2 - 1.0
    temp2 = temp * temp + 4.0 * data * frac2
    beta = 0.5 * (-temp + _safe_sqrt(temp2))
    scaled = newmc * beta
    stat_data = scaled - data + _safe_log_ratio(data, scaled)
    stat = torch.where(data > 0, stat_data, mc * beta)
    penalty = torch.where(frac2 > 0, _div_floor((beta - 1.0) ** 2, 2.0 * frac2), 0.0)
    return torch.where(zero_mask, 0.0, stat + penalty)


def dembinski_abdelmotteleb_llh(
    data: torch.Tensor, mc: torch.Tensor, w2: torch.Tensor
) -> torch.Tensor:
    """Dembinski-Abdelmotteleb (``SampleHandlerBase.cpp:92-130``)."""
    data, mc, w2 = _f64(data), _f64(mc), _f64(w2)
    newmc, zero_mask = _low_mc_newmc(data, mc)
    k = _div_floor(newmc * newmc, w2)
    beta = _div_floor(data + k, newmc + k)
    scaled = newmc * beta
    log_beta = torch.log(torch.where(beta > 1e-30, beta, 1e-30))
    penalty = k * (beta - 1.0 - log_beta)
    stat = torch.where(data > 0, scaled - data + _safe_log_ratio(data, scaled), scaled)
    result = torch.where(zero_mask, 0.0, stat + penalty)
    return torch.where(w2 == 0, poisson_llh(data, mc), result)


def icecube_llh(data: torch.Tensor, mc: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """IceCube effective-count stat (``SampleHandlerBase.cpp:132-165``)."""
    data, mc, w2 = _f64(data), _f64(mc), _f64(w2)
    b = _div_floor(mc, w2)
    a = mc * b + 1.0
    stat = -(
        a * torch.log(b.clamp(min=1e-30))
        + gammaln(data + a)
        - gammaln(data + 1.0)
        - (data + a) * torch.log1p(b)
        - gammaln(a)
    )
    # Low-MC cap: when mc <= data, never exceed Poisson(data, bound); when
    # additionally data <= bound, return 0.
    poisson_low = poisson_llh(data, torch.full_like(data, LOW_MC_BOUND))
    capped = torch.where(stat > poisson_low, poisson_low, stat)
    stat = torch.where(mc <= data, torch.where(data <= LOW_MC_BOUND, 0.0, capped), stat)
    return torch.where(w2 == 0, poisson_llh(data, mc), stat)


def pearson_llh(data: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
    """Pearson chi2 / 2 (``SampleHandlerBase.cpp:167-183``)."""
    data, mc = _f64(data), _f64(mc)
    low = LOW_MC_BOUND
    general = _div_floor((data - mc) ** 2, 2.0 * mc)
    at_bound = (data - low) ** 2 / (2.0 * low)
    low_mc = torch.where(data > low, at_bound, torch.where(data >= mc, 0.0, general))
    return torch.where(data == 0, mc / 2.0, torch.where(mc < low, low_mc, general))


def gaussian_llh(data: torch.Tensor, mc: torch.Tensor) -> torch.Tensor:
    """Fixed-variance (Neyman) Gaussian: (d-mc)^2 / (2 max(d,1))."""
    data, mc = _f64(data), _f64(mc)
    return (data - mc) ** 2 / (2.0 * data.clamp(min=1.0))


def get_test_stat_fn(
    stat: TestStatistic | str,
) -> Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]:
    """Return ``f(data, mc, w2) -> per-bin -LLH`` for the chosen statistic."""
    if isinstance(stat, str):
        stat = TestStatistic(stat)
    if stat is TestStatistic.POISSON:
        return lambda data, mc, w2: poisson_llh(data, mc)
    if stat is TestStatistic.BARLOW_BEESTON:
        return barlow_beeston_llh
    if stat is TestStatistic.DEMBINSKI_ABDELMOTTELEB:
        return dembinski_abdelmotteleb_llh
    if stat is TestStatistic.ICECUBE:
        return icecube_llh
    if stat is TestStatistic.PEARSON:
        return lambda data, mc, w2: pearson_llh(data, mc)
    if stat is TestStatistic.GAUSSIAN:
        return lambda data, mc, w2: gaussian_llh(data, mc)
    raise ValueError(f"Unknown test statistic: {stat}")
