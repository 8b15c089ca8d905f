"""The Barlow-Beeston-lite statistic per bin (Conway, arXiv:1103.0354 eq. 10-11):
the MC scaled by the analytic β that minimises Poisson(data | β·mc) times
Gauss(β | 1, σ_rel²), σ_rel² = Σw² / mc², plus the penalty (β-1)²/(2σ_rel²);
bins with almost no MC (below ``LOW_MC_BOUND``) are clamped as the MaCh3
library does. All in the dtype of the inputs."""
from __future__ import annotations

import torch

LOW_MC_BOUND = 1e-5


def _div(num, den, floor=1e-30):
    ok = den > floor
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)), num / floor)


def _log_ratio(data, mc):
    """data · log(data / mc), 0 where data is 0."""
    ratio = _div(data.clamp(min=1e-30), mc)
    return torch.where(data > 0, data * torch.log(ratio), torch.zeros_like(data))


def barlow_beeston(data: torch.Tensor, mc: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    low = mc < LOW_MC_BOUND
    newmc = torch.where(low & (data > LOW_MC_BOUND), torch.full_like(mc, LOW_MC_BOUND), mc)
    skip = low & (data <= LOW_MC_BOUND) & (data >= mc)
    frac2 = _div(w2, newmc * newmc)
    temp = newmc * frac2 - 1.0
    disc = temp * temp + 4.0 * data * frac2
    ok = disc > 1e-30
    root = torch.where(ok, torch.sqrt(torch.where(ok, disc, torch.ones_like(disc))),
                       torch.zeros_like(disc))
    beta = 0.5 * (-temp + root)
    scaled = newmc * beta
    stat = torch.where(data > 0, scaled - data + _log_ratio(data, scaled), mc * beta)
    penalty = torch.where(frac2 > 0, _div((beta - 1.0) ** 2, 2.0 * frac2), torch.zeros_like(beta))
    return torch.where(skip, torch.zeros_like(stat), stat + penalty)
