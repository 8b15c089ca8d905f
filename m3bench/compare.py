"""Helpers of the comparison that decides ``correct``: the chain steps a run
checks, drawn from the seed, and each number compared beside its limit."""
from __future__ import annotations

import math

import numpy as np
import torch


def pick(rng: np.random.Generator, n: int, k: int) -> list[int]:
    """``k`` of ``range(n)`` drawn from ``rng``, always with the last."""
    if n <= k:
        return list(range(n))
    rest = rng.choice(n - 1, size=k - 1, replace=False)
    return sorted(int(i) for i in rest) + [n - 1]


def circular_wrap(x: torch.Tensor, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
    """Wrap into [low, high] (MaCh3's circular bounds, with fmod)."""
    width = high - low
    above = low + torch.fmod(x - high, width)
    below = high - torch.fmod(low - x, width)
    return torch.where(x > high, above, torch.where(x < low, below, x))


def judged(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}}). A
    number that is not finite fails."""
    out, ok = {}, True
    for name, value in numbers.items():
        lim = limits[name]
        v = float(value)
        out[name] = {"value": v, "limit": lim}
        ok &= math.isfinite(v) and v <= lim
    return ok, out
