"""Special functions.

The JAX package carries a float64 Lanczos log-gamma because
``jax.scipy.special.gammaln`` is only ~1e-7 accurate in places; the reference's
IceCube statistic uses ``lgammal`` (``Samples/SampleHandlerBase.cpp:147``).
``torch.lgamma`` in float64 is accurate to double rounding, so it replaces
the Lanczos series here.
"""
from __future__ import annotations

import torch


def gammaln(z: torch.Tensor) -> torch.Tensor:
    """log|Gamma(z)| in float64."""
    return torch.lgamma(torch.as_tensor(z, dtype=torch.float64))
