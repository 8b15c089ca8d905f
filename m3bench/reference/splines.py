"""Spline responses from their knots: the five interpolation families'
polynomial coefficients (float64), rounded to the table precision
the configuration states, and the response of a chain batch (torch).

On segment ``i`` with ``t = x - x_i`` the response is
``y_i + b_i t + c_i t² + d_i t³``; the segment of ``x`` counts the knots
strictly below it, minus one, clamped to the first and last segment (cubic
extrapolation past the ends)."""
from __future__ import annotations

import numpy as np
import torch


def _hermite(x, y, tangents):
    h = x[1:] - x[:-1]
    sec = (y[:, 1:] - y[:, :-1]) / h
    t0, t1 = tangents[:, :-1], tangents[:, 1:]
    return t0, (3.0 * sec - 2.0 * t0 - t1) / h, (t0 + t1 - 2.0 * sec) / (h * h)


def _secants(x, y):
    return (y[:, 1:] - y[:, :-1]) / (x[1:] - x[:-1])


def natural_cubic(x, y):
    """Natural cubic spline (y'' = 0 at both ends: ROOT's TSpline3)."""
    n = x.shape[0]
    h = x[1:] - x[:-1]
    sec = _secants(x, y)
    # Second derivatives at the interior knots: a tridiagonal solve.
    a = torch.zeros((n - 2, n - 2), dtype=y.dtype, device=y.device)
    for i in range(n - 2):
        a[i, i] = 2.0 * (h[i] + h[i + 1])
        if i > 0:
            a[i, i - 1] = h[i]
        if i < n - 3:
            a[i, i + 1] = h[i + 1]
    rhs = 6.0 * (sec[:, 1:] - sec[:, :-1])
    sigma = torch.zeros_like(y)
    sigma[:, 1:-1] = torch.linalg.solve(a, rhs.T).T
    b = sec - h * (2.0 * sigma[:, :-1] + sigma[:, 1:]) / 6.0
    return b, sigma[:, :-1] / 2.0, (sigma[:, 1:] - sigma[:, :-1]) / (6.0 * h)


def linear(x, y):
    sec = _secants(x, y)
    return sec, torch.zeros_like(sec), torch.zeros_like(sec)


def monotonic(x, y):
    """Fritsch-Carlson: centred tangents, zero at a local extremum, scaled
    into the circle of radius 3 per segment (flat segments: both zero)."""
    sec = _secants(x, y)
    tan = torch.zeros_like(y)
    tan[:, 0], tan[:, -1] = sec[:, 0], sec[:, -1]
    tan[:, 1:-1] = torch.where(sec[:, :-1] * sec[:, 1:] <= 0, 0.0,
                               0.5 * (sec[:, :-1] + sec[:, 1:]))
    nz = sec != 0
    safe = torch.where(nz, sec, 1.0)
    al = torch.where(nz, tan[:, :-1] / safe, 0.0)
    be = torch.where(nz, tan[:, 1:] / safe, 0.0)
    r2 = al ** 2 + be ** 2
    tau = torch.where(r2 > 9.0, 3.0 / torch.sqrt(r2.clamp(min=1e-300)), 1.0)
    tau = torch.where(nz, tau, 0.0)
    scale = torch.ones_like(y)
    scale[:, :-1] = torch.minimum(scale[:, :-1], tau)
    scale[:, 1:] = torch.minimum(scale[:, 1:], tau)
    return _hermite(x, y, tan * scale)


def akima(x, y):
    """Akima: tangents as the |Δsecant|-weighted mean of the neighbouring
    secants, exterior secants extrapolated linearly."""
    n = x.shape[0]
    sec = _secants(x, y)
    m = torch.cat([3.0 * sec[:, :1] - 2.0 * sec[:, 1:2], 2.0 * sec[:, :1] - sec[:, 1:2], sec,
                   2.0 * sec[:, -1:] - sec[:, -2:-1], 3.0 * sec[:, -1:] - 2.0 * sec[:, -2:-1]], 1)
    w1 = (m[:, 3:n + 3] - m[:, 2:n + 2]).abs()
    w2 = (m[:, 1:n + 1] - m[:, 0:n]).abs()
    den = w1 + w2
    t = (w1 * m[:, 1:n + 1] + w2 * m[:, 2:n + 2]) / torch.where(den != 0, den, 1.0)
    return _hermite(x, y, torch.where(den != 0, t, m[:, 2:n + 2]))


def kochanek_bartels(x, y):
    """Kochanek-Bartels with tension, continuity and bias 0: centred
    (Catmull-Rom) tangents, one-sided at the ends."""
    sec = _secants(x, y)
    tan = torch.empty_like(y)
    tan[:, 0], tan[:, -1] = sec[:, 0], sec[:, -1]
    tan[:, 1:-1] = 0.5 * sec[:, :-1] + 0.5 * sec[:, 1:]
    return _hermite(x, y, tan)


FAMILIES = {"TSpline3": natural_cubic, "Linear": linear, "Monotonic": monotonic,
            "Akima": akima, "KochanekBartels": kochanek_bartels}


def coefficients(x, y, family: str, low: float, high: float, table_dtype: torch.dtype,
                 device=None):
    """[n, K-1, 4] (y, b, c, d) of each segment of n splines with knots at
    ``x`` and responses ``y`` [n, K] clipped to [low, high], in float64 on
    ``device``, rounded to the table's precision (through float32, as a
    table is filled) and returned as float64."""
    y = torch.as_tensor(np.asarray(y, np.float64), device=device).clamp(low, high)
    x = torch.as_tensor(np.asarray(x, np.float64), device=device)
    b, c, d = FAMILIES[family](x, y)
    co = torch.stack([y[:, :-1], b, c, d], -1)
    return co.to(torch.float32).to(table_dtype).to(torch.float64)


def segments(x_knots: torch.Tensor, values: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(segment, t) of ``values``: knots strictly below, minus one, clamped."""
    below = (x_knots < values[..., None]).sum(-1)
    seg = (below - 1).clamp(0, x_knots.shape[0] - 2)
    return seg, values - x_knots[seg]


def response(co: torch.Tensor, seg: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """co [n, S, 4], seg/t [C] -> [C, n]: each chain's segment, one Horner
    step."""
    rows = co.index_select(1, seg)  # [n, C, 4]
    tt = t[:, None]
    rows = rows.transpose(0, 1)
    return rows[..., 0] + tt * (rows[..., 1] + tt * (rows[..., 2] + tt * rows[..., 3]))
