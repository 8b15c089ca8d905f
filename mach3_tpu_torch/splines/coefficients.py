"""Spline coefficient construction for the five interpolation families.

Equivalent of the reference's reduced-response-function layer
(``Splines/SplineStructs.h:131-700``): the reference strips ROOT ``TSpline3``
objects into ``{x, y, b, c, d}`` knot arrays and *recomputes* coefficients for
five interpolation types. Here there is no ROOT: coefficients are built directly
from knot (x, y) arrays in numpy at load time, vectorised over many splines at
once, and handed to the monolith as dense arrays.

Convention (identical to the reference): on segment ``i`` with local coordinate
``t = x - x_i``, the response is ``y_i + b_i t + c_i t^2 + d_i t^3``.

Families:

* ``TSpline3``        — natural cubic spline (ROOT TSpline3 / tridiagonal solve)
* ``Linear``          — piecewise linear (c = d = 0)
* ``Monotonic``       — Fritsch-Carlson tangent clamping per segment
  (``SplineStructs.h:450-560``; segment-local monotonicity, not global)
* ``Akima``           — Akima's weighted-secant tangents (``SplineStructs.h:375-449``)
* ``KochanekBartels`` — TCB spline with tension=continuity=bias=0 (Catmull-Rom-like
  tangents, ``SplineStructs.h:573+``)

All families accept ``x: [K]`` shared knot positions and ``y: [..., K]`` batched
responses, returning ``(b, c, d): each [..., K]`` (the last knot's coefficients
are only used for clamped extrapolation).
"""
from __future__ import annotations

import numpy as np

from ..params.parameterset import SplineInterpolation


def _as_batched(y: np.ndarray) -> tuple[np.ndarray, bool]:
    y = np.asarray(y, np.float64)
    if y.ndim == 1:
        return y[None, :], True
    return y.reshape(-1, y.shape[-1]), False


def natural_cubic_coefficients(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, ...]:
    """Natural cubic spline (y'' = 0 at both ends), matching ROOT TSpline3 with
    default boundary conditions — the reference's ``kTSpline3`` family."""
    x = np.asarray(x, np.float64)
    yb, squeeze = _as_batched(y)
    n = x.shape[0]
    m = yb.shape[0]
    if n < 2:
        raise ValueError("Need at least 2 knots")
    h = np.diff(x)  # [K-1]
    if n == 2:
        b = (yb[:, 1:] - yb[:, :-1]) / h
        b = np.concatenate([b, b[:, -1:]], axis=1)
        c = np.zeros_like(yb)
        d = np.zeros_like(yb)
    else:
        # Solve tridiagonal system for second derivatives sigma (natural BCs).
        # Interior equations: h[i-1] s[i-1] + 2(h[i-1]+h[i]) s[i] + h[i] s[i+1]
        #                     = 6 ((y[i+1]-y[i])/h[i] - (y[i]-y[i-1])/h[i-1])
        slopes = (yb[:, 1:] - yb[:, :-1]) / h  # [m, K-1]
        rhs = 6.0 * (slopes[:, 1:] - slopes[:, :-1])  # [m, K-2]
        diag = 2.0 * (h[:-1] + h[1:])  # [K-2]
        lower = h[1:-1].copy()  # sub/super diagonal [K-3]
        # Thomas algorithm, batched over m (coefficients shared across batch).
        nint = n - 2
        cp = np.zeros(nint)
        dp = np.zeros((m, nint))
        cp[0] = lower[0] / diag[0] if nint > 1 else 0.0
        dp[:, 0] = rhs[:, 0] / diag[0]
        for i in range(1, nint):
            denom = diag[i] - (lower[i - 1] * cp[i - 1] if i >= 1 else 0.0)
            cp[i] = lower[i] / denom if i < nint - 1 else 0.0
            dp[:, i] = (rhs[:, i] - lower[i - 1] * dp[:, i - 1]) / denom
        sigma = np.zeros((m, n))
        sigma[:, nint] = dp[:, nint - 1]
        for i in range(nint - 2, -1, -1):
            sigma[:, i + 1] = dp[:, i] - cp[i] * sigma[:, i + 2]
        # Convert to (b, c, d) per segment
        b = np.zeros_like(yb)
        c = np.zeros_like(yb)
        d = np.zeros_like(yb)
        b[:, :-1] = slopes - h * (2.0 * sigma[:, :-1] + sigma[:, 1:]) / 6.0
        c[:, :-1] = sigma[:, :-1] / 2.0
        d[:, :-1] = (sigma[:, 1:] - sigma[:, :-1]) / (6.0 * h)
        # Last knot: slope at the end (used only for clamped extrapolation)
        b[:, -1] = b[:, -2] + 2.0 * c[:, -2] * h[-1] + 3.0 * d[:, -2] * h[-1] ** 2
    if squeeze:
        return b[0], c[0], d[0]
    shape = np.asarray(y).shape
    return b.reshape(shape), c.reshape(shape), d.reshape(shape)


def linear_coefficients(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, ...]:
    """Piecewise linear (``SplineStructs.h`` kLinear: b = secant, c = d = 0)."""
    x = np.asarray(x, np.float64)
    yb, squeeze = _as_batched(y)
    h = np.diff(x)
    b = np.concatenate([(yb[:, 1:] - yb[:, :-1]) / h, np.zeros((yb.shape[0], 1))], axis=1)
    b[:, -1] = b[:, -2]  # reference carries the last slope forward
    c = np.zeros_like(yb)
    d = np.zeros_like(yb)
    if squeeze:
        return b[0], c[0], d[0]
    shape = np.asarray(y).shape
    return b.reshape(shape), c.reshape(shape), d.reshape(shape)


def _hermite_to_poly(
    x: np.ndarray, yb: np.ndarray, tangents: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Convert per-knot tangents (cubic Hermite form) to (b, c, d) coefficients."""
    h = np.diff(x)
    slopes = (yb[:, 1:] - yb[:, :-1]) / h
    t0 = tangents[:, :-1]
    t1 = tangents[:, 1:]
    b = np.zeros_like(yb)
    c = np.zeros_like(yb)
    d = np.zeros_like(yb)
    b[:, :-1] = t0
    c[:, :-1] = (3.0 * slopes - 2.0 * t0 - t1) / h
    d[:, :-1] = (t0 + t1 - 2.0 * slopes) / (h * h)
    b[:, -1] = tangents[:, -1]
    return b, c, d


def monotonic_coefficients(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, ...]:
    """Fritsch-Carlson monotone cubic (reference ``kMonotonic``,
    ``SplineStructs.h:450-560``): tangents from centered secants, then clamped
    so each segment's interpolant stays between its two knots."""
    x = np.asarray(x, np.float64)
    yb, squeeze = _as_batched(y)
    n = x.shape[0]
    h = np.diff(x)
    secants = (yb[:, 1:] - yb[:, :-1]) / h  # [m, K-1]

    tangents = np.zeros_like(yb)
    if n == 2:
        tangents[:, :] = secants[:, [0, 0]]
    else:
        tangents[:, 0] = secants[:, 0]
        tangents[:, -1] = secants[:, -1]
        # Interior: average of adjacent secants; zero at local extrema
        avg = 0.5 * (secants[:, :-1] + secants[:, 1:])
        sign_change = secants[:, :-1] * secants[:, 1:] <= 0
        tangents[:, 1:-1] = np.where(sign_change, 0.0, avg)

    # Fritsch-Carlson clamping: if alpha^2 + beta^2 > 9, scale both tangents
    # of the segment down to the circle of radius 3.
    with np.errstate(divide="ignore", invalid="ignore"):
        alpha = np.where(secants != 0, tangents[:, :-1] / secants, 0.0)
        beta = np.where(secants != 0, tangents[:, 1:] / secants, 0.0)
    # Flat segments force zero tangents at both ends of the segment
    flat = secants == 0
    r2 = alpha**2 + beta**2
    need = r2 > 9.0
    tau = np.where(need, 3.0 / np.sqrt(np.maximum(r2, 1e-300)), 1.0)
    # Apply the most restrictive scaling touching each knot
    scale = np.ones_like(yb)
    scale[:, :-1] = np.minimum(scale[:, :-1], np.where(flat, 0.0, tau))
    scale[:, 1:] = np.minimum(scale[:, 1:], np.where(flat, 0.0, tau))
    tangents = tangents * scale

    b, c, d = _hermite_to_poly(x, yb, tangents)
    if squeeze:
        return b[0], c[0], d[0]
    shape = np.asarray(y).shape
    return b.reshape(shape), c.reshape(shape), d.reshape(shape)


def akima_coefficients(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, ...]:
    """Akima spline (reference ``kAkima``, ``SplineStructs.h:375-449``):
    tangents are the |dm|-weighted average of neighbouring secants, with the
    standard two-point extrapolation of exterior secants."""
    x = np.asarray(x, np.float64)
    yb, squeeze = _as_batched(y)
    n = x.shape[0]
    m = yb.shape[0]
    h = np.diff(x)
    sec = (yb[:, 1:] - yb[:, :-1]) / h  # [m, n-1]

    # Extended secants m[-2], m[-1], m[0..n-2], m[n-1], m[n]
    ext = np.zeros((m, n + 3))
    ext[:, 2 : n + 1] = sec
    ext[:, 1] = 2.0 * sec[:, 0] - sec[:, 1]
    ext[:, 0] = 3.0 * sec[:, 0] - 2.0 * sec[:, 1]
    ext[:, n + 1] = 2.0 * sec[:, -1] - sec[:, -2]
    ext[:, n + 2] = 3.0 * sec[:, -1] - 2.0 * sec[:, -2]

    # Tangent at knot i uses ext[i .. i+3]
    w1 = np.abs(ext[:, 3 : n + 3] - ext[:, 2 : n + 2])  # |m_{i+1} - m_i|
    w2 = np.abs(ext[:, 1 : n + 1] - ext[:, 0:n])  # |m_{i-1} - m_{i-2}|
    denom = w1 + w2
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (w1 * ext[:, 1 : n + 1] + w2 * ext[:, 2 : n + 2]) / denom
    tangents = np.where(denom != 0, t, ext[:, 2 : n + 2])

    b, c, d = _hermite_to_poly(x, yb, tangents)
    if squeeze:
        return b[0], c[0], d[0]
    shape = np.asarray(y).shape
    return b.reshape(shape), c.reshape(shape), d.reshape(shape)


def kochanek_bartels_coefficients(
    x: np.ndarray, y: np.ndarray, tension: float = 0.0, continuity: float = 0.0, bias: float = 0.0
) -> tuple[np.ndarray, ...]:
    """Kochanek-Bartels (TCB) spline (reference ``kKochanekBartels``).

    With the default tension/continuity/bias of 0 the tangents reduce to
    Catmull-Rom-style centered differences; endpoints use one-sided secants.
    """
    x = np.asarray(x, np.float64)
    yb, squeeze = _as_batched(y)
    n = x.shape[0]
    h = np.diff(x)
    sec = (yb[:, 1:] - yb[:, :-1]) / h

    ta = (1 - tension) * (1 + bias) * (1 + continuity) / 2.0
    tb = (1 - tension) * (1 - bias) * (1 - continuity) / 2.0
    tangents = np.zeros_like(yb)
    if n == 2:
        tangents[:, :] = sec[:, [0, 0]]
    else:
        tangents[:, 0] = sec[:, 0]
        tangents[:, -1] = sec[:, -1]
        tangents[:, 1:-1] = ta * sec[:, :-1] + tb * sec[:, 1:]

    b, c, d = _hermite_to_poly(x, yb, tangents)
    if squeeze:
        return b[0], c[0], d[0]
    shape = np.asarray(y).shape
    return b.reshape(shape), c.reshape(shape), d.reshape(shape)


_FAMILIES = {
    SplineInterpolation.TSPLINE3: natural_cubic_coefficients,
    SplineInterpolation.LINEAR: linear_coefficients,
    SplineInterpolation.MONOTONIC: monotonic_coefficients,
    SplineInterpolation.AKIMA: akima_coefficients,
    SplineInterpolation.KOCHANEK_BARTELS: kochanek_bartels_coefficients,
}


def build_coefficients(
    x: np.ndarray, y: np.ndarray, interpolation: SplineInterpolation | str
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Dispatch to the requested interpolation family; returns (b, c, d)."""
    if isinstance(interpolation, str):
        interpolation = SplineInterpolation(interpolation)
    return _FAMILIES[interpolation](x, y)


def evaluate_spline_np(
    x: np.ndarray,
    y: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    d: np.ndarray,
    xq: np.ndarray,
) -> np.ndarray:
    """Numpy reference evaluator (clamped outside the knot range like the
    reference's segment search, ``Splines/SplineBase.cpp:44-110``)."""
    xq = np.asarray(xq, np.float64)
    seg = np.clip(np.searchsorted(x, xq, side="right") - 1, 0, len(x) - 2)
    t = xq - x[seg]
    return y[..., seg] + b[..., seg] * t + c[..., seg] * t**2 + d[..., seg] * t**3
