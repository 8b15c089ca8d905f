"""Real-pair algebra for 3x3 oscillation matrices (port of
``mach3_tpu/osc/kernels.py``).

Plain torch ops on (re, im) pairs of [..., 3, 3] tensors: closed-form
Cardano eigenvalues of the Hermitian Hamiltonian, an optional Newton polish
on the characteristic polynomial (f32 matrices with f64 phases), and the
Newton divided-difference form of exp(-i H L), which stays stable when
eigenvalues are degenerate. The JAX package wrote this as plain jnp, not
Pallas, so it has no kernel of its own here.
"""
from __future__ import annotations

import math

import torch

from ..core.device import as_device_tensor

Pair = tuple[torch.Tensor, torch.Tensor]


def _mm3(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Batched 3x3 product, unrolled (the JAX package's summation order)."""
    rows = []
    for i in range(3):
        cols = [
            x[..., i, 0] * y[..., 0, k] + x[..., i, 1] * y[..., 1, k] + x[..., i, 2] * y[..., 2, k]
            for k in range(3)
        ]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def c_matmul(a: Pair, b: Pair) -> Pair:
    """(ar + i ai) @ (br + i bi) on [..., 3, 3] batches."""
    ar, ai = a
    br, bi = b
    return _mm3(ar, br) - _mm3(ai, bi), _mm3(ar, bi) + _mm3(ai, br)


def c_abs2(a: Pair) -> torch.Tensor:
    return a[0] * a[0] + a[1] * a[1]


def herm_det(hr: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Real determinant of a Hermitian 3x3 batch (first-row expansion)."""

    def cof_re(i1, j1, i2, j2):
        return hr[..., i1, j1] * hr[..., i2, j2] - hi[..., i1, j1] * hi[..., i2, j2]

    def cof_im(i1, j1, i2, j2):
        return hr[..., i1, j1] * hi[..., i2, j2] + hi[..., i1, j1] * hr[..., i2, j2]

    det = torch.zeros_like(hr[..., 0, 0])
    for j, (c1, c2), sign in (
        (0, ((1, 1), (2, 2)), 1.0),
        (0, ((1, 2), (2, 1)), -1.0),
        (1, ((1, 0), (2, 2)), -1.0),
        (1, ((1, 2), (2, 0)), 1.0),
        (2, ((1, 0), (2, 1)), 1.0),
        (2, ((1, 1), (2, 0)), -1.0),
    ):
        m_re = cof_re(*c1, *c2)
        m_im = cof_im(*c1, *c2)
        det = det + sign * (hr[..., 0, j] * m_re - hi[..., 0, j] * m_im)
    return det


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def herm_eigvals(hr: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Closed-form eigenvalues of a Hermitian 3x3 batch -> [..., 3]
    (trigonometric Cardano, cf. Kopp physics/0610206)."""
    q = (hr[..., 0, 0] + hr[..., 1, 1] + hr[..., 2, 2]) / 3.0
    dr = hr - q[..., None, None] * _eye(hr)
    p2 = ((dr * dr).sum((-2, -1)) + (hi * hi).sum((-2, -1))) / 6.0
    p = torch.sqrt(p2.clamp(min=1e-30))
    r = herm_det(dr, hi) / (2.0 * p * p * p)
    tiny = 4e-7 if hr.dtype == torch.float32 else 1e-13
    r_c = r.clamp(-1.0, 1.0)
    interior = r_c.abs() < 1.0 - tiny
    phi = torch.where(
        interior,
        torch.arccos(torch.where(interior, r_c, 0.0)),
        torch.where(r_c > 0.0, torch.zeros_like(r_c), torch.full_like(r_c, math.pi)),
    )
    k = torch.arange(3, dtype=hr.dtype, device=hr.device)
    ang = (phi[..., None] + 2.0 * math.pi * k) / 3.0
    return q[..., None] + 2.0 * p[..., None] * torch.cos(ang)


def herm_char_poly(hr: torch.Tensor, hi: torch.Tensor):
    """(tr, c1, det) of p(λ) = λ³ − tr·λ² + c1·λ − det."""
    tr = hr[..., 0, 0] + hr[..., 1, 1] + hr[..., 2, 2]
    c1 = torch.zeros_like(tr)
    for i, j in ((0, 1), (0, 2), (1, 2)):
        c1 = c1 + (
            hr[..., i, i] * hr[..., j, j]
            - hr[..., i, j] * hr[..., i, j]
            - hi[..., i, j] * hi[..., i, j]
        )
    return tr, c1, herm_det(hr, hi)


def newton_refined_eigvals(
    seeds: torch.Tensor, hr_p: torch.Tensor, hi_p: torch.Tensor, dtype
) -> torch.Tensor:
    """Polish low-precision eigenvalue seeds to ``dtype`` with two Newton
    steps on the characteristic polynomial; the closest pair is recovered by
    deflating the cubic by the lone root and solving the quadratic."""
    tr, c1, det = herm_char_poly(hr_p.to(dtype), hi_p.to(dtype))
    trn, c1n, detn = tr[..., None], c1[..., None], det[..., None]
    s2 = (trn * trn / 9.0 - c1n / 3.0).clamp(min=1e-30)
    lam = torch.sort(seeds.to(dtype), dim=-1).values
    for _ in range(2):
        pval = ((lam - trn) * lam + c1n) * lam - detn
        pder = (3.0 * lam - 2.0 * trn) * lam + c1n
        ok = pder.abs() > 1e-10 * s2
        delta = torch.where(ok, pval / torch.where(ok, pder, 1.0), 0.0)
        bound = torch.sqrt(s2)
        lam = lam - torch.minimum(torch.maximum(delta, -bound), bound)
    pair_low = lam[..., 1] - lam[..., 0] < lam[..., 2] - lam[..., 1]
    lone = torch.where(pair_low, lam[..., 2], lam[..., 0])
    s = tr - lone
    q = c1 - lone * s
    half = 0.5 * s
    disc = half * half - q
    pos = disc > 1e-30 * s2[..., 0]
    r = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    out = torch.stack(
        [
            torch.where(pair_low, half - r, lone),
            torch.where(pair_low, half + r, half - r),
            torch.where(pair_low, lone, half + r),
        ],
        dim=-1,
    )
    return torch.sort(out, dim=-1).values


_TWO_PI = 6.283185307179586476925286766559


def _reduced_sincos(x: torch.Tensor, trig_dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin x, cos x) with the range reduction mod 2π in x's dtype and the
    trig in ``trig_dtype`` (kept from the JAX package so f32 phases round
    the same way)."""
    red = (x - _TWO_PI * torch.round(x * (1.0 / _TWO_PI))).to(trig_dtype)
    return torch.sin(red), torch.cos(red)


def _sinc(x: torch.Tensor, sin_x: torch.Tensor) -> torch.Tensor:
    small = x.abs() < 1e-4
    safe = torch.where(small, 1.0, x)
    return torch.where(small, 1.0 - x * x / 6.0, sin_x / safe)


def _phase_dd(a, b, length, trig_dtype) -> Pair:
    """First divided difference of f(λ) = exp(-i λ L):
    −i L e^{−i(a+b)L/2} sinc((a−b)L/2), exact as a → b."""
    m = 0.5 * (a + b) * length
    d = 0.5 * (a - b) * length
    sin_m, cos_m = _reduced_sincos(m, trig_dtype)
    sin_d, _ = _reduced_sincos(d, trig_dtype)
    s = length.to(trig_dtype) * _sinc(d.to(trig_dtype), sin_d)
    return -s * sin_m, -s * cos_m


def herm_eigensystem(hr, hi, phase_dtype=None, h_phase: Pair | None = None) -> dict:
    """Sorted eigenvalues (in ``phase_dtype``) plus the Newton factors
    (H − λ1) and (H − λ1)(H − λ2) in the matrix dtype."""
    phase_dtype = phase_dtype or hr.dtype
    hr_p, hi_p = h_phase if h_phase is not None else (hr, hi)
    if phase_dtype != hr.dtype:
        seeds = herm_eigvals(hr, hi)
        lam_p = newton_refined_eigvals(seeds, hr_p, hi_p, phase_dtype)
    else:
        lam_p = torch.sort(
            herm_eigvals(hr_p.to(phase_dtype), hi_p.to(phase_dtype)), dim=-1
        ).values
    lam = lam_p.to(hr.dtype)
    eye = _eye(hr)
    m1_r = hr - lam[..., 0, None, None] * eye
    m2_r = hr - lam[..., 1, None, None] * eye
    q_r, q_i = c_matmul((m1_r, hi), (m2_r, hi))
    return dict(lam_p=lam_p, m1_r=m1_r, hi=hi, q_r=q_r, q_i=q_i)


def evolution_from_eigensystem(eig: dict, length) -> Pair:
    """exp(-i H L) = f(λ1) I + f[λ1,λ2] (H − λ1) + f[λ1,λ2,λ3] (H − λ1)(H − λ2)
    with f(λ) = exp(-i λ L)."""
    lam_p, m1_r, hi = eig["lam_p"], eig["m1_r"], eig["hi"]
    q_r, q_i = eig["q_r"], eig["q_i"]
    trig_dtype = m1_r.dtype
    length_p = as_device_tensor(length, lam_p.dtype, lam_p.device)
    l1, l2, l3 = lam_p[..., 0], lam_p[..., 1], lam_p[..., 2]

    sin_p1, cos_p1 = _reduced_sincos(l1 * length_p, trig_dtype)
    f1_r, f1_i = cos_p1, -sin_p1
    f12_r, f12_i = _phase_dd(l1, l2, length_p, trig_dtype)
    f23_r, f23_i = _phase_dd(l2, l3, length_p, trig_dtype)
    d13 = (l1 - l3).to(trig_dtype)
    inv13 = torch.where(d13.abs() < 1e-30, 0.0, 1.0 / torch.where(d13 == 0, 1.0, d13))
    f123_r = (f12_r - f23_r) * inv13
    f123_i = (f12_i - f23_i) * inv13

    eye = _eye(m1_r)

    def bc(v):
        return v[..., None, None]

    out_r = (bc(f1_r) * eye + bc(f12_r) * m1_r - bc(f12_i) * hi
             + bc(f123_r) * q_r - bc(f123_i) * q_i)
    out_i = (bc(f1_i) * eye + bc(f12_r) * hi + bc(f12_i) * m1_r
             + bc(f123_r) * q_i + bc(f123_i) * q_r)
    return out_r, out_i


def herm_evolution(hr, hi, length, phase_dtype=None, h_phase: Pair | None = None) -> Pair:
    """exp(-i H L) for a Hermitian 3x3 batch, all-real ops."""
    eig = herm_eigensystem(hr, hi, phase_dtype=phase_dtype, h_phase=h_phase)
    return evolution_from_eigensystem(eig, length)
