"""Three-flavour oscillation probabilities, plainly: the PMNS matrix (PDG
convention), the flavour-basis Hamiltonian with the MSW potential, its
eigensystem from ``torch.linalg.eigh`` in complex128, exp(-i H L) for each
layer of constant density and their ordered product; and the PREM paths of
the atmospheric zeniths. Flavours are (e, mu, tau); ``P[..., a, b]`` is
P(nu_a -> nu_b). Units: Δm² in eV², E in GeV, L in km, ρ in g/cm³."""
from __future__ import annotations

import numpy as np
import torch

#: Δm² L / (4E) in radians per (eV² km / GeV): 1 / (4 ħc).
OSC_PHASE = 1.266932679419849
#: The matter potential A = 2√2 G_F N_e E in eV² per (Ye ρ[g/cm³] E[GeV]).
MATTER_A = 1.5264932435736812e-4
EARTH_RADIUS_KM = 6371.0
#: Four-zone PREM (Dziewonski & Anderson 1981): (outer radius, ρ, Ye).
PREM = ((1221.5, 13.0, 0.4656), (3480.0, 11.3, 0.4656), (5701.0, 5.0, 0.4957),
        (6346.6, 3.9, 0.4957), (6371.0, 2.6, 0.4957))


def pmns(osc: torch.Tensor, cdtype=torch.complex128) -> torch.Tensor:
    """osc [C, 6] (sin²θ12, sin²θ13, sin²θ23, δCP, Δm²21, Δm²31) -> U [C, 3, 3]."""
    s12, s13, s23 = (torch.sqrt(osc[:, i]) for i in range(3))
    c12, c13, c23 = (torch.sqrt(1.0 - osc[:, i]) for i in range(3))
    e = torch.polar(torch.ones_like(osc[:, 3]), osc[:, 3]).to(cdtype)
    r = lambda v: v.to(cdtype)  # noqa: E731
    rows = [[r(c12 * c13), r(s12 * c13), r(s13) * e.conj()],
            [r(-s12 * c23) - r(c12 * s23 * s13) * e, r(c12 * c23) - r(s12 * s23 * s13) * e,
             r(s23 * c13)],
            [r(s12 * s23) - r(c12 * c23 * s13) * e, r(-c12 * s23) - r(s12 * c23 * s13) * e,
             r(c23 * c13)]]
    return torch.stack([torch.stack(row, -1) for row in rows], -2)


def hamiltonian(osc: torch.Tensor, energy: torch.Tensor, ye_rho: torch.Tensor, anti: bool,
                cdtype=torch.complex128) -> torch.Tensor:
    """H per km [C, *ye_rho.shape, 3, 3]: (2 OSC_PHASE / E)(U diag(0, Δm²21,
    Δm²31) U† ± diag(A, 0, 0)); U -> U* and A -> -A for antineutrinos.
    ``energy`` broadcasts against ``ye_rho``."""
    u = pmns(osc, cdtype)
    if anti:
        u = u.conj()
    m2 = torch.stack([torch.zeros_like(osc[:, 4]), osc[:, 4], osc[:, 5]], -1).to(cdtype)
    vac = (u * m2[:, None, :]) @ u.conj().transpose(-1, -2)  # [C, 3, 3]
    lead = ye_rho.shape
    a = (-1.0 if anti else 1.0) * MATTER_A * ye_rho * energy  # [*lead]
    h = vac.reshape((-1,) + (1,) * len(lead) + (3, 3)).expand((osc.shape[0],) + lead + (3, 3))
    pot = torch.zeros(lead + (3, 3), dtype=cdtype, device=osc.device)
    pot[..., 0, 0] = a.to(cdtype)
    scale = (2.0 * OSC_PHASE / energy).to(cdtype)
    return (h + pot) * scale[..., None, None]


def evolution(h: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """exp(-i H L) of Hermitian H [..., 3, 3] over L [...] km."""
    lam, v = torch.linalg.eigh(h)
    ph = torch.polar(torch.ones_like(lam), -lam * length[..., None])
    return (v * ph[..., None, :]) @ v.conj().transpose(-1, -2)


def beam(osc: torch.Tensor, e_grid: torch.Tensor, baseline: float, density: float,
         anti: bool, ye: float = 0.5) -> torch.Tensor:
    """P [C, NE, 3, 3] at constant density."""
    h = hamiltonian(osc, e_grid, torch.full_like(e_grid, ye * density), anti)
    amp = evolution(h, torch.full_like(e_grid, baseline))  # amp[b, a] = <b|U|a>
    return (amp.abs() ** 2).transpose(-1, -2)


def prem_paths(cosz: np.ndarray, height_km: float):
    """For each zenith, the chord from ``height_km`` above the surface to a
    detector at the surface cut at the PREM shell boundaries: (lengths,
    Ye·ρ) as lists of segments from production to detector (air first)."""
    radii = np.array([s[0] for s in PREM])
    out = []
    r_det, r_prod = EARTH_RADIUS_KM, EARTH_RADIUS_KM + height_km
    for cz in np.asarray(cosz, np.float64):
        total = np.sqrt(r_prod ** 2 - r_det ** 2 * (1.0 - cz ** 2)) - r_det * cz
        if cz >= 0:
            out.append(([total], [0.0]))
            continue
        b = r_det * np.sqrt(1.0 - cz ** 2)  # impact parameter
        half_surface = np.sqrt(EARTH_RADIUS_KM ** 2 - b ** 2)
        air = total - (half_surface - r_det * cz)
        lengths, yrho = ([air], [0.0]) if air > 0 else ([], [])
        crossed = radii[radii > b]
        # Crossing points along the chord inside the earth, from entry.
        bounds = sorted({half_surface - np.sqrt(r ** 2 - b ** 2) for r in crossed[:-1]}
                        | {half_surface + np.sqrt(r ** 2 - b ** 2) for r in crossed[:-1]})
        end = 2.0 * half_surface
        pos = [0.0] + [p for p in bounds if 0.0 < p < end] + [end]
        for p0, p1 in zip(pos[:-1], pos[1:]):
            mid = 0.5 * (p0 + p1) - half_surface
            r = np.sqrt(b ** 2 + mid ** 2)
            k = min(int(np.searchsorted(radii, r)), len(PREM) - 1)
            lengths.append(p1 - p0)
            yrho.append(PREM[k][1] * PREM[k][2])
        out.append((lengths, yrho))
    return out


def layered(osc: torch.Tensor, e_grid: torch.Tensor, paths, anti: bool) -> torch.Tensor:
    """P [C, NZ, NE, 3, 3] along each zenith's path (layers in order); one
    eigensystem per distinct density."""
    yrs = sorted({yr for _, ys in paths for yr in ys})
    ye_rho = torch.tensor(yrs, dtype=torch.float64, device=osc.device)[:, None]
    h = hamiltonian(osc, e_grid[None, :], ye_rho.expand(-1, e_grid.shape[0]), anti)
    lam, v = torch.linalg.eigh(h)  # [C, NR, NE, 3], [C, NR, NE, 3, 3]
    vh = v.conj().transpose(-1, -2)
    cols = []
    for lengths, ys in paths:
        amp = None
        for length, yr in zip(lengths, ys):
            k = yrs.index(yr)
            ph = torch.polar(torch.ones_like(lam[:, k]), -lam[:, k] * length)
            op = (v[:, k] * ph[..., None, :]) @ vh[:, k]
            amp = op if amp is None else op @ amp
        cols.append((amp.abs() ** 2).transpose(-1, -2))
    return torch.stack(cols, 1)
