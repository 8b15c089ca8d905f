"""The reference's atmospheric oscillation on its own, on the CPU and with
nothing of the program: ``prem_paths`` against the chord and the closed form
of the integral of Ye·ρ along it; ``layered`` against a propagation written
here (its own PMNS matrix and flavour-basis Hamiltonian from physical
constants, ``torch.linalg.matrix_exp`` layer by layer); and the limits: one
density, no matter, unitarity, and T symmetry on a symmetric profile."""
from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from m3bench.reference import osc as osc_ref

HERE = Path(__file__).resolve()
REPO = HERE.parents[2]
C128 = torch.complex128

#: ħc in eV·m (CODATA 2018), G_F in eV⁻² (PDG), Avogadro's number.
HBARC_EV_M = 1.973269804e-7
G_F = 1.1663787e-23
N_A = 6.02214076e23
#: Radians per km for a Hamiltonian entry of 1 eV.
PER_KM = 1e3 / HBARC_EV_M
#: √2 G_F N_e in eV per Ye·ρ [g/cm³]: N_e = Ye ρ N_A per cm³.
V_EV = math.sqrt(2.0) * G_F * N_A * (HBARC_EV_M * 1e2) ** 3

R_EARTH = 6371.0
BOUNDARIES = [r for r, _, _ in osc_ref.PREM[:-1]]  # shell radii below the surface
HEIGHTS = [15.0, 25.0]

#: (sin²θ12, sin²θ13, sin²θ23, δCP, Δm²21, Δm²31): normal ordering with δCP
#: near its fit, normal with δCP = 0, inverted with another δCP.
CASES = torch.tensor([[0.307, 0.022, 0.561, -1.601, 7.42e-5, 2.51e-3],
                      [0.303, 0.0223, 0.451, 0.0, 7.41e-5, 2.507e-3],
                      [0.310, 0.0224, 0.570, 2.2, 7.40e-5, -2.45e-3]], dtype=torch.float64)
#: GeV; 6 lies near the mantle's MSW resonance.
ENERGIES = torch.tensor([0.3, 1.0, 2.5, 6.0, 20.0], dtype=torch.float64)
#: Through the inner core, through the mantle only, grazing (the crust alone).
ZENITHS = [-0.99, -0.6, -0.05]


def _cosz_at(b: float) -> float:
    """The up-going zenith whose chord has impact parameter ``b`` km."""
    return -math.sqrt(1.0 - (b / R_EARTH) ** 2)


def _grid() -> list[float]:
    """cosZ over [-1, 1], the benchmark's grid, and on each side of every
    shell boundary below the surface a zenith 1e-6 km from it."""
    near = [_cosz_at(r + d) for r in BOUNDARIES for d in (-1e-6, 1e-6)]
    return sorted(set(np.linspace(-1.0, 1.0, 41).tolist())
                  | set(np.linspace(-0.99, 0.99, 20).tolist()) | set(near))


def _closed_form(b: float) -> float:
    """Σ over the shells the chord crosses of ρYe · 2(√(r_out² − b²) −
    √(max(r_in², b²) − b²))."""
    total, r_in = 0.0, 0.0
    for r_out, rho, ye in osc_ref.PREM:
        if r_out > b:
            inner = max(r_in ** 2, b ** 2)
            total += rho * ye * 2.0 * (math.sqrt(r_out ** 2 - b ** 2) - math.sqrt(inner - b ** 2))
        r_in = r_out
    return total


@pytest.mark.parametrize("height", HEIGHTS)
def test_prem_paths_geometry(height):
    grid = _grid()
    paths = osc_ref.prem_paths(np.asarray(grid), height)
    assert len(paths) == len(grid)
    r_prod = R_EARTH + height
    crossed = set()
    for cz, (lengths, ye_rho) in zip(grid, paths):
        b = R_EARTH * math.sqrt(1.0 - cz ** 2)
        chord = math.sqrt(r_prod ** 2 - b ** 2) - R_EARTH * cz
        assert len(lengths) == len(ye_rho) and min(lengths) > 0, cz
        assert math.isclose(sum(lengths), chord, rel_tol=1e-12), (cz, sum(lengths), chord)
        if cz >= 0:
            assert ye_rho == [0.0], cz
            continue
        assert ye_rho[0] == 0.0 and 0.0 not in ye_rho[1:], (cz, ye_rho)
        inside, dens = lengths[1:], ye_rho[1:]
        k = sum(r > b for r, _, _ in osc_ref.PREM)
        assert len(inside) == 2 * k - 1, (cz, k, len(inside))
        crossed.add(k)
        assert dens == dens[::-1], (cz, dens)
        assert np.allclose(inside, inside[::-1], rtol=0, atol=1e-9), (cz, inside)
        integral = math.fsum(l * y for l, y in zip(inside, dens))
        want = _closed_form(b)
        assert abs(integral - want) <= 1e-12 * want, (cz, integral, want)
    assert -1.0 in grid and crossed == set(range(1, len(osc_ref.PREM) + 1))


# An independent propagation -------------------------------------------------

def pdg_pmns(case: torch.Tensor) -> torch.Tensor:
    """U = R23 · U13(δ) · R12 (the PDG's product form)."""
    s12, s13, s23 = (math.sqrt(float(case[i])) for i in range(3))
    c12, c13, c23 = (math.sqrt(1.0 - float(case[i])) for i in range(3))
    e = complex(math.cos(float(case[3])), math.sin(float(case[3])))
    r23 = torch.tensor([[1, 0, 0], [0, c23, s23], [0, -s23, c23]], dtype=C128)
    u13 = torch.tensor([[c13, 0, s13 / e], [0, 1, 0], [-s13 * e, 0, c13]], dtype=C128)
    r12 = torch.tensor([[c12, s12, 0], [-s12, c12, 0], [0, 0, 1]], dtype=C128)
    return r23 @ u13 @ r12


def flavour_hamiltonian(case, energy_gev: float, ye_rho: float, anti: bool) -> torch.Tensor:
    """H in radians per km: U diag(0, Δm²21, Δm²31) U† / 2E ± diag(√2 G_F N_e, 0, 0)."""
    u = pdg_pmns(case)
    if anti:
        u = u.conj()
    m2 = torch.diag(torch.tensor([0.0, float(case[4]), float(case[5])], dtype=C128))
    h = u @ m2 @ u.conj().T / (2.0 * energy_gev * 1e9)
    h[0, 0] += (-1.0 if anti else 1.0) * V_EV * ye_rho
    return h * PER_KM


def propagate(case, energy_gev: float, path, anti: bool) -> torch.Tensor:
    """P[a, b] = P(ν_a → ν_b): each flavour state evolved layer by layer.

    Each layer's exponent gains one radian times the identity, a global
    phase that no probability sees: it keeps the exponent's norm out of
    0.005-0.07, where ``matrix_exp`` in complex128 loses digits (3e-11 at
    0.05 against mpmath; a 15 km air layer at a few GeV lies there)."""
    psi = torch.eye(3, dtype=C128)  # column a: the state that started as ν_a
    for length, ye_rho in zip(*path):
        h = flavour_hamiltonian(case, energy_gev, ye_rho, anti)
        psi = torch.linalg.matrix_exp(-1j * (h * length + torch.eye(3, dtype=C128))) @ psi
    return (psi.abs() ** 2).T


def vacuum(case, energy_gev: float, length: float, anti: bool) -> torch.Tensor:
    """P[a, b] in vacuum: δ_ab − 4 Σ_{i>j} Re(J) sin²Δ_ij + 2 Σ_{i>j} Im(J) sin 2Δ_ij,
    J = U*_ai U_bi U_aj U*_bj, Δ_ij = Δm²_ij L / 4E."""
    u = pdg_pmns(case)
    if anti:
        u = u.conj()
    m2 = [0.0, float(case[4]), float(case[5])]
    p = torch.eye(3, dtype=torch.float64)
    for i in range(3):
        for j in range(i):
            d = (m2[i] - m2[j]) * length * PER_KM / (4.0 * energy_gev * 1e9)
            jay = u[:, i].conj()[:, None] * u[:, i][None, :] * u[:, j][:, None] \
                * u[:, j].conj()[None, :]
            p += -4.0 * jay.real * math.sin(d) ** 2 + 2.0 * jay.imag * math.sin(2.0 * d)
    return p


@pytest.mark.parametrize("anti", [False, True], ids=["nu", "nubar"])
def test_layered_against_matrix_exp_layer_by_layer(anti):
    paths = osc_ref.prem_paths(np.array(ZENITHS), 15.0)
    assert [len(l) for l, _ in paths] == [10, 6, 2]  # air, then 2k - 1 shells
    got = osc_ref.layered(CASES, ENERGIES, paths, anti)
    assert got.shape == (len(CASES), len(ZENITHS), len(ENERGIES), 3, 3)
    worst = 0.0
    for c, case in enumerate(CASES):
        for z, path in enumerate(paths):
            for e, energy in enumerate(ENERGIES.tolist()):
                gap = (got[c, z, e] - propagate(case, energy, path, anti)).abs().max()
                worst = max(worst, float(gap))
    assert worst < 1e-10, worst
    # Matter matters at these zeniths: the check would see a vacuum stand-in.
    flat = [([sum(l)], [0.0]) for l, _ in paths]
    assert float((got - osc_ref.layered(CASES, ENERGIES, flat, anti)).abs().max()) > 0.1


# Limits ---------------------------------------------------------------------

@pytest.mark.parametrize("anti", [False, True], ids=["nu", "nubar"])
def test_one_density_is_beam(anti):
    lengths = [100.0, 250.5, 600.0, 1234.5]
    for rho, ye in [(2.6, 0.5), (5.0, 0.4957), (13.0, 0.4656)]:
        got = osc_ref.layered(CASES, ENERGIES, [(lengths, [rho * ye] * 4)], anti)[:, 0]
        want = osc_ref.beam(CASES, ENERGIES, sum(lengths), rho, anti, ye=ye)
        assert float((got - want).abs().max()) < 1e-12, (rho, ye)


@pytest.mark.parametrize("anti", [False, True], ids=["nu", "nubar"])
def test_zero_density_is_vacuum(anti):
    lengths = [295.0, 1300.0, 12742.0]
    got = osc_ref.layered(CASES, ENERGIES, [([l], [0.0]) for l in lengths], anti)
    worst = 0.0
    for c, case in enumerate(CASES):
        for z, length in enumerate(lengths):
            for e, energy in enumerate(ENERGIES.tolist()):
                worst = max(worst, float((got[c, z, e] - vacuum(case, energy, length, anti))
                                         .abs().max()))
    assert worst < 1e-12, worst


@pytest.mark.parametrize("anti", [False, True], ids=["nu", "nubar"])
def test_probabilities_are_unitary(anti):
    paths = osc_ref.prem_paths(np.linspace(-1.0, 1.0, 41), 15.0)
    p = osc_ref.layered(CASES, ENERGIES, paths, anti)
    assert float((p.sum(-1) - 1.0).abs().max()) < 1e-12
    assert float((p.sum(-2) - 1.0).abs().max()) < 1e-12


@pytest.mark.parametrize("anti", [False, True], ids=["nu", "nubar"])
def test_symmetric_profile_without_cp_phase_is_t_symmetric(anti):
    inside = [(l[1:], y[1:]) for l, y in osc_ref.prem_paths(np.linspace(-1.0, -0.05, 20), 15.0)]
    p = osc_ref.layered(CASES, ENERGIES, inside, anti)
    assert float((p[1] - p[1].transpose(-1, -2)).abs().max()) < 1e-12  # δCP = 0
    assert float((p[0] - p[0].transpose(-1, -2)).abs().max()) > 1e-3  # δCP = -1.601


def test_this_file_loads_nothing_of_the_program():
    probe = ("import importlib.util, sys\n"
             f"spec = importlib.util.spec_from_file_location('probe', {str(HERE)!r})\n"
             "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
             "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert not set(proc.stdout.split()) & {"jax", "jaxlib", "flax", "mach3_tpu",
                                           "mach3_tpu_torch"}
