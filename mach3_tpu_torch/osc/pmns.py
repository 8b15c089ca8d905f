"""PMNS matrix and beam Hamiltonian (port of ``mach3_tpu/osc/pmns.py``).

Conventions: PDG parameterisation; Δm² in eV², E in GeV, L in km, ρ in g/cm³.
Evolution is ``exp(-i H L)`` with ``H = (2·OSC_PHASE / E) · M²`` and

    M² = U · diag(0, Δm21², Δm31²) · U†  ±  diag(A, 0, 0),   A = MATTER_A · Ye · ρ · E

Antineutrinos: U → U*, A → −A. On the hot path complex matrices are carried
as (re, im) pairs of real tensors, as in the JAX package, batched over any
leading axes; :func:`pmns_matrix`, :func:`mass_matrix` and
:func:`hamiltonian_per_km` are the complex128 forms the checks hold them
against.
"""
from __future__ import annotations

import torch

from ..core.device import as_device_tensor
from ..core.precision import ATYPE

#: Kinematic phase factor Δm²[eV²]·L[km]/(4E[GeV]) = 1/(4·ħc), CODATA 2018.
OSC_PHASE = 1.266932679419849

#: A = 2·√2·G_F·N_e·E in eV² per (Ye · ρ[g/cm³] · E[GeV]).
MATTER_A = 1.5264932435736812e-4


def pmns_matrix(theta12, theta13, theta23, delta_cp) -> torch.Tensor:
    """Complex 3x3 PMNS matrix U (PDG convention), complex128, of scalar
    angles."""
    t12, t13, t23, dcp = (torch.as_tensor(a, dtype=ATYPE) for a in
                          (theta12, theta13, theta23, delta_cp))
    s12, c12 = torch.sin(t12), torch.cos(t12)
    s13, c13 = torch.sin(t13), torch.cos(t13)
    s23, c23 = torch.sin(t23), torch.cos(t23)
    eid = torch.polar(torch.ones_like(dcp), dcp)
    emid = torch.conj(eid)
    rows = [
        [c12 * c13, s12 * c13, s13 * emid],
        [-s12 * c23 - c12 * s23 * s13 * eid, c12 * c23 - s12 * s23 * s13 * eid, s23 * c13],
        [s12 * s23 - c12 * c23 * s13 * eid, -c12 * s23 - s12 * c23 * s13 * eid, c23 * c13],
    ]
    return torch.stack([torch.stack([torch.as_tensor(x).to(torch.complex128) for x in r])
                        for r in rows])


def mass_matrix(u: torch.Tensor, dm21_sq, dm31_sq, energy, rho=0.0, ye: float = 0.5,
                antineutrino: bool = False) -> torch.Tensor:
    """Flavour-basis M²(E) [eV²], [..., 3, 3] complex, batched over the
    energy's shape; ``rho`` broadcasts against it."""
    energy = torch.as_tensor(energy, dtype=ATYPE)
    rho = torch.broadcast_to(torch.as_tensor(rho, dtype=ATYPE), energy.shape)
    if antineutrino:
        u = torch.conj(u)
    m2 = torch.stack([torch.zeros((), dtype=ATYPE), torch.as_tensor(dm21_sq, dtype=ATYPE),
                      torch.as_tensor(dm31_sq, dtype=ATYPE)]).to(u.dtype)
    vac = torch.einsum("ij,j,kj->ik", u, m2, torch.conj(u))
    sign = -1.0 if antineutrino else 1.0
    a = sign * MATTER_A * ye * rho * energy
    out = vac.expand(energy.shape + (3, 3)).clone()
    out[..., 0, 0] += a.to(u.dtype)
    return out


def hamiltonian_per_km(m_sq: torch.Tensor, energy) -> torch.Tensor:
    """H [per km] from M² [eV²]: exp(-i H L[km]) is the evolution operator."""
    scale = (2.0 * OSC_PHASE) / torch.as_tensor(energy, dtype=ATYPE)
    return m_sq * scale[..., None, None].to(m_sq.dtype)


def pmns_matrix_real(theta12, theta13, theta23, delta_cp, dtype=ATYPE):
    """PMNS matrix as an (re, im) pair of real [..., 3, 3] tensors; the angles
    may carry any leading batch shape."""
    t12, t13, t23, dcp = (torch.as_tensor(a, dtype=dtype) for a in
                          (theta12, theta13, theta23, delta_cp))
    s12, c12 = torch.sin(t12), torch.cos(t12)
    s13, c13 = torch.sin(t13), torch.cos(t13)
    s23, c23 = torch.sin(t23), torch.cos(t23)
    cd, sd = torch.cos(dcp), torch.sin(dcp)
    zero = torch.zeros_like(cd)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    ur = mat([
        [c12 * c13, s12 * c13, s13 * cd],
        [-s12 * c23 - c12 * s23 * s13 * cd, c12 * c23 - s12 * s23 * s13 * cd, s23 * c13],
        [s12 * s23 - c12 * c23 * s13 * cd, -c12 * s23 - s12 * c23 * s13 * cd, c23 * c13],
    ])
    ui = mat([
        [zero, zero, -s13 * sd],
        [-c12 * s23 * s13 * sd, -s12 * s23 * s13 * sd, zero],
        [-c12 * c23 * s13 * sd, -s12 * c23 * s13 * sd, zero],
    ])
    return ur, ui


def hamiltonian_real(ur, ui, dm21_sq, dm31_sq, energy, rho=0.0, ye=0.5, antineutrino=False):
    """(hr, hi) per-km Hamiltonian: ur/ui [..., 3, 3], dm²s [...], energy
    [NE] (or broadcastable to [..., NE]) -> two [..., NE, 3, 3] tensors."""
    dtype = ur.dtype
    energy = as_device_tensor(energy, dtype, ur.device)
    if antineutrino:
        ui = -ui
    dm21 = as_device_tensor(dm21_sq, dtype, ur.device)
    dm31 = as_device_tensor(dm31_sq, dtype, ur.device)
    m2 = torch.stack([torch.zeros_like(dm21), dm21, dm31], dim=-1)  # [..., 3]
    # vac = U diag(m2) U†; with D real: re = Ur D Urᵀ + Ui D Uiᵀ,
    # im = Ui D Urᵀ − Ur D Uiᵀ.
    urd = ur * m2[..., None, :]
    uid = ui * m2[..., None, :]
    vac_r = urd @ ur.transpose(-1, -2) + uid @ ui.transpose(-1, -2)
    vac_i = uid @ ur.transpose(-1, -2) - urd @ ui.transpose(-1, -2)

    sign = -1.0 if antineutrino else 1.0
    a = sign * MATTER_A * ye * as_device_tensor(rho, dtype, ur.device) * energy
    e00 = torch.diag((torch.arange(3, device=ur.device) == 0).to(dtype))  # the (e, e) entry
    hr = vac_r[..., None, :, :] + a[..., None, None] * e00
    hi = vac_i[..., None, :, :].expand(hr.shape)
    scale = ((2.0 * OSC_PHASE) / energy)[..., None, None]
    return hr * scale, hi * scale
