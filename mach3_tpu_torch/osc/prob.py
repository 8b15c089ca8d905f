"""Beam (constant-density) 3-flavour oscillation probabilities (port of the
beam part of ``mach3_tpu/osc/prob.py``; the NuFastLinear road of the
reference's NuOscillator bridge).

Flavour order is (e, mu, tau); ``P[..., alpha, beta] = P(nu_alpha -> nu_beta)``.
Layered (atmospheric) matter waits (ROADMAP).
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.precision import ATYPE
from .kernels import c_abs2, herm_evolution
from .pmns import hamiltonian_real, pmns_matrix_real


@dataclasses.dataclass
class OscParams:
    """The six standard parameters (radians, eV²), each of any batch shape."""

    theta12: torch.Tensor
    theta13: torch.Tensor
    theta23: torch.Tensor
    delta_cp: torch.Tensor
    dm21_sq: torch.Tensor
    dm31_sq: torch.Tensor

    @classmethod
    def from_array(cls, arr: torch.Tensor) -> "OscParams":
        """From [..., 6] in MaCh3 order (sin²θ12, sin²θ13, sin²θ23, δCP,
        Δm²21, Δm²31)."""
        return cls(
            theta12=torch.arcsin(torch.sqrt(arr[..., 0])),
            theta13=torch.arcsin(torch.sqrt(arr[..., 1])),
            theta23=torch.arcsin(torch.sqrt(arr[..., 2])),
            delta_cp=arr[..., 3],
            dm21_sq=arr[..., 4],
            dm31_sq=arr[..., 5],
        )


def probabilities_const_density(
    params: OscParams,
    energy: torch.Tensor,
    length,
    rho=0.0,
    ye: float = 0.5,
    antineutrino: bool = False,
    dtype=ATYPE,
    phase_dtype=ATYPE,
) -> torch.Tensor:
    """P[..., NE, alpha, beta] for one baseline and constant density; the
    parameters' batch shape leads. rho=0 gives vacuum.

    The Hamiltonian is built in f64; the 3x3 matrix work runs in ``dtype``
    and the eigenvalues/phases in ``phase_dtype`` (f32 is exact to ~1e-7 rad
    at beam baselines; use f64 for atmospheric-scale phases)."""
    ur, ui = pmns_matrix_real(
        params.theta12, params.theta13, params.theta23, params.delta_cp, dtype=ATYPE
    )
    energy = torch.as_tensor(energy, dtype=ATYPE, device=ur.device)
    hr64, hi64 = hamiltonian_real(
        ur, ui, params.dm21_sq, params.dm31_sq, energy,
        rho=rho, ye=ye, antineutrino=antineutrino,
    )
    amp = herm_evolution(
        hr64.to(dtype),
        hi64.to(dtype),
        torch.as_tensor(length, dtype=dtype, device=ur.device),
        phase_dtype=phase_dtype,
        h_phase=(hr64, hi64),
    )
    # amp[..., beta, alpha] = <beta| U |alpha>  ->  P[..., alpha, beta]
    return c_abs2(amp).transpose(-1, -2)
