"""3-flavour oscillation probabilities (port of ``mach3_tpu/osc/prob.py``):
constant density (beam; the NuFastLinear road of the reference's
NuOscillator bridge) and layered matter (atmospheric/PREM; its CUDAProb3
road).

Flavour order is (e, mu, tau); ``P[..., alpha, beta] = P(nu_alpha -> nu_beta)``.
The parameters' batch shape (e.g. chains) leads every result.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import tracing
from ..core.device import as_device_tensor, take
from ..core.precision import ATYPE
from .kernels import c_abs2, evolution_from_eigensystem, herm_eigensystem, herm_evolution
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


def evolution_operator(h: torch.Tensor, length) -> torch.Tensor:
    """Complex-input wrapper around the real-pair evolution kernel: exp(-i H
    L) of a Hermitian [..., 3, 3] complex ``h`` (used by tests to cross-check
    against ``torch.linalg.eigh``)."""
    out_r, out_i = herm_evolution(h.real, h.imag, length)
    return torch.complex(out_r, out_i)


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
    energy = as_device_tensor(energy, ATYPE, ur.device)
    hr64, hi64 = hamiltonian_real(
        ur, ui, params.dm21_sq, params.dm31_sq, energy,
        rho=rho, ye=ye, antineutrino=antineutrino,
    )
    amp = herm_evolution(
        hr64.to(dtype),
        hi64.to(dtype),
        as_device_tensor(length, dtype, ur.device),
        phase_dtype=phase_dtype,
        h_phase=(hr64, hi64),
    )
    # amp[..., beta, alpha] = <beta| U |alpha>  ->  P[..., alpha, beta]
    return c_abs2(amp).transpose(-1, -2)


def _evolve_layers(eig: dict, ll_b: torch.Tensor, ri_b: torch.Tensor, n_batch: int):
    """Ordered product of per-layer evolution operators.

    eig: eigensystem tensors [*batch, NR, NE, ...] per unique density;
    ll_b/ri_b: [*lead, NL] layer lengths / unique-density indices. Returns the
    (real, imag) amplitude pair [*batch, *lead, NE, 3, 3].

    Every layer's operator comes from one batched evaluation and the chain
    of products runs as complex 3x3 matmuls. This is the plain version: on
    the card it is device-bound (the operators in device memory, cuBLAS's
    complex GEMM with 32x32 tiles for 3x3 matrices; 18 ms of a 512-chain
    large700 step on an H100), and a forward grid there takes the kernel of
    ``osc/layered.py``. The JAX package multiplies the first operator into
    the identity, which changes no bit; the matmuls sum in another order
    than its unrolled products (f32 rounding)."""
    eg = {key: take(v, n_batch, ri_b) for key, v in eig.items()}
    op_r, op_i = evolution_from_eigensystem(eg, ll_b[..., None])  # [*batch, *lead, NL, NE, 3, 3]
    op = torch.complex(op_r, op_i)
    amp = op[..., 0, :, :, :]
    for k in range(1, ll_b.shape[-1]):
        amp = op[..., k, :, :, :] @ amp
    return amp.real, amp.imag


def layer_products(lead: tuple, n_layers: int, z_groups: tuple | None = None) -> int:
    """The 3x3 products of :func:`probabilities_layered` per parameter set
    and energy, over layer arrays of leading shape ``lead`` (zeniths last)
    and ``n_layers`` layers: n - 1 a path of a zenith group of n layers. A
    grid counts them as ``osc_layer_products`` in ``tracing.PROGRAM``,
    whichever path computes it."""
    if z_groups is None:
        return math.prod(lead) * (n_layers - 1)
    return math.prod(lead[:-1]) * sum(len(idxs) * (n - 1) for idxs, n in z_groups)


def z_group_order(z_groups: tuple) -> tuple[np.ndarray, np.ndarray]:
    """The zenith indices of ``z_groups`` in group order, and the
    permutation that puts the groups' results back in the original order."""
    order = np.asarray([i for idxs, _ in z_groups for i in idxs], dtype=np.int64)
    return order, np.argsort(order)


def probabilities_layered(
    params: OscParams,
    energy: torch.Tensor,  # [NE]
    layer_lengths: torch.Tensor,  # [..., NL] km (0-padded)
    layer_rho: torch.Tensor,  # [..., NL] g/cm^3
    ye: float = 0.5,
    antineutrino: bool = False,
    dtype=ATYPE,
    rho_unique: torch.Tensor | None = None,  # [NR] unique densities
    rho_idx: torch.Tensor | None = None,  # [..., NL] into rho_unique
    z_groups: tuple | None = None,  # static ((z indices, n_layers), ...)
    z_order: torch.Tensor | None = None,  # [NZ] long, from z_group_order
    z_inverse: torch.Tensor | None = None,  # [NZ] long, from z_group_order
) -> torch.Tensor:
    """P[*batch, ..., NE, alpha, beta] through a layered medium: ``batch`` is
    the parameters' shape, ``...`` the leading axes of the layer arrays
    (zenith bins, and production heights before them).

    Layers are traversed in the given order; zero-length padding contributes
    the identity. The Hamiltonian and its eigensystem (f64 phases, matrix
    work in ``dtype``) depend only on (density, energy), so they are computed
    once per unique density and gathered per layer; ``rho_unique``/``rho_idx``
    are derived from ``layer_rho`` when not given.

    z_groups: a static partition of the zenith axis (the second-to-last of
    the layer arrays) as ``((zenith indices, n_layers), ...)``; each group's
    chain of products stops at its own segment count (down-going bins have
    one air segment), and the grid is reassembled in the original order.
    ``z_order`` / ``z_inverse`` are :func:`z_group_order`'s index tensors on
    the parameters' device, made from ``z_groups`` when not given: a caller
    that runs in a CUDA graph holds them (a graph cannot capture the host
    copy)."""
    ur, ui = pmns_matrix_real(
        params.theta12, params.theta13, params.theta23, params.delta_cp, dtype=ATYPE
    )
    dev = ur.device
    if rho_unique is None:
        raw = torch.as_tensor(layer_rho, dtype=ATYPE).cpu().numpy()
        uniq, inverse = np.unique(raw.ravel(), return_inverse=True)
        rho_unique = torch.from_numpy(uniq)
        rho_idx = torch.from_numpy(inverse.reshape(raw.shape))
    rho_unique = torch.as_tensor(rho_unique, dtype=ATYPE, device=dev)
    rho_idx = torch.as_tensor(rho_idx, device=dev).long()
    energy = torch.as_tensor(energy, dtype=ATYPE, device=dev)
    layer_lengths = torch.as_tensor(layer_lengths, dtype=ATYPE, device=dev)
    n_rho, ne = rho_unique.shape[0], energy.shape[0]
    n_batch = ur.dim() - 2

    # Eigensystems per unique (density, energy) pair: [*batch, NR, NE, ...]
    hr64, hi64 = hamiltonian_real(
        ur[..., None, :, :], ui[..., None, :, :],
        params.dm21_sq[..., None], params.dm31_sq[..., None],
        energy.expand(n_rho, ne),
        rho=rho_unique[:, None].expand(n_rho, ne),
        ye=ye,
        antineutrino=antineutrino,
    )
    eig = herm_eigensystem(hr64.to(dtype), hi64.to(dtype), phase_dtype=ATYPE,
                           h_phase=(hr64, hi64))

    lead = torch.broadcast_shapes(layer_lengths.shape[:-1], rho_idx.shape[:-1])
    n_layers = layer_lengths.shape[-1]
    tracing.count("osc_layer_products",
                  math.prod(ur.shape[:-2]) * ne * layer_products(lead, n_layers, z_groups))
    ll_b = layer_lengths.expand(lead + (n_layers,))
    ri_b = rho_idx.expand(lead + (n_layers,))
    if z_groups is None:
        amp = _evolve_layers(eig, ll_b, ri_b, n_batch)
    else:
        if z_order is None:
            z_order, z_inverse = (torch.from_numpy(x).to(dev) for x in z_group_order(z_groups))
        parts_r, parts_i = [], []
        at = 0
        for idxs, nl in z_groups:
            ia = z_order[at:at + len(idxs)]
            at += len(idxs)
            a = _evolve_layers(eig, ll_b.index_select(-2, ia)[..., :nl],
                               ri_b.index_select(-2, ia)[..., :nl], n_batch)
            parts_r.append(a[0])
            parts_i.append(a[1])
        amp = (torch.cat(parts_r, dim=-4).index_select(-4, z_inverse),
               torch.cat(parts_i, dim=-4).index_select(-4, z_inverse))
    return c_abs2(amp).transpose(-1, -2)
