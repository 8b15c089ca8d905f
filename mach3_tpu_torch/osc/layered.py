"""An atmospheric sample's layered-matter grids, neutrinos and antineutrinos
together, as one hand-written kernel on the card (``csrc/osc_layered.cu``,
built at first use by ``kernels/build.py``), with the plain torch path
beside it (:func:`~mach3_tpu_torch.osc.prob.probabilities_layered`).

Which path a call takes is decided from its inputs (:func:`kernel_takes`).
The kernel takes a call on a CUDA tensor whose matrix work is float32 and
that needs no gradient: ``torch.is_grad_enabled()`` is false, or the
oscillation parameters do not require grad. Every MR2T2, tempering,
predictive and scan step of an atmospheric fit is such a call. The plain
path takes every CPU call, a call that needs a gradient (the kernel has no
backward) and a float64 call; on the card each of the latter two counts
``LAUNCHES["osc_layered_fallback"]`` where it runs (:func:`count_fallback`).
Each launch counts ``LAUNCHES["osc_layered"]``.

The kernel reads the configuration's own layer arrays, lengths and
unique-density indices per (production height, zenith), zero-padded, in
the caller's zenith order, so it needs no zenith groups.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.precision import FTYPE
from ..splines.reweight import LAUNCHES, _library, _raise_on
from .prob import OscParams

_C_VOIDP = ctypes.c_void_p
_C_INT = ctypes.c_int
_ARGTYPES = [_C_VOIDP] * 6 + [_C_INT] * 5 + [_C_VOIDP]


def kernel_takes(x: torch.Tensor, dtype: torch.dtype) -> bool:
    """Whether a layered grid of oscillation parameters ``x`` (or a tensor
    of their device and autograd state) and matrix dtype ``dtype`` goes to
    the kernel: a CUDA tensor, float32 and no gradient needed."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"no layered oscillation kernel for device {x.device}")
    return dtype == FTYPE and not (torch.is_grad_enabled() and x.requires_grad)


def count_fallback(x: torch.Tensor) -> None:
    """Count a layered grid of oscillation parameters ``x`` that the plain
    path computes on the card in ``LAUNCHES["osc_layered_fallback"]``; the
    CPU counts nothing."""
    if x.device.type == "cuda":
        LAUNCHES["osc_layered_fallback"] += 1


def layered_grids(params: OscParams, energy: torch.Tensor, layer_lengths: torch.Tensor,
                  rho_idx: torch.Tensor, rho_unique: torch.Tensor) -> torch.Tensor:
    """[2, C, (H,) NZ, NE, 3, 3] float32 probabilities of the neutrinos
    (first) and antineutrinos along each path from one launch of the kernel;
    ``params`` of batch shape [C] (float64), ``energy`` [NE] float64,
    ``layer_lengths`` [(H,) NZ, NL] float64 (km, zero-padded),
    ``rho_idx`` of its shape (int64, each in [0, NR)) and ``rho_unique`` [NR]
    float64, all on one CUDA device. Raises on what the kernel does not
    take."""
    pars = torch.stack([params.theta12, params.theta13, params.theta23, params.delta_cp,
                        params.dm21_sq, params.dm31_sq], -1)
    dev = pars.device
    if pars.dim() != 2 or layer_lengths.dim() not in (2, 3) or layer_lengths.shape[-1] == 0:
        raise ValueError(f"parameters [C, 6] and paths [(H,) NZ, NL], not "
                         f"{tuple(pars.shape)} and {tuple(layer_lengths.shape)}")
    c = pars.shape[0]
    nl = layer_lengths.shape[-1]
    ne, nr = energy.numel(), rho_unique.numel()
    want = {"parameters": (pars, torch.float64, (c, 6)),
            "energies": (energy, torch.float64, (ne,)),
            "densities": (rho_unique, torch.float64, (nr,)),
            "lengths": (layer_lengths, torch.float64, tuple(layer_lengths.shape)),
            "density indices": (rho_idx, torch.int64, tuple(layer_lengths.shape))}
    for what, (t, dtype, shape) in want.items():
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"layered kernel: {what} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, not {shape} {dtype} on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"layered kernel: {what} not contiguous")
    if dev.type != "cuda":
        raise ValueError(f"no layered oscillation kernel for device {dev}")
    out = torch.empty((2, c) + tuple(layer_lengths.shape[:-1]) + (ne, 3, 3), dtype=FTYPE,
                      device=dev)
    if out.numel() == 0:
        return out
    pars = pars.contiguous()
    lib = _library("osc_layered", _ARGTYPES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_osc_layered(pars.data_ptr(), energy.data_ptr(), rho_unique.data_ptr(),
                                layer_lengths.data_ptr(), rho_idx.data_ptr(), out.data_ptr(),
                                c, ne, nr, layer_lengths.numel() // nl, nl, stream)
    _raise_on(lib, rc, "osc_layered")
    LAUNCHES["osc_layered"] += 1
    return out
