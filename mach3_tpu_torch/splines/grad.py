"""The analytic backward of the fused reweight-histogram kernels, and the
differentiable forward around it (port of ``mach3_tpu/splines/pallas_grad.py``).

Gradient samplers (``fitters/hmc.py``) and the minimiser
(``fitters/minimize.py``) differentiate the likelihood through the same
forward kernels as the sampling path (``splines/reweight.py``, with the norm
product left out of the kernel: the norm rides ``base_w`` and ordinary
autograd). The backward is two hand-written passes, ``csrc/reweight_grad.cu``:

* ``grad_pass_a`` — port of K6a ``_kernel_grad_a``: per (chain, event) the
  product of the nonzero responses ``pnz``, the count of zero ones ``nz``,
  the cotangent gather ``G = ḡ_mc[bin] + 2w·ḡ_w2[bin]`` (0 outside the bins)
  and the fields ``ḡ_base = G·Π resp`` and ``sev = G·base``;
* ``grad_pass_b`` — port of K6b ``_kernel_grad_b``: the exclusion products
  ``Π_{q≠p} resp_q`` from (pnz, nz) without a division by zero, reduced
  against the slope of each response:
  ``ḡ_t[c, p] = Σ_e sev·excl_p·(b + 2t·c + 3t²·d)``.

The port's kernels take ``(seg, t)`` [C, P] instead of JAX's [C, P, K4]
selector; ``t = value − knot[seg]``, so ``ḡ_t`` is the gradient with respect
to the parameter value, and it equals JAX's ``ḡ_selector`` contracted with
``∂selector/∂t = [0, 1, 2t, 3t²]`` at the segment.

On a CUDA tensor a wrapper launches its kernel (built at first use by
``kernels/build.py``); on a CPU tensor it runs the plain PyTorch version
beside it (``*_ref``). There is no fallback: a CUDA call that cannot build or
launch the kernel raises. The backward is ``once_differentiable``: second
derivatives (the minimiser's Hesse step) take the plain route.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..core.precision import FTYPE
from .eval import coefficient_rows
from .plan import EVENT_TILE
from .reweight import (
    LAUNCHES,
    _check_plan,
    _check_shapes,
    _check_tensors,
    _library,
    _raise_on,
    fused_reweight_histogram,
    fused_reweight_histogram_shared,
    fused_reweight_histogram_shifted,
)

_C_VOIDP = ctypes.c_void_p
_C_INT = ctypes.c_int
_GRAD_A_ARGTYPES = (
    [_C_VOIDP] * 3 + [_C_INT] + [_C_VOIDP] * 2 + [_C_INT] + [_C_VOIDP] * 8 + [_C_INT] * 6
    + [_C_VOIDP]
)
_GRAD_B_ARGTYPES = [_C_VOIDP] * 3 + [_C_INT] + [_C_VOIDP] * 6 + [_C_INT] * 5 + [_C_VOIDP]


def _response_and_slope(coeffs, seg, t, p, dtype):
    """(resp_p, ∂resp_p/∂t) [C, E] in ``dtype``: y + t(b + t(c + t·d)) and
    b + t(2c + 3t·d) from the segment's coefficient rows."""
    co = coefficient_rows(coeffs, seg, p, dtype)
    tt = t[:, p, None].to(dtype)
    resp = co[:, 0] + tt * (co[:, 1] + tt * (co[:, 2] + tt * co[:, 3]))
    slope = co[:, 1] + tt * (2.0 * co[:, 2] + 3.0 * tt * co[:, 3])
    return resp, slope


def grad_pass_a_ref(seg, t, coeffs, base_w, bins, gmc, gw2, *, n_bins, plan_ptr=None,
                    plan_idx=None):
    """Plain PyTorch version of pass A, on any device and in ``base_w``'s
    dtype: every parameter (a plan only skips exact identities). Same
    arguments and results as :func:`grad_pass_a`."""
    dtype = base_w.dtype
    pnz = torch.ones_like(base_w)
    nz = torch.zeros(base_w.shape, dtype=torch.int32, device=base_w.device)
    for p in range(coeffs.shape[0]):
        resp, _ = _response_and_slope(coeffs, seg, t, p, dtype)
        zero = resp == 0.0
        pnz = pnz * torch.where(zero, 1.0, resp)
        nz = nz + zero.to(torch.int32)
    r_total = torch.where(nz == 0, pnz, 0.0)
    b = bins.long().expand(base_w.shape)
    ok = (b >= 0) & (b < n_bins)
    idx = torch.where(ok, b, 0)
    w = base_w * r_total
    g_mc, g_w2 = (g.to(dtype).gather(1, idx) for g in (gmc, gw2))
    g = torch.where(ok, g_mc + 2.0 * w * g_w2, 0.0)
    return g * r_total, g * base_w, pnz, nz


def _pass_b_sums(seg, t, coeffs, sev, pnz, nz, absolute: bool):
    """Σ_e of sev·excl_p·slope_p (or of its absolute value) [C, P]."""
    none_zero, one_zero = nz == 0, nz == 1
    out = []
    for p in range(coeffs.shape[0]):
        resp, slope = _response_and_slope(coeffs, seg, t, p, sev.dtype)
        zero = resp == 0.0
        excl = torch.where(none_zero, pnz / torch.where(zero, 1.0, resp),
                           torch.where(one_zero & zero, pnz, 0.0))
        term = sev * excl * slope
        out.append((term.abs() if absolute else term).sum(-1))
    return torch.stack(out, dim=1)


def grad_pass_b_ref(seg, t, coeffs, sev, pnz, nz, *, plan_ptr=None, plan_idx=None):
    """Plain PyTorch version of pass B, on any device and in ``sev``'s dtype.
    Same arguments and results as :func:`grad_pass_b`."""
    return _pass_b_sums(seg, t, coeffs, sev, pnz, nz, absolute=False)


def pass_b_term_scale(seg, t, coeffs, sev, pnz, nz) -> torch.Tensor:
    """Σ_e |sev·excl_p·slope_p| [C, P] in f64: the size of the terms pass B
    adds up. They cancel, so this, not |ḡ_t|, is the unit of ḡ_t's
    rounding and of its tolerance."""
    return _pass_b_sums(seg, t, coeffs, sev.double(), pnz.double(), nz, absolute=True)


def _check_a(seg, t, coeffs, base_w, bins, gmc, gw2, n_bins, plan_ptr, plan_idx):
    named = dict(seg=seg, t=t, coeffs=coeffs, base_w=base_w, bins=bins, gmc=gmc, gw2=gw2)
    has_plan = _check_plan(named, plan_ptr, plan_idx, base_w.shape[-1])
    _check_tensors(named, None, None)
    per_chain = bins.dim() == 2
    shapes = dict(seg=("C", "P"), t=("C", "P"), base_w=("C", "E"),
                  bins=("C", "E") if per_chain else ("E",), gmc=("C", n_bins),
                  gw2=("C", n_bins))
    _check_shapes(named, shapes, coeffs, base_w, None, None)
    if n_bins < 1:
        raise ValueError(f"n_bins={n_bins} < 1")
    return per_chain, has_plan


def grad_pass_a(
    seg: torch.Tensor,  # [C, P] i32 — spline segment per (chain, param)
    t: torch.Tensor,  # [C, P] f32 — local coordinate in that segment
    coeffs: torch.Tensor,  # [P, K4, E] f32 or bf16
    base_w: torch.Tensor,  # [C, E] f32 — the forward's base weight
    bins: torch.Tensor,  # [E] (shared) or [C, E] (per-chain) i32; outside [0, n_bins): no gather
    gmc: torch.Tensor,  # [C, n_bins] f32 — cotangent of Σw
    gw2: torch.Tensor,  # [C, n_bins] f32 — cotangent of Σw²
    *,
    n_bins: int,
    plan_ptr: torch.Tensor | None = None,  # [T + 1] i32 — CSR offsets (tiles of EVENT_TILE)
    plan_idx: torch.Tensor | None = None,  # [nnz] i32 — each tile's active params
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pass A: (ḡ_base, sev, pnz [C, E] f32, nz [C, E] i32). Launches the
    CUDA kernel for CUDA tensors, runs the plain version for CPU tensors,
    raises otherwise. A plan must list every parameter that is not the
    identity on some event of a tile."""
    per_chain, has_plan = _check_a(seg, t, coeffs, base_w, bins, gmc, gw2, n_bins,
                                   plan_ptr, plan_idx)
    dev = seg.device
    if dev.type == "cpu":
        return grad_pass_a_ref(seg, t, coeffs, base_w, bins, gmc, gw2, n_bins=n_bins,
                               plan_ptr=plan_ptr, plan_idx=plan_idx)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lib = _library("reweight_grad", _GRAD_A_ARGTYPES, entry="reweight_grad_a")
    c, p = seg.shape
    k4, e = coeffs.shape[1], coeffs.shape[2]
    gbase, sev, pnz = (torch.empty((c, e), dtype=FTYPE, device=dev) for _ in range(3))
    nz = torch.empty((c, e), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_reweight_grad_a(
            seg.data_ptr(), t.data_ptr(), coeffs.data_ptr(), int(coeffs.dtype == torch.bfloat16),
            base_w.data_ptr(), bins.data_ptr(), int(per_chain), gmc.data_ptr(), gw2.data_ptr(),
            plan_ptr.data_ptr() if has_plan else None, plan_idx.data_ptr() if has_plan else None,
            gbase.data_ptr(), sev.data_ptr(), pnz.data_ptr(), nz.data_ptr(),
            c, p, k4, e, n_bins, EVENT_TILE, stream,
        )
    _raise_on(lib, rc, "reweight_grad_a")
    LAUNCHES["grad_a"] += 1
    return gbase, sev, pnz, nz


def grad_pass_b(
    seg: torch.Tensor,  # [C, P] i32
    t: torch.Tensor,  # [C, P] f32
    coeffs: torch.Tensor,  # [P, K4, E] f32 or bf16
    sev: torch.Tensor,  # [C, E] f32 — pass A's G·base
    pnz: torch.Tensor,  # [C, E] f32 — pass A's product of nonzero responses
    nz: torch.Tensor,  # [C, E] i32 — pass A's count of zero responses
    *,
    plan_ptr: torch.Tensor | None = None,
    plan_idx: torch.Tensor | None = None,
) -> torch.Tensor:
    """Pass B: ḡ_t [C, P] f32. Launches the CUDA kernel for CUDA tensors
    (per-tile partial sums, then a sum over tiles), runs the plain version
    for CPU tensors, raises otherwise."""
    named = dict(seg=seg, t=t, coeffs=coeffs, sev=sev, pnz=pnz, nz=nz)
    has_plan = _check_plan(named, plan_ptr, plan_idx, sev.shape[-1])
    _check_tensors(named, None, None)
    _check_shapes(named, dict(seg=("C", "P"), t=("C", "P"), sev=("C", "E"), pnz=("C", "E"),
                              nz=("C", "E")), coeffs, sev, None, None)
    dev = seg.device
    if dev.type == "cpu":
        return grad_pass_b_ref(seg, t, coeffs, sev, pnz, nz, plan_ptr=plan_ptr,
                               plan_idx=plan_idx)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lib = _library("reweight_grad", _GRAD_B_ARGTYPES, entry="reweight_grad_b")
    c, p = seg.shape
    k4, e = coeffs.shape[1], coeffs.shape[2]
    partial = torch.empty((-(-e // EVENT_TILE), c, p), dtype=FTYPE, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_reweight_grad_b(
            seg.data_ptr(), t.data_ptr(), coeffs.data_ptr(), int(coeffs.dtype == torch.bfloat16),
            sev.data_ptr(), pnz.data_ptr(), nz.data_ptr(),
            plan_ptr.data_ptr() if has_plan else None, plan_idx.data_ptr() if has_plan else None,
            partial.data_ptr(), c, p, k4, e, EVENT_TILE, stream,
        )
    _raise_on(lib, rc, "reweight_grad_b")
    LAUNCHES["grad_b"] += 1
    return partial.sum(0)


def reweight_backward(seg, t, coeffs, base_w, bins, gmc, gw2, *, n_bins, plan_ptr=None,
                      plan_idx=None, need_t: bool = True):
    """Both passes: (ḡ_t [C, P] or None, ḡ_base [C, E]) for the output
    cotangents (ḡ_mc, ḡ_w2) [C, n_bins]."""
    gmc, gw2 = (g.to(FTYPE).contiguous() for g in (gmc, gw2))
    gbase, sev, pnz, nz = grad_pass_a(seg, t, coeffs, base_w, bins, gmc, gw2, n_bins=n_bins,
                                      plan_ptr=plan_ptr, plan_idx=plan_idx)
    g_t = None
    if need_t:
        g_t = grad_pass_b(seg, t, coeffs, sev, pnz, nz, plan_ptr=plan_ptr, plan_idx=plan_idx)
    return g_t, gbase


class _FusedReweightDiff(torch.autograd.Function):
    """Static (shared) bins: forward on the shared kernel under the sample's
    plan, backward K6a + K6b with the same plan. Port of
    ``fused_reweight_diff`` (shared bins)."""

    @staticmethod
    def forward(ctx, t, base_w, seg, coeffs, bins, n_bins, tile_start, tile_width, plan_ptr,
                plan_idx, nbl):
        mc, w2 = fused_reweight_histogram_shared(
            seg, t, coeffs, base_w, bins, n_bins=n_bins, tile_start=tile_start,
            tile_width=tile_width, plan_ptr=plan_ptr, plan_idx=plan_idx, nbl=nbl)
        ctx.save_for_backward(t, base_w, seg, coeffs, bins, plan_ptr, plan_idx)
        ctx.n_bins = n_bins
        return mc, w2

    @staticmethod
    @once_differentiable
    def backward(ctx, gmc, gw2):
        t, base_w, seg, coeffs, bins, plan_ptr, plan_idx = ctx.saved_tensors
        g_t, g_base = reweight_backward(seg, t, coeffs, base_w, bins, gmc, gw2,
                                        n_bins=ctx.n_bins, plan_ptr=plan_ptr, plan_idx=plan_idx,
                                        need_t=ctx.needs_input_grad[0])
        return (g_t, g_base) + (None,) * 9


class _FusedReweightDiffShifted(torch.autograd.Function):
    """Per-chain bins of a shifted axis: forward on the shifted kernel (which
    bins in-kernel, under the sample's activity plan when it has one),
    backward K6a + K6b with the per-chain bins of the plain binning, reading
    every parameter. Port of ``fused_reweight_diff_shifted``. Bins are
    piecewise constant in θ: the shift value gets its a.e.-zero gradient."""

    @staticmethod
    def forward(ctx, t, base_w, seg, coeffs, shift_vals, x_nom, static_base, edges, bins,
                n_bins, shift_kind, stride_j, n_axis_j, plan_ptr, plan_idx):
        mc, w2 = fused_reweight_histogram_shifted(
            seg, t, coeffs, base_w, shift_vals, x_nom, static_base, edges, n_bins=n_bins,
            shift_kind=shift_kind, stride_j=stride_j, n_axis_j=n_axis_j, plan_ptr=plan_ptr,
            plan_idx=plan_idx)
        ctx.save_for_backward(t, base_w, seg, coeffs, bins)
        ctx.n_bins = n_bins
        return mc, w2

    @staticmethod
    @once_differentiable
    def backward(ctx, gmc, gw2):
        t, base_w, seg, coeffs, bins = ctx.saved_tensors
        g_t, g_base = reweight_backward(seg, t, coeffs, base_w, bins, gmc, gw2,
                                        n_bins=ctx.n_bins, need_t=ctx.needs_input_grad[0])
        return (g_t, g_base) + (None,) * 13


class _FusedReweightDiffPerchain(torch.autograd.Function):
    """Per-chain bins given as input (the generic route): forward on the
    per-chain kernel K5, backward K6a + K6b at the same bins. Port of
    ``fused_reweight_diff`` with per-chain bins (``pallas_grad.py:319-345``).
    Bins are integer inputs: no gradient flows to them."""

    @staticmethod
    def forward(ctx, t, base_w, seg, coeffs, bins, n_bins):
        mc, w2 = fused_reweight_histogram(seg, t, coeffs, base_w, bins, n_bins=n_bins)
        ctx.save_for_backward(t, base_w, seg, coeffs, bins)
        ctx.n_bins = n_bins
        return mc, w2

    @staticmethod
    @once_differentiable
    def backward(ctx, gmc, gw2):
        t, base_w, seg, coeffs, bins = ctx.saved_tensors
        g_t, g_base = reweight_backward(seg, t, coeffs, base_w, bins, gmc, gw2,
                                        n_bins=ctx.n_bins, need_t=ctx.needs_input_grad[0])
        return (g_t, g_base) + (None,) * 4


def fused_reweight_diff(
    t: torch.Tensor,  # [C, P] f32 — differentiable
    base_w: torch.Tensor,  # [C, E] f32 — differentiable (MC x osc x norm)
    seg: torch.Tensor,  # [C, P] i32
    coeffs: torch.Tensor,  # [P, K4, E] f32 or bf16, events in plan order
    bins: torch.Tensor,  # [E] i32 static bins
    *,
    n_bins: int,
    tile_start: torch.Tensor,
    tile_width: torch.Tensor,
    plan_ptr: torch.Tensor,
    plan_idx: torch.Tensor,
    nbl: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (mc, w2) [C, n_bins] of a shared-route sample."""
    return _FusedReweightDiff.apply(t.contiguous(), base_w.contiguous(), seg, coeffs, bins,
                                    n_bins, tile_start, tile_width, plan_ptr, plan_idx, nbl)


def fused_reweight_diff_shifted(
    t: torch.Tensor,  # [C, P] f32 — differentiable
    base_w: torch.Tensor,  # [C, E] f32 — differentiable (MC x osc x norm)
    seg: torch.Tensor,  # [C, P] i32
    coeffs: torch.Tensor,  # [P, K4, E] f32 or bf16
    shift_vals: torch.Tensor,  # [C] f32
    x_nom: torch.Tensor,  # [E] f32
    static_base: torch.Tensor,  # [E] i32
    edges: torch.Tensor,  # [n_axis_j + 1] f32
    bins: torch.Tensor,  # [C, E] i32 — the plain binning's per-chain bins
    *,
    n_bins: int,
    shift_kind: str,
    stride_j: int,
    n_axis_j: int,
    plan_ptr: torch.Tensor | None = None,  # the forward's activity plan
    plan_idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (mc, w2) [C, n_bins] of a shifted-route sample."""
    return _FusedReweightDiffShifted.apply(
        t.contiguous(), base_w.contiguous(), seg, coeffs, shift_vals.contiguous(), x_nom,
        static_base, edges, bins.contiguous(), n_bins, shift_kind, stride_j, n_axis_j,
        plan_ptr, plan_idx)


def fused_reweight_diff_perchain(
    t: torch.Tensor,  # [C, P] f32 — differentiable
    base_w: torch.Tensor,  # [C, E] f32 — differentiable (MC x osc x norm x TF1 x weight fns)
    seg: torch.Tensor,  # [C, P] i32
    coeffs: torch.Tensor,  # [P, K4, E] f32 or bf16
    bins: torch.Tensor,  # [C, E] i32 — per-chain bins (outside [0, n_bins) dropped)
    *,
    n_bins: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (mc, w2) [C, n_bins] of a generic-route sample."""
    return _FusedReweightDiffPerchain.apply(t.contiguous(), base_w.contiguous(), seg, coeffs,
                                            bins.contiguous(), n_bins)
