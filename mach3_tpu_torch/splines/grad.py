"""The analytic backward of the fused reweight-histogram kernels, and the
differentiable forward around it (port of ``mach3_tpu/splines/pallas_grad.py``).

Gradient samplers (``fitters/hmc.py``) and the minimiser
(``fitters/minimize.py``) differentiate the likelihood through the same
forward kernels as the sampling path (``splines/reweight.py``, with the norm
product left out of the kernel: the norm rides ``base_w`` and ordinary
autograd). The backward, :func:`reweight_backward`, is one hand-written
kernel, ``csrc/reweight_backward.cu``, that computes both of the TPU's passes
in one launch:

* K6a ``_kernel_grad_a``'s function: per (chain, event) the product of the
  nonzero responses ``pnz``, the count of zero ones ``nz``, the cotangent
  gather ``G = ḡ_mc[bin] + 2w·ḡ_w2[bin]`` (0 outside the bins) and
  ``ḡ_base = G·Π resp``;
* K6b ``_kernel_grad_b``'s function: the exclusion products
  ``Π_{q≠p} resp_q`` from (pnz, nz) without a division by zero, reduced
  against the slope of each response:
  ``ḡ_t[c, p] = Σ_e G·base·excl_p·(b + 2t·c + 3t²·d)``.

Its plain version, :func:`reweight_backward_ref`, runs the two passes
:func:`grad_pass_a_ref` (which also returns ``sev = G·base``, pnz and nz) and
:func:`grad_pass_b_ref`. The bins are the shared route's static bins [E],
per-chain bins given [C, E] (a generic-route sample whose shifts are torch
code), or a bin map from which the kernel bins each (chain, event) as the
forward kernel does: the generic route's ``reweight.PerchainBins`` or the
shifted route's :class:`ShiftedBins` (the forward's shift arguments, a map
of one axis). The plain route bins them by ``reweight.perchain_bins_ref`` /
``shifted_bins_ref``. Every route hands the backward its forward's activity
plan.

The port's kernels take ``(seg, t)`` [C, P] instead of JAX's [C, P, K4]
selector; ``t = value − knot[seg]``, so ``ḡ_t`` is the gradient with respect
to the parameter value, and it equals JAX's ``ḡ_selector`` contracted with
``∂selector/∂t = [0, 1, 2t, 3t²]`` at the segment.

On a CUDA tensor :func:`reweight_backward` launches the kernel (built at
first use by ``kernels/build.py``); on a CPU tensor it runs the plain
versions. There is no fallback: a CUDA call that cannot build or launch the
kernel raises. The backward is ``once_differentiable``: second derivatives
(the minimiser's Hesse step) take the plain route.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
from torch.autograd.function import once_differentiable

from ..core.precision import FTYPE
from .eval import coefficient_rows
from .plan import EVENT_TILE
from .reweight import (
    BIN_MAP_BYTES,
    CHAIN_TILE,
    LAUNCHES,
    MAX_KNOTS,
    MAX_SMEM,
    PerchainBins,
    _check_bin_source,
    _check_plan,
    _check_shapes,
    _check_tensors,
    _library,
    _raise_on,
    fused_reweight_histogram,
    fused_reweight_histogram_shared,
    fused_reweight_histogram_shifted,
    shifted_bins_ref,
    tile_core_smem,
)

_C_VOIDP = ctypes.c_void_p
_C_INT = ctypes.c_int
_BACKWARD_ARGTYPES = (
    [_C_VOIDP] * 3 + [_C_INT] + [_C_VOIDP] + [_C_INT] + [_C_VOIDP] * 6
    + [ctypes.POINTER(_C_INT)] + [_C_VOIDP] * 6 + [_C_INT] * 7 + [_C_VOIDP]
)
#: Where the kernel takes an event's bin from (``csrc/reweight_backward.cu``).
BINS_SHARED, BINS_PER_CHAIN, BINS_MAP = 0, 1, 2
#: Warps of a block: each keeps 16 chains' sums per listed parameter in
#: shared memory until the block adds them up.
_WARPS = EVENT_TILE // 32


@dataclasses.dataclass(frozen=True)
class ShiftedBins:
    """The shifted route's per-chain bins, as the forward's shift arguments
    (``reweight.fused_reweight_histogram_shifted``): the backward kernel bins
    each (chain, event) itself, with the forward kernel's code."""

    shift_vals: torch.Tensor  # [C] f32 — per-chain shift-parameter value
    x_nom: torch.Tensor  # [E] f32 — nominal values of the shifted variable
    static_base: torch.Tensor  # [E] i32 — static-axis bin contribution (-1 invalid)
    edges: torch.Tensor  # [n_axis_j + 1] f32 — edges of the shifted axis
    shift_kind: str
    stride_j: int
    n_axis_j: int

    def bins(self, n_bins: int) -> torch.Tensor:
        """The [C, E] int32 bins of the plain route (``n_bins``: dropped)."""
        return shifted_bins_ref(self.shift_vals, self.x_nom, self.static_base, self.edges,
                                n_bins=n_bins, shift_kind=self.shift_kind,
                                stride_j=self.stride_j, n_axis_j=self.n_axis_j)

    def bin_map(self) -> PerchainBins:
        """The same bins as a bin map of one axis and one shift, as the
        kernels take it."""
        return PerchainBins(self.shift_vals[:, None], self.x_nom[None], self.static_base,
                            self.edges[None], None, ((0, self.n_axis_j + 1, self.stride_j),),
                            ((0, self.shift_kind),))


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
    """Plain PyTorch version of K6a's pass, on any device and in ``base_w``'s
    dtype: every parameter (a plan only skips exact identities). Arguments
    as :func:`reweight_backward` (bins [E] or [C, E]); returns (ḡ_base, sev =
    G·base, pnz [C, E], nz [C, E] int32)."""
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
    """Plain PyTorch version of K6b's pass, on any device and in ``sev``'s
    dtype: ḡ_t [C, P] from pass A's sev, pnz and nz."""
    return _pass_b_sums(seg, t, coeffs, sev, pnz, nz, absolute=False)


def pass_b_term_scale(seg, t, coeffs, sev, pnz, nz) -> torch.Tensor:
    """Σ_e |sev·excl_p·slope_p| [C, P] in f64: the size of the terms pass B
    adds up. They cancel, so this, not |ḡ_t|, is the unit of ḡ_t's
    rounding and of its tolerance."""
    return _pass_b_sums(seg, t, coeffs, sev.double(), pnz.double(), nz, absolute=True)


def reweight_backward_ref(seg, t, coeffs, base_w, bins, gmc, gw2, *, n_bins, plan_ptr=None,
                          plan_idx=None, need_t=True):
    """Plain PyTorch version of the backward kernel, on any device: the
    shifted route's bins by ``shifted_bins_ref``, then pass A and pass B over
    every parameter (a plan only skips exact identities). Same arguments and
    results as :func:`reweight_backward`."""
    if isinstance(bins, (ShiftedBins, PerchainBins)):
        bins = bins.bins(n_bins)
    gbase, sev, pnz, nz = grad_pass_a_ref(seg, t, coeffs, base_w, bins, gmc.to(FTYPE),
                                          gw2.to(FTYPE), n_bins=n_bins)
    return (grad_pass_b_ref(seg, t, coeffs, sev, pnz, nz) if need_t else None), gbase


def backward_smem(coeffs: torch.Tensor, bins=None, need_t: bool = True) -> int:
    """Bytes of shared memory a block of the backward kernel takes for this
    table: the tile core, with ``need_t`` the warps' sums (8 x 16 floats per
    parameter) and a slot per parameter, and a bin map's edges, shift
    factors, event rows and cells and its description."""
    p = coeffs.shape[0]
    sums = (_WARPS * CHAIN_TILE + 1) * p * 4 if need_t else 0
    by_map = 0
    if isinstance(bins, PerchainBins):
        by_map = 4 * (bins.smem_floats() - EVENT_TILE)  # no static parts staged
    return tile_core_smem(coeffs, 0) + sums + by_map + BIN_MAP_BYTES


def _check_backward(seg, t, coeffs, base_w, bins, gmc, gw2, n_bins, plan_ptr, plan_idx,
                    need_t) -> tuple[int, bool]:
    """Every argument of :func:`reweight_backward`; returns (bins kind, has
    a plan)."""
    named = dict(seg=seg, t=t, coeffs=coeffs, base_w=base_w, gmc=gmc, gw2=gw2)
    shapes = dict(seg=("C", "P"), t=("C", "P"), base_w=("C", "E"), gmc=("C", n_bins),
                  gw2=("C", n_bins))
    if isinstance(bins, PerchainBins):
        kind = BINS_MAP
        _check_bin_source(named, shapes, bins)
    else:
        kind = BINS_PER_CHAIN if isinstance(bins, torch.Tensor) and bins.dim() == 2 else BINS_SHARED
        named["bins"] = bins
        shapes["bins"] = ("C", "E") if kind == BINS_PER_CHAIN else ("E",)
    has_plan = _check_plan(named, plan_ptr, plan_idx, base_w.shape[-1])
    _check_tensors(named, None, None)
    _check_shapes(named, shapes, coeffs, base_w, None, None)
    if n_bins < 1:
        raise ValueError(f"n_bins={n_bins} < 1")
    if coeffs.shape[1] // 4 > MAX_KNOTS:
        raise ValueError(f"{coeffs.shape[1] // 4} knots > {MAX_KNOTS}")
    smem = backward_smem(coeffs, bins, need_t)
    if smem > MAX_SMEM:
        raise ValueError(f"a block needs {smem} bytes of shared memory > {MAX_SMEM}")
    return kind, has_plan


def reweight_backward(
    seg: torch.Tensor,  # [C, P] i32 — spline segment per (chain, param)
    t: torch.Tensor,  # [C, P] f32 — local coordinate in that segment
    coeffs: torch.Tensor,  # [P, K4, E] f32 or bf16, any row pitch
    base_w: torch.Tensor,  # [C, E] f32 — the forward's base weight
    bins,  # [E] (shared) or [C, E] (per-chain) i32, outside [0, n_bins) no gather; or a bin map
    gmc: torch.Tensor,  # [C, n_bins] — cotangent of Σw
    gw2: torch.Tensor,  # [C, n_bins] — cotangent of Σw²
    *,
    n_bins: int,
    plan_ptr: torch.Tensor | None = None,  # [T + 1] i32 — CSR offsets (tiles of EVENT_TILE)
    plan_idx: torch.Tensor | None = None,  # [nnz] i32 — each tile's active params
    need_t: bool = True,
) -> tuple[torch.Tensor | None, torch.Tensor]:
    """(ḡ_t [C, P] f32 or None without ``need_t``, ḡ_base [C, E] f32) for the
    output cotangents (ḡ_mc, ḡ_w2). Launches the CUDA kernel for CUDA
    tensors, runs the plain passes for CPU tensors, raises otherwise. A plan
    must list every parameter that is not the identity on some event of a
    tile. A bin map is a ``reweight.PerchainBins`` or a :class:`ShiftedBins`."""
    gmc, gw2 = (g.to(FTYPE).contiguous() for g in (gmc, gw2))
    if isinstance(bins, ShiftedBins):
        bins = bins.bin_map()
    kind, has_plan = _check_backward(seg, t, coeffs, base_w, bins, gmc, gw2, n_bins, plan_ptr,
                                     plan_idx, need_t)
    dev = seg.device
    if dev.type == "cpu":
        return reweight_backward_ref(seg, t, coeffs, base_w, bins, gmc, gw2, n_bins=n_bins,
                                     need_t=need_t)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    lib = _library("reweight_backward", _BACKWARD_ARGTYPES)
    c, p = seg.shape
    k4, e = coeffs.shape[1], coeffs.shape[2]
    gbase = torch.empty((c, e), dtype=FTYPE, device=dev)
    partial = (torch.empty((-(-e // EVENT_TILE), c, p), dtype=FTYPE, device=dev)
               if need_t else None)
    if kind == BINS_MAP:
        cells = bins.cell_to_bin
        source = (None, bins.kin.data_ptr(), bins.shift_vals.data_ptr(),
                  bins.static_base.data_ptr(), bins.edges.data_ptr(),
                  None if cells is None else cells.data_ptr(), bins.descriptor())
    else:
        source = (bins.data_ptr(),) + (None,) * 6
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_reweight_backward(
            seg.data_ptr(), t.data_ptr(), coeffs.data_ptr(), int(coeffs.dtype == torch.bfloat16),
            base_w.data_ptr(), kind, *source, gmc.data_ptr(), gw2.data_ptr(),
            plan_ptr.data_ptr() if has_plan else None, plan_idx.data_ptr() if has_plan else None,
            gbase.data_ptr(), None if partial is None else partial.data_ptr(),
            c, p, k4, e, n_bins, EVENT_TILE, CHAIN_TILE, stream,
        )
    _raise_on(lib, rc, "reweight_backward")
    LAUNCHES["reweight_backward"] += 1
    return (partial.sum(0) if need_t else None), gbase


class _FusedReweightDiff(torch.autograd.Function):
    """Static (shared) bins: forward on the shared kernel under the sample's
    plan, backward (K6a + K6b) with the same plan. Port of
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
    """Per-chain bins of a shifted axis: forward on the shifted kernel and
    backward (K6a + K6b), both binning in-kernel from the shift arguments and
    both under the sample's activity plan when it has one. Port of
    ``fused_reweight_diff_shifted``. Bins are piecewise constant in θ: the
    shift value gets its a.e.-zero gradient."""

    @staticmethod
    def forward(ctx, t, base_w, seg, coeffs, shift_vals, x_nom, static_base, edges, n_bins,
                shift_kind, stride_j, n_axis_j, plan_ptr, plan_idx):
        mc, w2 = fused_reweight_histogram_shifted(
            seg, t, coeffs, base_w, shift_vals, x_nom, static_base, edges, n_bins=n_bins,
            shift_kind=shift_kind, stride_j=stride_j, n_axis_j=n_axis_j, plan_ptr=plan_ptr,
            plan_idx=plan_idx)
        ctx.save_for_backward(t, base_w, seg, coeffs, shift_vals, x_nom, static_base, edges,
                              plan_ptr, plan_idx)
        ctx.n_bins = n_bins
        ctx.shift = (shift_kind, stride_j, n_axis_j)
        return mc, w2

    @staticmethod
    @once_differentiable
    def backward(ctx, gmc, gw2):
        t, base_w, seg, coeffs, shift_vals, x_nom, static_base, edges, plan_ptr, plan_idx = (
            ctx.saved_tensors)
        bins = ShiftedBins(shift_vals, x_nom, static_base, edges, *ctx.shift)
        g_t, g_base = reweight_backward(seg, t, coeffs, base_w, bins, gmc, gw2,
                                        n_bins=ctx.n_bins, plan_ptr=plan_ptr, plan_idx=plan_idx,
                                        need_t=ctx.needs_input_grad[0])
        return (g_t, g_base) + (None,) * 12


class _FusedReweightDiffPerchain(torch.autograd.Function):
    """Per-chain bins (the generic route): forward on the per-chain kernel
    K5, backward (K6a + K6b) at the same bins, both binning in-kernel from a
    bin map (or reading the bins given) and both under the sample's activity
    plan when it has one. Port of ``fused_reweight_diff`` with per-chain bins
    (``pallas_grad.py:319-345``). Bins are piecewise constant in θ: no
    gradient flows to them."""

    @staticmethod
    def forward(ctx, t, base_w, seg, coeffs, bins, n_bins, plan_ptr, plan_idx):
        mc, w2 = fused_reweight_histogram(seg, t, coeffs, base_w, bins, n_bins=n_bins,
                                          plan_ptr=plan_ptr, plan_idx=plan_idx)
        ctx.save_for_backward(t, base_w, seg, coeffs, plan_ptr, plan_idx)
        ctx.bins = bins  # integer bins or a bin map: no gradient, no version to check
        ctx.n_bins = n_bins
        return mc, w2

    @staticmethod
    @once_differentiable
    def backward(ctx, gmc, gw2):
        t, base_w, seg, coeffs, plan_ptr, plan_idx = ctx.saved_tensors
        g_t, g_base = reweight_backward(seg, t, coeffs, base_w, ctx.bins, gmc, gw2,
                                        n_bins=ctx.n_bins, plan_ptr=plan_ptr, plan_idx=plan_idx,
                                        need_t=ctx.needs_input_grad[0])
        return (g_t, g_base) + (None,) * 6


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
        static_base, edges, n_bins, shift_kind, stride_j, n_axis_j, plan_ptr, plan_idx)


def fused_reweight_diff_perchain(
    t: torch.Tensor,  # [C, P] f32 — differentiable
    base_w: torch.Tensor,  # [C, E] f32 — differentiable (MC x osc x norm x TF1 x weight fns)
    seg: torch.Tensor,  # [C, P] i32
    coeffs: torch.Tensor,  # [P, K4, E] f32 or bf16
    bins,  # reweight.PerchainBins, or [C, E] i32 per-chain bins (outside [0, n_bins) dropped)
    *,
    n_bins: int,
    plan_ptr: torch.Tensor | None = None,  # the forward's activity plan
    plan_idx: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable (mc, w2) [C, n_bins] of a generic-route sample."""
    if isinstance(bins, torch.Tensor):
        bins = bins.contiguous()
    return _FusedReweightDiffPerchain.apply(t.contiguous(), base_w.contiguous(), seg, coeffs,
                                            bins, n_bins, plan_ptr, plan_idx)
