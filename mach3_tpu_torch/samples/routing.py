"""Kernel-variant routing (port of the variant decision of
``mach3_tpu/samples/routing.py``).

The JAX package sizes tiles against the TPU's VMEM; none of that carries
over. What carries over is the decision, made once at build time from static
properties: which reweight variant a sample takes.

* ``shifted`` — a single shift, of a kind the kernel forms itself
  (``SHIFT_KINDS``), on one axis of a rectangular binning, dense table, up
  to ``MAX_PERCHAIN_BINS`` bins: the shifted CUDA kernel of
  ``splines/reweight.py`` (K1; with P > 16 it stands for K3, whose P blocks
  the CUDA kernel's run-time loop over P replaces).
* ``shared``  — static bins, dense table, up to ``MAX_KERNEL_BINS`` bins: the
  shared CUDA kernel (K2), over the event layout of ``splines/plan.py``.
* ``generic`` — per-chain bins of any other kind (several shifts, a custom
  binning with a shift, or a shift with no kernel kind), P <= 16 and up to
  ``MAX_PERCHAIN_BINS`` bins: the per-chain CUDA kernel (K5; K5b is its
  ``hist="blockdiag"`` form), binning in-kernel from the sample's bin map
  when every shift of a binned axis is of a named kind, else fed the bins
  as input (``samples/events._shift_bins``).
* ``xla``     — plain torch ops (the JAX package computes that route
  outside Pallas too).
"""
from __future__ import annotations

import dataclasses

from ..core.logging import get_logger
from ..splines.monolith import DenseSplineTable
from ..splines.reweight import MAX_BINS, MAX_PARAMS, MAX_SHARED_BINS

_log = get_logger("routing")

#: Beyond this many bins the JAX package takes the XLA path; the shared
#: kernel takes the same limit.
MAX_KERNEL_BINS = MAX_SHARED_BINS
#: Per-chain-bins variants keep one shared-memory histogram per chain tile.
MAX_PERCHAIN_BINS = MAX_BINS
#: Past this many spline params the JAX package switches to param-blocked
#: kernels (K2/K3); the CUDA kernels loop over any P, but the per-chain
#: kernel of the generic route has no blocked form.
MAX_UNROLL_PARAMS = 16


@dataclasses.dataclass(frozen=True)
class KernelRoute:
    """The routing decision recorded on the SampleModel."""

    use_kernel: bool
    variant: str  # "shared" | "shifted" | "generic" | "xla"
    reason: str = ""
    # The caller's original request, kept so a rebuild can re-route.
    requested: object = "auto"


def choose_kernel_route(
    n_bins: int,
    spline_table,
    has_static_bins: bool,
    has_kernel_shift: bool,
    requested: bool | str = "auto",
) -> KernelRoute:
    """Pick the kernel variant, or the plain route.

    requested: ``"auto"`` or ``True`` route to a kernel where one fits;
    ``False`` forces the plain route. Unlike the JAX package the decision
    does not depend on the backend: a kernel wrapper runs its plain version
    on CPU tensors."""
    if requested is False:
        return KernelRoute(False, "xla", reason="disabled by caller", requested=requested)
    if not isinstance(spline_table, DenseSplineTable):
        return KernelRoute(False, "xla", reason="no dense spline table", requested=requested)
    if n_bins > MAX_KERNEL_BINS:
        return _fallback(requested, f"n_bins={n_bins} > {MAX_KERNEL_BINS}")
    p = spline_table.n_spline_params
    if p > MAX_PARAMS:
        return _fallback(requested, f"P={p} > {MAX_PARAMS}")
    if has_static_bins:
        variant = "shared"
    elif has_kernel_shift:
        variant = "shifted"
        if n_bins > MAX_PERCHAIN_BINS:
            return _fallback(requested, f"n_bins={n_bins} > {MAX_PERCHAIN_BINS} (shifted)")
    else:
        variant = "generic"
        if n_bins > MAX_PERCHAIN_BINS:
            return _fallback(requested, f"n_bins={n_bins} > {MAX_PERCHAIN_BINS} (generic)")
        if p > MAX_UNROLL_PARAMS:
            return _fallback(requested, f"P={p} > {MAX_UNROLL_PARAMS} (generic, no blocked form)")
    route = KernelRoute(True, variant, reason=f"P={p}, bins={n_bins}", requested=requested)
    _log.info("kernel route: %s — %s", route.variant, route.reason)
    return route


def _fallback(requested: bool | str, why: str) -> KernelRoute:
    if requested is True:
        _log.warning("kernel requested but statically infeasible: %s — plain route", why)
    else:
        _log.info("kernel route: xla — %s", why)
    return KernelRoute(False, "xla", reason=why, requested=requested)
