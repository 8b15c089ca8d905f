"""Spline evaluation (port of ``mach3_tpu/splines/eval.py``).

``find_segments`` is the vectorised segment search over all spline parameters
(``SplineBase::FindSplineSegment``, ``Splines/SplineBase.cpp:44-110``).
Responses evaluate in full float32 — the JAX package's ``eval_dense(exact=True)``
oracle. The JAX production route rounds every response deviation to bf16
(one MXU pass); the card's f32 FMA costs nothing, so the port does not copy
that rounding. Each response is 4 coefficient rows ``seg*4 + (0..3)`` of
``coeffs[p, :, e]`` and one Horner step. ``eval_sparse`` is the sparse
table's: each spline's segment row gathered, one Horner step, the product
over each event's row of ``event_splines`` (the reference's
``EvalOnGPU_TotWeight``).
"""
from __future__ import annotations

import torch

from ..core.precision import FTYPE
from .monolith import DenseSplineTable, SparseSplineTable


def find_segments(
    knots_x: torch.Tensor, n_knots: torch.Tensor, values: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """knots_x [P, K] (+inf padded), n_knots [P], values [..., P] ->
    (segment [..., P] i32, t [..., P] f32).

    The segment counts the knots strictly below the value, minus one, clamped
    to [0, n_knots-2] (cubic extrapolation past the ends, the reference's
    clamped-segment semantics); ``t = value - knot[segment]``."""
    values = values.to(FTYPE)
    below = (knots_x < values[..., None]).sum(-1)
    seg = torch.minimum((below - 1).clamp(min=0), n_knots - 2)
    knot = knots_x.expand(values.shape + knots_x.shape[-1:]).gather(
        -1, seg[..., None]
    )[..., 0]
    return seg.to(torch.int32), (values - knot).to(FTYPE)


def coefficient_rows(coeffs: torch.Tensor, seg: torch.Tensor, p: int, dtype=FTYPE) -> torch.Tensor:
    """The 4 coefficient rows ``seg[c, p]*4 + (0..3)`` of parameter ``p`` per
    chain, upcast to ``dtype`` after the gather: [C, 4, E]."""
    rows = seg[:, p, None].long() * 4 + torch.arange(4, device=seg.device)  # [C, 4]
    return coeffs[p][rows].to(dtype)


def spline_product(
    coeffs: torch.Tensor, seg: torch.Tensor, t: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """``w * Π_p resp_p`` in f32: coeffs [P, K4, E] (f32 or bf16, upcast
    after the gather), seg/t [C, P], w [C, E] -> [C, E]."""
    for p in range(coeffs.shape[0]):
        co = coefficient_rows(coeffs, seg, p)
        tt = t[:, p, None]
        resp = co[:, 0] + tt * (co[:, 1] + tt * (co[:, 2] + tt * co[:, 3]))
        w = w * resp
    return w


def eval_dense(table: DenseSplineTable, params: torch.Tensor) -> torch.Tensor:
    """Per-event total spline weight: params [..., NP] -> [..., E] f32."""
    values = params[..., table.param_index]
    seg, t = find_segments(table.knots_x, table.n_knots, values)
    lead = seg.shape[:-1]
    p = table.n_spline_params
    ones = torch.ones(
        (seg[..., 0].numel(), table.n_events), dtype=FTYPE, device=seg.device
    )
    w = spline_product(table.coeffs, seg.reshape(-1, p), t.reshape(-1, p), ones)
    return w.reshape(lead + (table.n_events,))


def eval_sparse(table: SparseSplineTable, params: torch.Tensor) -> torch.Tensor:
    """Per-event total spline weight of a sparse table in f32: params
    [..., NP] -> [..., E]. The unit spline S that pads ``event_splines``
    responds exactly 1."""
    values = params[..., table.param_index]
    seg, t = find_segments(table.knots_x, table.n_knots, values)
    lead = seg.shape[:-1]
    seg, t = seg.reshape(-1, seg.shape[-1]), t.reshape(-1, t.shape[-1])
    n_rows, kmax = table.spline_coeffs.shape[:2]
    sp = table.spline_param
    row = torch.arange(n_rows, device=seg.device) * kmax + seg[:, sp].long()  # [N, S+1]
    co = table.spline_coeffs.reshape(-1, 4)[row].to(FTYPE)  # [N, S+1, 4]
    tt = t[:, sp]
    w = co[..., 0] + tt * (co[..., 1] + tt * (co[..., 2] + tt * co[..., 3]))
    per_event = w[:, table.event_splines]  # [N, E, W]
    return per_event.prod(-1).reshape(lead + (table.n_events,))


def eval_sparse_batched(table: SparseSplineTable, params: torch.Tensor) -> torch.Tensor:
    """[C, NP] -> [C, E] (the JAX package's vmap of ``eval_sparse``)."""
    return eval_sparse(table, params)


def eval_table(table, params: torch.Tensor) -> torch.Tensor:
    """``eval_dense`` or ``eval_sparse``, by the table's layout."""
    if isinstance(table, SparseSplineTable):
        return eval_sparse(table, params)
    return eval_dense(table, params)
