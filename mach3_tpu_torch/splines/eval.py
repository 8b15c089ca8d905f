"""Dense spline evaluation (port of ``mach3_tpu/splines/eval.py``).

``find_segments`` is the vectorised segment search over all spline parameters
(``SplineBase::FindSplineSegment``, ``Splines/SplineBase.cpp:44-110``).
Responses evaluate in full float32 — the JAX package's ``eval_dense(exact=True)``
oracle. The JAX production route rounds every response deviation to bf16
(one MXU pass); the card's f32 FMA costs nothing, so the port does not copy
that rounding. Each response is 4 coefficient rows ``seg*4 + (0..3)`` of
``coeffs[p, :, e]`` and one Horner step.
"""
from __future__ import annotations

import torch

from ..core.precision import FTYPE
from .monolith import DenseSplineTable


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


def spline_product(
    coeffs: torch.Tensor, seg: torch.Tensor, t: torch.Tensor, w: torch.Tensor
) -> torch.Tensor:
    """``w * Π_p resp_p`` in f32: coeffs [P, K4, E] (f32 or bf16, upcast
    after the gather), seg/t [C, P], w [C, E] -> [C, E]."""
    n_params = coeffs.shape[0]
    rows4 = torch.arange(4, device=seg.device)
    for p in range(n_params):
        rows = seg[:, p, None].long() * 4 + rows4  # [C, 4]
        co = coeffs[p][rows].to(FTYPE)  # [C, 4, E]
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
