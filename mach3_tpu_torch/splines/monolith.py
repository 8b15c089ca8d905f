"""Dense spline monolith (port of ``mach3_tpu/splines/monolith.py``, dense part).

The reference's ``SMonolith`` (``Splines/SplineMonolith.cpp:53-250``) flattens
per-event response splines into SoA arrays. The dense layout stores every
(parameter, knot, event) coefficient: ``coeffs [P, K*4, E]`` with rows
``k*4 + (0, 1, 2, 3)`` = (y, b, c, d) of segment k. Missing (event, param)
splines hold identity coefficients (y=1, b=c=d=0), so the per-event product
over parameters needs no index map. ``dense_table_activity`` gives the
table's sparsity pattern, which the shared route's layout exploits
(``splines/plan.py``). The sparse table waits (ROADMAP).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..core.logging import get_logger
from ..core.precision import FTYPE
from ..params.parameterset import SplineInterpolation
from .coefficients import build_coefficients

_log = get_logger("splines")


@dataclasses.dataclass
class SplineParamSpec:
    """Host-side description of one spline systematic before flattening.

    ``x_knots`` is the shared x-grid of this parameter; ``event_ids[i]`` and
    ``y_knots[i]`` give the response of event ``event_ids[i]`` at each knot.
    Events absent from ``event_ids`` have no spline for this parameter."""

    name: str
    param_index: int  # index into the proposed-parameter vector
    x_knots: np.ndarray  # [K]
    event_ids: np.ndarray  # [S_p]
    y_knots: np.ndarray  # [S_p, K]
    interpolation: SplineInterpolation = SplineInterpolation.TSPLINE3
    knot_low: float = -np.inf  # knot-weight capping (SplineStructs.h:49-127)
    knot_high: float = np.inf


class DenseSplineTable(nn.Module):
    """Buffers: coeffs [P, Kmax*4, E] (f32, or bf16 for ``low_memory``),
    knots_x [P, Kmax] f32 padded with +inf, n_knots [P] i64, param_index [P]
    i64 (into the proposal vector)."""

    def __init__(self, coeffs, knots_x, n_knots, param_index):
        super().__init__()
        self.register_buffer("coeffs", torch.as_tensor(coeffs))
        self.register_buffer("knots_x", torch.as_tensor(knots_x, dtype=FTYPE))
        self.register_buffer("n_knots", torch.as_tensor(n_knots, dtype=torch.long))
        self.register_buffer(
            "param_index", torch.as_tensor(param_index, dtype=torch.long)
        )

    @property
    def n_spline_params(self) -> int:
        return self.coeffs.shape[0]

    @property
    def n_events(self) -> int:
        return self.coeffs.shape[2]

    @property
    def kmax(self) -> int:
        return self.knots_x.shape[1]


def _stack_param_knots(specs: Sequence[SplineParamSpec]) -> tuple[np.ndarray, np.ndarray]:
    kmax = max(len(s.x_knots) for s in specs)
    knots_x = np.full((len(specs), kmax), np.inf, np.float64)
    n_knots = np.zeros(len(specs), np.int64)
    for p, s in enumerate(specs):
        k = len(s.x_knots)
        knots_x[p, :k] = s.x_knots
        n_knots[p] = k
    return knots_x, n_knots


def _spec_coefficients(spec: SplineParamSpec) -> tuple[np.ndarray, ...]:
    """Knot-capped (y, b, c, d) for all splines of one parameter: each [S_p, K]."""
    y = np.clip(np.asarray(spec.y_knots, np.float64), spec.knot_low, spec.knot_high)
    b, c, d = build_coefficients(spec.x_knots, y, spec.interpolation)
    return y, b, c, d


def build_dense_table(
    specs: Sequence[SplineParamSpec], n_events: int, low_memory: bool = False
) -> DenseSplineTable:
    """``low_memory=True`` stores the coefficients in bfloat16 (the
    reference's ``_LOW_MEMORY_STRUCTS_`` build): half the bytes, ~3 decimal
    digits of response precision."""
    knots_x, n_knots = _stack_param_knots(specs)
    kmax = knots_x.shape[1]
    n_params = len(specs)
    coeffs = np.zeros((n_params, kmax, 4, n_events), np.float32)
    coeffs[:, :, 0, :] = 1.0  # identity response for missing splines
    for p, spec in enumerate(specs):
        y, b, c, d = _spec_coefficients(spec)
        ev = np.asarray(spec.event_ids, np.int64)
        k = len(spec.x_knots)
        coeffs[p, :k, 0, ev] = y.astype(np.float32)
        coeffs[p, :k, 1, ev] = b.astype(np.float32)
        coeffs[p, :k, 2, ev] = c.astype(np.float32)
        coeffs[p, :k, 3, ev] = d.astype(np.float32)
        # Pad unused knot rows with the last valid segment so any clamped
        # segment index stays correct.
        if k < kmax:
            coeffs[p, k:, :, :] = coeffs[p, k - 1 : k, :, :]
    coeffs = torch.from_numpy(coeffs.reshape(n_params, kmax * 4, n_events))
    if low_memory:
        coeffs = coeffs.to(torch.bfloat16)
    _log.info(
        "Dense spline table: %d params x %d knots x %d events%s",
        n_params, kmax, n_events, " (bf16 low-memory)" if low_memory else "",
    )
    return DenseSplineTable(
        coeffs=coeffs,
        knots_x=torch.from_numpy(knots_x),
        n_knots=n_knots,
        param_index=[s.param_index for s in specs],
    )


def dense_table_activity(table: DenseSplineTable) -> np.ndarray:
    """[P, E] bool: True where the response is NOT the identity (some y row
    != 1 or some b/c/d row != 0). Skipping an inactive (param, event) pair is
    exact: identity rows give ``resp == 1.0`` in f32 for any finite t.

    The monolith's sparsity pattern (the reference keeps it as per-event
    spline lists, ``SplineCommon.h:30-50``); the shared route's layout turns
    it into per-tile lists of active parameters."""
    c = table.coeffs
    c4 = c.reshape(c.shape[0], -1, 4, c.shape[2])
    non_y = (c4[:, :, 1:, :] != 0).any(dim=2).any(dim=1)
    y_not1 = (c4[:, :, 0, :] != 1).any(dim=1)
    return (non_y | y_not1).cpu().numpy()
