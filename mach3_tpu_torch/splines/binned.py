"""Bin-by-bin splines (port of ``mach3_tpu/splines/binned.py``; the
reference's ``Splines/BinnedSplineHandler.h/.cpp``).

Splines are defined per (kinematic bin, systematic, mode) and every event in
a bin shares its response. The result is a
:class:`~mach3_tpu_torch.splines.monolith.SparseSplineTable`: the
bin-splines form the flat spline list and each event's gather row points at
the bin-splines that apply to it, so evaluation is the sparse table's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.logging import get_logger
from ..params.parameterset import SplineInterpolation
from .coefficients import build_coefficients
from .monolith import (
    SparseSplineTable,
    SplineParamSpec,
    _stack_param_knots,
    is_flat,
    spline_rows,
    unit_spline,
)

_log = get_logger("splines")


@dataclasses.dataclass
class BinnedSplineParamSpec:
    """One binned spline systematic: ``y_knots`` [NB, K] responses per
    spline-bin, ``event_bins`` [E] each event's spline-bin (-1: the
    systematic does not apply, weight 1). The spline-bin axis may flatten
    any (mode x var1 x var2 x ...) grid."""

    name: str
    param_index: int
    x_knots: np.ndarray  # [K]
    y_knots: np.ndarray  # [NB, K]
    event_bins: np.ndarray  # [E]
    interpolation: SplineInterpolation = SplineInterpolation.TSPLINE3
    knot_low: float = -np.inf
    knot_high: float = np.inf


def build_binned_table(
    specs: Sequence[BinnedSplineParamSpec], n_events: int, drop_flat: bool = True
) -> SparseSplineTable:
    """Flatten binned splines into a sparse table: the bin-splines that are
    not flat (``drop_flat``) numbered systematic by systematic, and one
    gather slot per systematic for every event (the unit spline where the
    systematic does not apply or its bin is flat)."""
    knots_x, n_knots = _stack_param_knots([
        SplineParamSpec(s.name, s.param_index, s.x_knots, np.arange(len(s.y_knots)), s.y_knots)
        for s in specs
    ])
    kmax = knots_x.shape[1]
    blocks, params, bin_to_spline = [], [], []
    n_splines = 0
    for p, spec in enumerate(specs):
        y = np.clip(np.asarray(spec.y_knots, np.float64), spec.knot_low, spec.knot_high)
        b, c, d = build_coefficients(spec.x_knots, y, spec.interpolation)
        keep = ~is_flat(y) if drop_flat else np.ones(len(y), bool)
        blocks.append(spline_rows(y[keep], b[keep], c[keep], d[keep], kmax))
        params.append(np.full(int(keep.sum()), p, np.int64))
        mapping = np.full(len(y), -1, np.int64)
        mapping[keep] = n_splines + np.arange(int(keep.sum()))
        bin_to_spline.append(mapping)
        n_splines += int(keep.sum())
    blocks.append(unit_spline(kmax))

    event_splines = np.full((n_events, max(1, len(specs))), n_splines, np.int64)
    for p, spec in enumerate(specs):
        eb = np.asarray(spec.event_bins, np.int64)
        idx = np.where(eb >= 0, bin_to_spline[p][np.clip(eb, 0, None)], -1)
        has = idx >= 0
        event_splines[has, p] = idx[has]
    coeffs = np.concatenate(blocks)
    _log.info("Binned spline table: %d bin-splines over %d systematics, %d events, %.1f MB",
              n_splines, len(specs), n_events, coeffs.nbytes / 1e6)
    return SparseSplineTable(
        spline_coeffs=torch.from_numpy(coeffs),
        spline_param=np.concatenate(params + [np.zeros(1, np.int64)]),
        event_splines=event_splines,
        knots_x=torch.from_numpy(knots_x),
        n_knots=n_knots,
        param_index=[s.param_index for s in specs],
    )
