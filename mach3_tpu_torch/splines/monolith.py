"""Spline monoliths (port of ``mach3_tpu/splines/monolith.py``).

The reference's ``SMonolith`` (``Splines/SplineMonolith.cpp:53-250``) flattens
per-event response splines into SoA arrays. Two layouts:

* **Dense** (:class:`DenseSplineTable`): every (parameter, knot, event)
  coefficient, ``coeffs [P, K*4, E]`` with rows ``k*4 + (0, 1, 2, 3)`` =
  (y, b, c, d) of segment k. Missing (event, param) splines hold identity
  coefficients (y=1, b=c=d=0), so the per-event product over parameters
  needs no index map. ``dense_table_activity`` gives the table's sparsity
  pattern, which the kernel routes' layouts exploit (``splines/plan.py``).
* **Sparse** (:class:`SparseSplineTable`): only the splines that are not
  flat, a flat list ``spline_coeffs [S+1, K, 4]`` and a padded per-event
  gather map ``event_splines [E, W]`` into it (the reference's
  ``cpu_nParamPerEvent`` map as a rectangle); row S is the unit spline that
  padding points at. A sample with a sparse table takes the plain route.

``save_table`` / ``load_table`` write and read either as the JAX package's
versioned ``.npz`` (the reference's preprocessed-monolith file,
``Splines/SplineMonolith.h:48-52``), so each package loads the other's.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..core import tracing
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


@tracing.setup_span("build.table")
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


class SparseSplineTable(nn.Module):
    """Buffers: spline_coeffs [S+1, Kmax, 4] f32 (row S the unit spline,
    response 1 everywhere), spline_param [S+1] i64 (each spline's parameter,
    a row of ``knots_x``), event_splines [E, W] i64 (each event's splines,
    padded with S), knots_x [P, Kmax] f32 padded with +inf, n_knots [P] i64,
    param_index [P] i64 (into the proposal vector)."""

    def __init__(self, spline_coeffs, spline_param, event_splines, knots_x, n_knots,
                 param_index):
        super().__init__()
        self.register_buffer("spline_coeffs", torch.as_tensor(spline_coeffs))
        self.register_buffer("spline_param", torch.as_tensor(spline_param, dtype=torch.long))
        self.register_buffer("event_splines", torch.as_tensor(event_splines, dtype=torch.long))
        self.register_buffer("knots_x", torch.as_tensor(knots_x, dtype=FTYPE))
        self.register_buffer("n_knots", torch.as_tensor(n_knots, dtype=torch.long))
        self.register_buffer(
            "param_index", torch.as_tensor(param_index, dtype=torch.long)
        )

    @property
    def n_splines(self) -> int:
        return self.spline_coeffs.shape[0] - 1

    @property
    def n_spline_params(self) -> int:
        return self.knots_x.shape[0]

    @property
    def n_events(self) -> int:
        return self.event_splines.shape[0]


def is_flat(y_knots: np.ndarray) -> np.ndarray:
    """Mask of splines whose response is identically 1 (the reference drops
    these from the monolith, ``SplineMonolith.cpp:53-250``)."""
    return np.all(np.asarray(y_knots) == 1.0, axis=-1)


def spline_rows(y, b, c, d, kmax: int) -> np.ndarray:
    """[S, kmax, 4] f32 coefficient rows of S splines of K knots (each of
    y, b, c, d [S, K]); knots past K repeat the last one, so a clamped
    segment index stays right."""
    k = y.shape[1]
    rows = np.zeros((y.shape[0], kmax, 4), np.float32)
    for j, v in enumerate((y, b, c, d)):
        rows[:, :k, j] = v
    if k < kmax:
        rows[:, k:] = rows[:, k - 1 : k]
    return rows


def unit_spline(kmax: int) -> np.ndarray:
    """The [1, kmax, 4] rows of the unit spline: y = 1, b = c = d = 0."""
    unit = np.zeros((1, kmax, 4), np.float32)
    unit[..., 0] = 1.0
    return unit


def build_sparse_table(
    specs: Sequence[SplineParamSpec], n_events: int, drop_flat: bool = True
) -> SparseSplineTable:
    """The sparse table of ``specs``: one row per (parameter, event) spline
    that is not flat (``drop_flat``), numbered parameter by parameter in
    ``event_ids`` order; each event's row of ``event_splines`` lists its
    splines in that order, padded with the unit spline S."""
    knots_x, n_knots = _stack_param_knots(specs)
    kmax = knots_x.shape[1]
    blocks, params, events = [], [], []
    for p, spec in enumerate(specs):
        y, b, c, d = _spec_coefficients(spec)
        keep = ~is_flat(y) if drop_flat else np.ones(len(y), bool)
        blocks.append(spline_rows(y[keep], b[keep], c[keep], d[keep], kmax))
        params.append(np.full(int(keep.sum()), p, np.int64))
        events.append(np.asarray(spec.event_ids, np.int64)[keep])
    blocks.append(unit_spline(kmax))
    coeffs = np.concatenate(blocks)
    spline_event = np.concatenate(events) if events else np.zeros(0, np.int64)
    n_splines = len(spline_event)
    event_splines = gather_map(spline_event, n_events, n_splines)
    _log.info("Sparse spline table: %d splines (of %d possible), width %d, %.1f MB", n_splines,
              sum(len(s.event_ids) for s in specs), event_splines.shape[1], coeffs.nbytes / 1e6)
    return SparseSplineTable(
        spline_coeffs=torch.from_numpy(coeffs),
        spline_param=np.concatenate(params + [np.zeros(1, np.int64)]),
        event_splines=event_splines,
        knots_x=torch.from_numpy(knots_x),
        n_knots=n_knots,
        param_index=[s.param_index for s in specs],
    )


def gather_map(spline_event: np.ndarray, n_events: int, pad: int) -> np.ndarray:
    """[E, W] i64: each event's splines (``spline_event[s]`` is spline s's
    event) in increasing s, padded with ``pad``; W is the most any event has
    (at least 1)."""
    counts = np.bincount(spline_event, minlength=n_events)
    width = max(1, int(counts.max(initial=0)))
    out = np.full((n_events, width), pad, np.int64)
    order = np.argsort(spline_event, kind="stable")
    ev = spline_event[order]
    rank = np.arange(len(ev)) - np.searchsorted(ev, ev)
    out[ev, rank] = order
    return out


# Preprocessed-monolith files: the JAX package's format, field names and
# dtypes (integers as int32), so each package reads the other's.
_MONOLITH_FORMAT = 2
_TABLE_FIELDS = {
    "dense": ("coeffs", "knots_x", "n_knots", "param_index"),
    "sparse": ("spline_coeffs", "spline_param", "event_splines", "knots_x", "n_knots",
               "param_index"),
}


def save_table(path: str, table: DenseSplineTable | SparseSplineTable) -> None:
    """Write a built spline table (``np.savez_compressed``; a bf16 field is
    stored as f32 and named in ``__bf16__``)."""
    kind = "dense" if isinstance(table, DenseSplineTable) else "sparse"
    fields, bf16 = {}, []
    for name in _TABLE_FIELDS[kind]:
        v = getattr(table, name).detach().cpu()
        if v.dtype == torch.bfloat16:
            bf16.append(name)
            v = v.float()
        a = v.numpy()
        fields[name] = a.astype(np.int32) if a.dtype.kind == "i" else a
    np.savez_compressed(path, __format__=np.int32(_MONOLITH_FORMAT), __kind__=np.array(kind),
                        __bf16__=np.array(",".join(bf16)), **fields)
    _log.info("Saved %s spline table to %s", kind, path)


def load_table(path: str) -> DenseSplineTable | SparseSplineTable:
    """Read a table written by :func:`save_table` (of either package)."""
    with np.load(path, allow_pickle=False) as f:
        fmt = int(f["__format__"])
        if fmt != _MONOLITH_FORMAT:
            raise ValueError(f"{path}: spline-table format {fmt} != supported {_MONOLITH_FORMAT}")
        kind = str(f["__kind__"])
        bf16 = set(str(f["__bf16__"]).split(",")) if "__bf16__" in f.files else set()
        arrays = {k: f[k] for k in _TABLE_FIELDS[kind]}
    tensors = {}
    for name, a in arrays.items():
        t = torch.from_numpy(np.array(a))
        if name in bf16:
            t = t.to(torch.bfloat16)
        elif a.dtype.kind == "f":
            t = t.to(FTYPE)
        tensors[name] = t
    _log.info("Loaded %s spline table from %s", kind, path)
    cls = DenseSplineTable if kind == "dense" else SparseSplineTable
    return cls(**tensors)


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
