"""N-dim binnings with a flat bin space (port of the rectangular and
hyper-rectangle parts of ``mach3_tpu/samples/binning.py``; ``BinningHandler``,
``Samples/BinningHandler.h:10-123``).

Out-of-range events map to the garbage bin ``n_bins``, which the histogram
drops (the reference's selection-cut behaviour). Polygon binning waits
(ROADMAP).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..core.precision import FTYPE


def count_edges_le(edges: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Number of ``edges[k] <= x`` per element of x (int32, shape of x).

    Unrolled compare-accumulate over the (few hundred at most) edges: a NaN
    counts 0 and +inf counts every finite edge, which is what the kernels'
    binary search gives."""
    idx = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    for k in range(edges.shape[0]):
        idx += edges[k] <= x
    return idx


class SampleBinning(nn.Module):
    """Buffer ``edges`` [A, Kmax] f32 padded with +inf; the small static
    integers stay on the host as tuples, so lookups never wait for the device:
    ``n_bins_axis`` [A], ``strides`` [A] (row-major ravel), ``axis_vars`` [A]
    (rows of the sample's kinematics matrix), ``n_bins``."""

    def __init__(self, edges, n_bins_axis, strides, axis_vars, n_bins: int):
        super().__init__()
        self.register_buffer("edges", torch.as_tensor(edges, dtype=FTYPE))
        self.n_bins_axis = tuple(int(v) for v in n_bins_axis)
        self.strides = tuple(int(v) for v in strides)
        self.axis_vars = tuple(int(v) for v in axis_vars)
        self.n_bins = int(n_bins)

    @property
    def n_axes(self) -> int:
        return self.edges.shape[0]

    @classmethod
    def build(cls, edges: Sequence[np.ndarray], axis_vars: Sequence[int]) -> "SampleBinning":
        n_axes = len(edges)
        kmax = max(len(e) for e in edges)
        padded = np.full((n_axes, kmax), np.inf, np.float64)
        n_bins_axis = np.zeros(n_axes, np.int64)
        for a, e in enumerate(edges):
            e = np.asarray(e, np.float64)
            if np.any(np.diff(e) <= 0):
                raise ValueError(f"Bin edges for axis {a} not strictly increasing")
            padded[a, : len(e)] = e
            n_bins_axis[a] = len(e) - 1
        strides = np.ones(n_axes, np.int64)
        for a in range(n_axes - 2, -1, -1):
            strides[a] = strides[a + 1] * n_bins_axis[a + 1]
        return cls(
            edges=torch.from_numpy(padded),
            n_bins_axis=n_bins_axis,
            strides=strides,
            axis_vars=list(axis_vars),
            n_bins=int(np.prod(n_bins_axis)),
        )

    def axis_edges(self, a: int) -> torch.Tensor:
        """The real (unpadded) edges of axis ``a``, [n_bins_axis[a] + 1] f32."""
        return self.edges[a, : self.n_bins_axis[a] + 1]

    def find_bins(self, kinematics: torch.Tensor) -> torch.Tensor:
        """Flat bin index per event, ``n_bins`` for out-of-range:
        kinematics [..., V, E] -> [..., E] int64."""
        flat = None
        all_valid = None
        for a in range(self.n_axes):
            x = kinematics[..., self.axis_vars[a], :]
            n_a = self.n_bins_axis[a]
            idx = count_edges_le(self.axis_edges(a), x).long() - 1
            valid = (idx >= 0) & (idx < n_a)
            part = idx.clamp(0, n_a - 1) * self.strides[a]
            flat = part if flat is None else flat + part
            all_valid = valid if all_valid is None else all_valid & valid
        return torch.where(all_valid, flat, self.n_bins)


class NonUniformBinning(nn.Module):
    """Axis-aligned hyper-rectangle bins of arbitrary extents (the
    reference's non-uniform scheme, ``Samples/BinningHandler.h:103-123``).

    The lookup grid is refined to the union of all bin edges per axis, so
    each refined cell lies inside one analysis bin or none: a bin lookup is a
    per-axis edge count plus one ``cell -> bin`` gather. Buffers:
    ``cell_edges`` [A, Kmax] f32 padded with +inf (f32 as in the JAX
    package, so an event on an edge bins alike), ``cell_to_bin``
    [prod(cells)] i64 (``n_bins`` for a cell in a gap); on the host:
    ``n_cells_axis`` [A], ``cell_strides`` [A], ``axis_vars`` [A],
    ``n_bins`` and the extents [B, A, 2] (names, plots)."""

    def __init__(self, cell_edges, n_cells_axis, cell_strides, cell_to_bin, axis_vars,
                 n_bins: int, extents):
        super().__init__()
        self.register_buffer("cell_edges", torch.as_tensor(cell_edges, dtype=FTYPE))
        self.register_buffer("cell_to_bin", torch.as_tensor(cell_to_bin, dtype=torch.long))
        self.n_cells_axis = tuple(int(v) for v in n_cells_axis)
        self.cell_strides = tuple(int(v) for v in cell_strides)
        self.axis_vars = tuple(int(v) for v in axis_vars)
        self.n_bins = int(n_bins)
        self.extents = np.asarray(extents, np.float64)

    @property
    def n_axes(self) -> int:
        return self.cell_edges.shape[0]

    @classmethod
    def build(cls, bins, axis_vars: Sequence[int]) -> "NonUniformBinning":
        """``bins[b][a] = (low, high)``, the reference's YAML ``Bins`` layout
        (bins x dims x 2). Bins must not overlap; gaps are allowed (events
        there fall in the garbage bin)."""
        extents = np.asarray(bins, np.float64)
        if extents.ndim != 3 or extents.shape[2] != 2:
            raise ValueError("bins must be [n_bins][n_axes][2] (low, high)")
        n_bins, n_axes = extents.shape[:2]
        if np.any(extents[:, :, 0] >= extents[:, :, 1]):
            raise ValueError("every bin must have low < high on every axis")
        edges = [np.unique(extents[:, a, :]) for a in range(n_axes)]
        padded = np.full((n_axes, max(len(e) for e in edges)), np.inf, np.float64)
        n_cells = np.array([len(e) - 1 for e in edges], np.int64)
        for a, e in enumerate(edges):
            padded[a, : len(e)] = e
        strides = np.ones(n_axes, np.int64)
        for a in range(n_axes - 2, -1, -1):
            strides[a] = strides[a + 1] * n_cells[a + 1]
        # The midpoint of every refined cell -> its owning bin.
        centres = [0.5 * (e[:-1] + e[1:]) for e in edges]
        pts = np.stack([m.ravel() for m in np.meshgrid(*centres, indexing="ij")])  # [A, cells]
        inside = np.all((extents[:, :, 0, None] <= pts[None]) & (pts[None] < extents[:, :, 1, None]),
                        axis=1)  # [B, cells]
        owners = inside.sum(axis=0)
        if np.any(owners > 1):
            raise ValueError(f"overlapping bins cover cell {np.argwhere(owners > 1)[0, 0]}")
        cell_to_bin = np.where(owners == 1, inside.argmax(axis=0), n_bins)
        return cls(torch.from_numpy(padded), n_cells, strides, cell_to_bin, list(axis_vars),
                   n_bins, extents)

    def find_bins(self, kinematics: torch.Tensor) -> torch.Tensor:
        """Flat analysis-bin index per event, ``n_bins`` outside the refined
        grid or in a gap: kinematics [..., V, E] -> [..., E] int64."""
        flat = None
        all_valid = None
        for a in range(self.n_axes):
            x = kinematics[..., self.axis_vars[a], :]
            n_a = self.n_cells_axis[a]
            idx = count_edges_le(self.cell_edges[a, : n_a + 1], x).long() - 1
            valid = (idx >= 0) & (idx < n_a)
            part = idx.clamp(0, n_a - 1) * self.cell_strides[a]
            flat = part if flat is None else flat + part
            all_valid = valid if all_valid is None else all_valid & valid
        return torch.where(all_valid, self.cell_to_bin[flat], self.n_bins)

    def bin_name(self, b: int) -> str:
        """Human-readable extents, the reference's ``GetBinName``."""
        if b >= self.n_bins:
            return "underflow/overflow"
        return " x ".join(f"[{lo:g}, {hi:g})" for lo, hi in self.extents[b])


def histogram(
    weights: torch.Tensor, bins: torch.Tensor, n_bins: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(Σw, Σw²) per bin (``FillArray_MP``): weights/bins [..., E] ->
    two [..., n_bins] f32; the garbage bin ``n_bins`` is dropped."""
    w = weights.to(FTYPE)
    lead = w.shape[:-1]
    rows = w[..., 0].numel()
    nb1 = n_bins + 1
    offset = torch.arange(rows, device=w.device)[:, None] * nb1
    flat = (bins.reshape(rows, -1).long() + offset).reshape(-1)
    wf = w.reshape(-1)
    mc = torch.zeros(rows * nb1, dtype=FTYPE, device=w.device).index_add_(0, flat, wf)
    w2 = torch.zeros(rows * nb1, dtype=FTYPE, device=w.device).index_add_(0, flat, wf * wf)
    return (
        mc.reshape(lead + (nb1,))[..., :n_bins],
        w2.reshape(lead + (nb1,))[..., :n_bins],
    )
