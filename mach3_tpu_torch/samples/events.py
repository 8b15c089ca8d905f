"""Host-side event store and SampleModel construction (port of
``mach3_tpu/samples/events.py``).

The reference's sample-init pipeline (``Samples/SampleHandlerFD.cpp:169-202``):
MC into a struct-of-arrays, norm parameters matched to events once
(``CalcNormsBins``, ``:637-747``), oscillation channels wired — beam
(``:1047-1122``) or atmospheric through PREM — then the static tensors of a
:class:`SampleModel`. A sample on the shared, shifted or generic route gets
its events laid out for its kernel (``splines/plan.py``; JAX
``events.py:428-598`` lays out the shared route only).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..core.exceptions import ConfigError
from ..core.logging import get_logger
from ..core.precision import ATYPE, FTYPE
from ..osc.prem import PRODUCTION_HEIGHT_KM, path_through_earth
from ..params.parameterset import ParamMeta
from ..splines.monolith import DenseSplineTable, dense_table_activity
from ..splines.plan import shared_layout, shifted_layout
from ..splines.reweight import (
    MAX_EDGES,
    MAX_MAP_AXES,
    MAX_MAP_CELLS,
    MAX_MAP_SHIFTS,
    MAX_SMEM,
    SHIFT_KINDS,
    bin_map_floats,
    perchain_smem,
    perchain_smem_bytes,
)
from ..splines.tf1 import TF1Table
from .binning import NonUniformBinning, SampleBinning
from .routing import choose_kernel_route
from .sample import AtmoOscConfig, BinMap, OscConfig, SampleModel, ShiftSpec, WeightSpec
from .teststats import TestStatistic

_log = get_logger("samples")

#: PDG -> flavour index (e, mu, tau); sign = antineutrino.
_FLAVOUR = {12: 0, 14: 1, 16: 2}


@dataclasses.dataclass
class EventData:
    """Struct-of-arrays MC event record (``EventInfo``,
    ``Samples/FarDetectorCoreInfoStruct.h:82-126`` — minus the pointers)."""

    kinematics: dict[str, np.ndarray]  # e.g. {"e_true": ..., "e_reco": ...}
    mode: np.ndarray  # [E] generator interaction mode
    target: np.ndarray  # [E] target nucleus Z
    pdg: np.ndarray  # [E] post-oscillation neutrino PDG (±12/±14/±16)
    preosc_pdg: np.ndarray  # [E] flux (pre-oscillation) PDG
    mc_weight: np.ndarray  # [E] nominal MC weight

    @property
    def n_events(self) -> int:
        return len(self.mode)


def match_event_mask(events: EventData, meta: ParamMeta, sample_name: str) -> np.ndarray:
    """[E] bool mask of the events a parameter applies to (the matching rules
    of ``CalcNormsBins``, ``SampleHandlerFD.cpp:667-747``): empty selection
    lists match everything; kinematic cuts test the nominal kinematics."""
    mask = np.ones(events.n_events, dtype=bool)
    if meta.modes:
        mask &= np.isin(events.mode, meta.modes)
    if meta.pdgs:
        mask &= np.isin(events.pdg, meta.pdgs)
    if meta.preosc_pdgs:
        mask &= np.isin(events.preosc_pdg, meta.preosc_pdgs)
    if meta.targets:
        mask &= np.isin(events.target, meta.targets)
    for cut in meta.kinematic_cuts:
        if cut.variable not in events.kinematics:
            raise ConfigError(
                f"Kinematic cut variable '{cut.variable}' unknown to sample {sample_name}"
            )
        v = events.kinematics[cut.variable]
        mask &= (v >= cut.low) & (v < cut.high)
    return mask


def match_norm_params(
    events: EventData, metas: Sequence[tuple[ParamMeta, int]], sample_name: str
) -> np.ndarray:
    """Padded norm-index matrix [E, W] of global parameter indices (-1 pads).

    metas: (meta, global_index) pairs for norm-type parameters."""
    e = events.n_events
    masks: list[np.ndarray] = []
    gidxs: list[int] = []
    for meta, gidx in metas:
        if not meta.applies_to_sample(sample_name):
            continue
        masks.append(match_event_mask(events, meta, sample_name))
        gidxs.append(gidx)
    pad = -1  # replaced by the unit slot downstream
    if not masks:
        return np.full((e, 1), pad, np.int64)
    # Row-packing: np.nonzero of the [E, M] mask is row-major, so within an
    # event the meta order is kept; a hit's position is its rank in its row.
    m = np.stack(masks, axis=1)
    width = max(1, int(m.sum(axis=1).max(initial=0)))
    out = np.full((e, width), pad, np.int64)
    rows, cols = np.nonzero(m)
    pos = np.arange(len(rows)) - np.searchsorted(rows, rows)
    out[rows, pos] = np.asarray(gidxs, np.int64)[cols]
    _log.info("%s: matched %d norm-param/event associations (width %d)",
              sample_name, len(rows), width)
    return out


def _channels(events: EventData):
    """Oscillation channels, the unique (preosc_pdg, pdg) pairs
    (``OscChannelInfo``, ``FarDetectorCoreInfoStruct.h:8-37``): (channel per
    event [E], alpha, beta, anti per channel); both PDGs must share the sign."""
    pairs = np.stack([events.preosc_pdg, events.pdg], axis=1)
    uniq, inverse = np.unique(pairs, axis=0, return_inverse=True)
    alpha, beta, anti = [], [], []
    for gen, det in uniq:
        if (gen > 0) != (det > 0):
            raise ConfigError(f"Oscillation channel mixes nu and nubar: {gen} -> {det}")
        alpha.append(_FLAVOUR[abs(int(gen))])
        beta.append(_FLAVOUR[abs(int(det))])
        anti.append(gen < 0)
    return inverse.reshape(-1), alpha, beta, anti


def _nearest(grid, vals) -> np.ndarray:
    """Index of the nearest grid point (ties to the upper one)."""
    g = np.asarray(grid, np.float64)
    idx = np.clip(np.searchsorted(g, vals), 0, len(g) - 1)
    left = np.clip(idx - 1, 0, len(g) - 1)
    return np.where(np.abs(g[left] - vals) < np.abs(g[idx] - vals), left, idx)


def build_osc_config(
    events: EventData,
    e_grid: np.ndarray,
    osc_param_gidx: Sequence[int],
    baseline: float,
    density: float,
    electron_fraction: float = 0.5,
    nc_modes: Sequence[int] = (),
    e_true_var: str = "e_true",
    dtype=FTYPE,
    phase_dtype=ATYPE,
) -> OscConfig:
    """Per-event oscillation-channel and energy-grid gather indices.

    Channels are the unique (preosc_pdg, pdg) pairs (``OscChannelInfo``,
    ``FarDetectorCoreInfoStruct.h:8-37``); both PDGs must share the sign.
    Each event snaps to the nearest grid energy."""
    inverse, alpha, beta, anti = _channels(events)

    return OscConfig(
        e_grid=np.asarray(e_grid, np.float64),
        event_grid_idx=_nearest(e_grid, np.asarray(events.kinematics[e_true_var], np.float64)),
        event_channel=inverse,
        chan_alpha=alpha,
        chan_beta=beta,
        chan_anti=anti,
        nc_mask=np.isin(events.mode, list(nc_modes)),
        osc_param_idx=list(osc_param_gidx),
        baseline=baseline,
        density=density,
        electron_fraction=electron_fraction,
        dtype=dtype,
        phase_dtype=phase_dtype,
    )


def build_atmo_osc_config(
    events: EventData,
    e_grid: np.ndarray,
    cosz_grid: np.ndarray,
    osc_param_gidx: Sequence[int],
    nc_modes: Sequence[int] = (),
    e_true_var: str = "e_true",
    cosz_var: str = "cos_zenith",
    production_height_km: float = PRODUCTION_HEIGHT_KM,
    production_heights: Sequence[float] | None = None,
    height_weights: Sequence[float] | None = None,
    dtype=FTYPE,
) -> AtmoOscConfig:
    """Atmospheric wiring: PREM layered paths per zenith bin and per-event
    (channel, cosZ, E) gather indices (CUDAProb3-equivalent setup).

    production_heights / height_weights: quadrature nodes and weights of the
    production-height average (CUDAProb3's averaged-height mode): the grids
    become Σ_h w_h P(h). Omit for one fixed height (``production_height_km``).
    Each event snaps to the nearest grid energy and zenith; densities are
    deduplicated for the eigensolve, and zenith bins are grouped by their
    segment count (``z_groups``)."""
    inverse, alpha, beta, anti = _channels(events)

    hw = None
    if production_heights is not None:
        if height_weights is None:
            height_weights = np.full(len(production_heights), 1.0 / len(production_heights))
        hw = np.asarray(height_weights, np.float64)
        hw = hw / hw.sum()
        per_h = [path_through_earth(np.asarray(cosz_grid), production_height_km=float(h))
                 for h in production_heights]
        nl = max(p[0].shape[1] for p in per_h)  # pad every height to the common maximum

        def padl(a, value=0.0):
            return np.pad(a, ((0, 0), (0, nl - a.shape[1])), constant_values=value)

        lengths = np.stack([padl(p[0]) for p in per_h])  # [H, NZ, NL]
        rho = np.stack([padl(p[1]) for p in per_h])
        ye = np.stack([padl(p[2], 0.5) for p in per_h])
    else:
        lengths, rho, ye = path_through_earth(
            np.asarray(cosz_grid), production_height_km=production_height_km
        )
    rho_eff = rho * (ye / 0.5)

    e_idx = _nearest(e_grid, np.asarray(events.kinematics[e_true_var], np.float64))
    z_idx = _nearest(cosz_grid, np.asarray(events.kinematics[cosz_var], np.float64))
    nz, ne = len(cosz_grid), len(e_grid)
    flat = (inverse * nz + z_idx) * ne + e_idx
    rho_u, rho_inv = np.unique(rho_eff.ravel(), return_inverse=True)

    # Zenith bins grouped by segment count: down-going bins have one air
    # segment and skip the padded identity layers of the full PREM chain.
    nseg = (lengths > 0).sum(axis=-1)
    if nseg.ndim == 2:
        nseg = nseg.max(axis=0)
    nseg = np.maximum(nseg, 1)
    groups = []
    for nl in sorted(set(int(v) for v in nseg)):
        idxs = tuple(int(i) for i in np.nonzero(nseg == nl)[0])
        assert np.all(lengths[..., list(idxs), nl:] == 0.0)
        groups.append((idxs, nl))

    return AtmoOscConfig(
        e_grid=np.asarray(e_grid, np.float64),
        layer_lengths=lengths,
        layer_rho=rho_eff,
        event_flat_idx=flat,
        chan_alpha=alpha,
        chan_beta=beta,
        chan_anti=anti,
        nc_mask=np.isin(events.mode, list(nc_modes)),
        osc_param_idx=list(osc_param_gidx),
        rho_unique=rho_u,
        rho_idx=rho_inv.reshape(rho_eff.shape),
        height_weights=hw,
        z_groups=tuple(groups) if len(groups) > 1 else None,
        dtype=dtype,
    )


def _take_events(arrays: dict, table: DenseSplineTable, lay) -> dict:
    """``arrays`` (numpy ``kin`` [V, E], ``mc_weight`` [E], ``norm_idx``
    [E, W], ``norm_s`` [NA1, E] or None, ``static_bins`` / ``shift_static_base``
    [E] or None, ``weight_mask`` [Nw, E] or None, ``event_perm`` / ``event_pad``
    of an earlier layout or None, and the ``osc`` and ``tf1_table`` modules or
    None) with the events and the table's parameters in the order of the
    layout ``lay``, as keyword arguments of :class:`SampleModel` with the
    layout's CSR plan. Pad events weigh 0, respond 1 to every TF1 parameter
    and match no weight function; ``event_perm`` [E'] (the index of each
    event before any layout) and ``event_pad`` [E'] say where each came from."""
    perm, pad = lay.event_perm, lay.pad_mask
    tperm, pperm = torch.from_numpy(perm), torch.from_numpy(lay.param_perm)

    def events(x, axis=-1):
        return None if x is None else np.take(np.asarray(x), perm, axis=axis)

    mc_weight = events(arrays["mc_weight"]).copy()
    mc_weight[pad] = 0.0  # pads carry no weight
    weight_mask = events(arrays.get("weight_mask"))
    if weight_mask is not None:
        weight_mask = weight_mask & ~pad
    osc, tf1 = arrays.get("osc"), arrays.get("tf1_table")
    before, before_pad = arrays.get("event_perm"), arrays.get("event_pad")
    return dict(
        arrays,
        kin=events(arrays["kin"]),
        mc_weight=mc_weight,
        norm_idx=events(arrays["norm_idx"], axis=0),
        norm_s=events(arrays["norm_s"]),
        static_bins=events(arrays.get("static_bins")),
        shift_static_base=events(arrays.get("shift_static_base")),
        spline_table=DenseSplineTable(
            table.coeffs.index_select(0, pperm).index_select(2, tperm),
            table.knots_x[pperm], table.n_knots[pperm], table.param_index[pperm],
        ),
        osc=None if osc is None else osc.take_events(perm),
        tf1_table=None if tf1 is None else tf1.take_events(perm, pad),
        weight_mask=weight_mask,
        event_perm=perm if before is None else np.asarray(before)[perm],
        event_pad=pad if before_pad is None else np.asarray(before_pad)[perm] | pad,
        hist_plan_ptr=lay.plan_ptr,
        hist_plan_idx=lay.plan_idx,
    )


def _log_layout(name: str, what: str, lay, n_params: int) -> None:
    n_pad = int(lay.pad_mask.sum())
    _log.info("%s: %s — %d activity groups, %d pad events (%.1f%%), %d tiles, %.2f of %d "
              "params active per tile", name, what, lay.n_groups, n_pad,
              100.0 * n_pad / max(len(lay.event_perm), 1), lay.n_tiles, lay.mean_active(),
              n_params)


def apply_shared_layout(name: str, arrays: dict, n_bins: int) -> dict:
    """Lay a shared-route sample's events out for the shared kernel
    (``plan.shared_layout``): parameters regrouped, events sorted by
    (activity group, static bin, oscillation index) and padded with
    zero-weight copies, and the per-tile plan and histogram windows.
    ``arrays`` and the result as in :func:`_take_events`."""
    table, osc = arrays["spline_table"], arrays["osc"]
    act = dense_table_activity(table)
    bins = np.asarray(arrays["static_bins"], np.int64)
    key = None if osc is None else osc.event_sort_key().cpu().numpy()
    lay = shared_layout(act, bins, n_bins, key)
    _log_layout(name, f"shared layout, window {lay.nbl} bins", lay, act.shape[0])
    return dict(_take_events(arrays, table, lay), hist_tile_start=lay.tile_start,
                hist_tile_width=lay.tile_width, hist_nbl=lay.nbl)


def apply_shifted_layout(name: str, arrays: dict) -> dict:
    """Lay a shifted-route or generic-route sample's events out for the
    per-chain kernel (``plan.shifted_layout``): parameters regrouped, events
    sorted by activity group (no bin sort: the kernel bins per chain) and
    padded with zero-weight copies, and the per-tile plan. ``arrays`` and the
    result as in :func:`_take_events`."""
    table = arrays["spline_table"]
    act = dense_table_activity(table)
    lay = shifted_layout(act)
    _log_layout(name, "per-chain layout", lay, act.shape[0])
    return _take_events(arrays, table, lay)


def build_sample_model(
    name: str,
    events: EventData,
    var_order: Sequence[str],
    binning_edges: Sequence[np.ndarray],
    binning_vars: Sequence[str],
    n_total_params: int,
    norm_idx: np.ndarray | None = None,
    spline_table=None,
    tf1_table: TF1Table | None = None,
    osc: OscConfig | AtmoOscConfig | None = None,
    shifts: Sequence[ShiftSpec] = (),
    weight_fns: Sequence[WeightSpec] = (),
    data: np.ndarray | None = None,
    test_statistic: TestStatistic = TestStatistic.BARLOW_BEESTON,
    use_kernel: bool | str = "auto",
    binning: SampleBinning | NonUniformBinning | None = None,
    stat_dtype=None,
) -> SampleModel:
    """Assemble the static SampleModel tensors on the CPU (the builders of
    ``tutorial/`` and ``samples/experiment.py`` move the model to the card).

    var_order fixes the row layout of the kinematics matrix; binning_vars
    and ``ShiftSpec.var_row`` refer to its rows. ``binning`` (a prebuilt
    ``NonUniformBinning`` or ``SampleBinning``, its axis_vars rows of
    var_order) replaces the rectangular binning of ``binning_edges``.
    Each ``WeightSpec`` carries its event mask [E]. use_kernel: ``"auto"`` /
    ``True`` route to a kernel where one fits, ``False`` forces the plain
    route (``routing.choose_kernel_route``)."""
    var_index = {v: i for i, v in enumerate(var_order)}
    kin = np.stack([np.asarray(events.kinematics[v], np.float32) for v in var_order])
    if binning is None:
        binning = SampleBinning.build(binning_edges, [int(var_index[v]) for v in binning_vars])

    if norm_idx is None:
        norm_idx = np.full((events.n_events, 1), -1, np.int64)
    # Map pad (-1) to the unit slot (= n_total_params, appended 1.0).
    norm_idx = np.where(norm_idx < 0, n_total_params, norm_idx)

    # Compress the extended-vector axis to the norm params that match THIS
    # sample: [*, NP+1] norm structures become [*, NA+1], and norm_applied
    # keeps their global indices for the per-chain take.
    applied = np.unique(norm_idx)
    applied = applied[applied < n_total_params]
    norm_applied = None
    if len(applied) + 1 < n_total_params + 1:
        remap = np.full(n_total_params + 1, len(applied), np.int64)
        remap[applied] = np.arange(len(applied))
        norm_idx = remap[norm_idx]
        norm_applied = applied
    na1 = (len(applied) + 1) if norm_applied is not None else n_total_params + 1

    # Match-count matrix S [NA+1, E] for the in-kernel norm product, when it
    # is cheap (S[na, e] = #slots of event e matched to applied param na).
    norm_s = None
    if na1 * events.n_events * 4 <= 512 << 20:
        norm_s = np.zeros((na1, events.n_events), np.float32)
        for w_col in range(norm_idx.shape[1]):
            np.add.at(norm_s, (norm_idx[:, w_col], np.arange(events.n_events)), 1.0)

    weight_mask = None
    if weight_fns:
        weight_mask = np.stack([np.asarray(w.mask, bool) for w in weight_fns])
    arrays = dict(kin=kin, mc_weight=np.asarray(events.mc_weight, np.float32),
                  norm_idx=norm_idx, norm_s=norm_s, spline_table=spline_table, osc=osc,
                  tf1_table=tf1_table, weight_mask=weight_mask)
    return assemble_sample(
        name, arrays, binning, shifts=tuple(shifts), weight_fns=tuple(weight_fns),
        norm_applied=norm_applied, data=data, test_statistic=test_statistic,
        stat_dtype=stat_dtype, use_kernel=use_kernel)


def _binning_axes(binning) -> tuple[list, np.ndarray | None]:
    """([(edges [n + 1] f32, n, stride)] per axis, cell -> bin map or None):
    the axes of the flat index of a rectangular binning (its bins) or of a
    hyper-rectangle one (its refined cells, and their map to bins)."""
    if isinstance(binning, NonUniformBinning):
        axes = [(binning.cell_edges[a, :n + 1].numpy(), n, binning.cell_strides[a])
                for a, n in enumerate(binning.n_cells_axis)]
        return axes, binning.cell_to_bin.numpy()
    return [(binning.axis_edges(a).numpy(), n, binning.strides[a])
            for a, n in enumerate(binning.n_bins_axis)], None


def _static_part(axes: list, rows: list, kin: np.ndarray, moved) -> np.ndarray:
    """[E] int32: Σ stride·idx over the axes not in ``moved``, with idx the
    nominal value's axis bin (f32 edges and values, as the plain binning
    compares), -1 where one of them is out of range."""
    static_base = np.zeros(kin.shape[1], np.int64)
    valid = np.ones(kin.shape[1], bool)
    for a, (edges, n_a, stride) in enumerate(axes):
        if a in moved:
            continue
        idx = np.searchsorted(edges, kin[rows[a]], side="right") - 1
        valid &= (idx >= 0) & (idx < n_a)
        static_base += np.clip(idx, 0, n_a - 1) * stride
    return np.where(valid, static_base, -1).astype(np.int32)


def _bin_map(name: str, shifted_binned: list, binning, kin: np.ndarray):
    """(:class:`BinMap`, static base [E]) of a sample whose binned axes only
    shifts of named kinds move, or None (with the reason logged): a shift
    that is torch code, or a map past the kernels' limits."""
    rows = list(binning.axis_vars)
    unnamed = [s for s in shifted_binned if s.kind not in SHIFT_KINDS]
    axes, cells = _binning_axes(binning)
    moved = sorted({rows.index(s.var_row) for s in shifted_binned})
    order = [s for a in moved for s in shifted_binned if rows.index(s.var_row) == a]
    why = None
    if unnamed:
        why = f"{len(unnamed)} shift(s) of no kernel kind"
    elif len(moved) > MAX_MAP_AXES or len(order) > MAX_MAP_SHIFTS:
        why = f"{len(moved)} shifted axes, {len(order)} shifts"
    elif any(len(axes[a][0]) > MAX_EDGES for a in moved):
        why = f"an axis of more than {MAX_EDGES} edges"
    elif cells is not None and len(cells) > MAX_MAP_CELLS:
        why = f"{len(cells)} cells > {MAX_MAP_CELLS}"
    if why is not None:
        _log.info("%s: per-chain bins given to the kernel as input (%s)", name, why)
        return None
    pitch = max(len(axes[a][0]) for a in moved)
    edges = np.full((len(moved), pitch), np.inf, np.float32)
    for i, a in enumerate(moved):
        edges[i, :len(axes[a][0])] = axes[a][0]
    bin_map = BinMap(
        edges, cells, [s.param_index for s in order],
        [(rows[a], len(axes[a][0]), axes[a][2]) for a in moved],
        [(moved.index(rows.index(s.var_row)), s.kind) for s in order])
    return bin_map, _static_part(axes, rows, kin, set(moved))


def _shift_bins(name: str, shifts, binning, kin: np.ndarray) -> tuple:
    """The bin map of a sample: (static_bins [E], None, None, None, None)
    when no shift moves a binned axis; (None, kernel_shift,
    shift_static_base [E], shift_edges, None) for exactly one shift of a
    kind the kernel knows on one axis of a rectangular binning (that axis is
    binned in the kernel, the others' summed contribution is precomputed
    here, -1 where one is out of range); else per-chain bins, the generic
    route: (None, None, shift_static_base [E], None, bin_map) when every
    shift of a binned axis is of a named kind (:func:`_bin_map`), all None
    when the kernel takes the bins as input."""
    binned_rows = list(binning.axis_vars)
    shifted_binned = [s for s in shifts if s.var_row in binned_rows]
    if not shifted_binned:
        return binning.find_bins(torch.from_numpy(kin)).numpy(), None, None, None, None
    if not (isinstance(binning, SampleBinning) and len(shifts) == 1
            and shifts[0].kind in SHIFT_KINDS):
        found = _bin_map(name, shifted_binned, binning, kin)
        if found is None:
            return None, None, None, None, None
        return None, None, found[1], None, found[0]
    s = shifts[0]
    axis_j = binned_rows.index(s.var_row)
    axes, _ = _binning_axes(binning)
    kernel_shift = (s.kind, int(s.param_index), binning.strides[axis_j],
                    binning.n_bins_axis[axis_j])
    return (None, kernel_shift, _static_part(axes, binned_rows, kin, {axis_j}),
            binning.axis_edges(axis_j), None)


def _map_fits(name: str, arrays: dict, bin_map: BinMap, n_bins: int) -> bool:
    """Whether both histogram forms of the per-chain kernel hold this bin
    map with the sample's table and norm slots in a block's shared memory;
    logs the choice either way."""
    table, norm_s = arrays["spline_table"], arrays.get("norm_s")
    n_cells = 0 if bin_map.cell_to_bin is None else bin_map.cell_to_bin.shape[0]
    floats = bin_map_floats(len(bin_map.axes), bin_map.edges.shape[1], len(bin_map.shifts),
                            n_cells)
    need = perchain_smem(table.coeffs, 0 if norm_s is None else norm_s.shape[0],
                         perchain_smem_bytes(n_bins, floats, given=False, det=True))
    if need > MAX_SMEM:
        _log.info("%s: per-chain bins given to the kernel as input (a block would need %d bytes "
                  "of shared memory for the bin map)", name, need)
        return False
    _log.info("%s: per-chain bins formed in the kernel from a bin map: %d shifted axes, %d "
              "named shifts%s", name, len(bin_map.axes), len(bin_map.shifts),
              f", {n_cells} cells" if n_cells else "")
    return True


def assemble_sample(
    name: str,
    arrays: dict,
    binning: SampleBinning | NonUniformBinning,
    *,
    shifts: tuple = (),
    weight_fns: tuple = (),
    norm_applied=None,
    data=None,
    test_statistic: TestStatistic = TestStatistic.BARLOW_BEESTON,
    stat_dtype=None,
    use_kernel: bool | str = "auto",
) -> SampleModel:
    """The :class:`SampleModel` of prepared host arrays (``arrays``: numpy
    ``kin``, ``mc_weight``, ``norm_idx``, ``norm_s``, ``weight_mask``, and
    the ``spline_table``, ``osc`` and ``tf1_table`` modules) under
    ``binning``: its bin map (:func:`_shift_bins`), its kernel route and, on
    the shared, shifted and generic routes, its event layout and plan (``event_perm``
    and ``event_pad`` of an earlier layout may ride in ``arrays``).
    ``build_sample_model`` and ``SampleModel.with_binning`` end here."""
    static_bins, kernel_shift, shift_static_base, shift_edges, bin_map = _shift_bins(
        name, shifts, binning, np.asarray(arrays["kin"]))
    route = choose_kernel_route(
        binning.n_bins,
        arrays["spline_table"],
        has_static_bins=static_bins is not None,
        has_kernel_shift=kernel_shift is not None,
        requested=use_kernel,
    )
    if bin_map is not None and not (route.use_kernel and route.variant == "generic"
                                    and _map_fits(name, arrays, bin_map, binning.n_bins)):
        bin_map = shift_static_base = None
    arrays = dict(arrays, static_bins=static_bins, shift_static_base=shift_static_base)
    if route.use_kernel and route.variant == "shared":
        arrays = apply_shared_layout(name, arrays, binning.n_bins)
    elif route.use_kernel and route.variant in ("shifted", "generic"):
        arrays = apply_shifted_layout(name, arrays)
    return SampleModel(
        name,
        binning=binning,
        data=np.zeros(binning.n_bins) if data is None else data,
        norm_applied=norm_applied,
        shifts=shifts,
        weight_fns=weight_fns,
        test_statistic=test_statistic,
        stat_dtype=stat_dtype,
        kernel_route=route,
        kernel_shift=kernel_shift,
        shift_edges=shift_edges,
        bin_map=bin_map,
        **arrays,
    )
