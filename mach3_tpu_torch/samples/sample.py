"""The binned-sample likelihood (port of ``mach3_tpu/samples/sample.py``).

``SampleHandlerFD`` (``Samples/SampleHandlerFD.cpp:316-448,1284-1300``) as
one function of a chain batch of proposed parameter vectors [C, NP]:

    base weight = MC weight x oscillation weight (x norm product)
                  x TF1 responses x weight-valued functional responses
    -> spline response product, binning, Σw/Σw² histogram
    -> per-bin test statistic summed in f64.

On the ``shifted``, ``shared`` and ``generic`` routes the middle line is a
fused CUDA kernel (``splines/reweight.py``: in-kernel binning of one shifted
axis, static bins, or per-chain bins — formed in the kernel from a
:class:`BinMap` when every shift of a binned axis is a named kind, else
computed here as plain torch ops, as for polygon bins); the ``xla`` route
(a sparse spline table's, as in the JAX package) and the unbatched
``reweight`` run it as plain torch ops.
Static arrays are registered buffers, so ``SampleModel.to(device)`` moves a
sample.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable

import torch
from torch import nn

from ..core import tracing
from ..core.device import take
from ..core.precision import ATYPE, FTYPE
from ..osc.layered import count_fallback, kernel_takes, layered_grids
from ..osc.prob import (
    OscParams,
    probabilities_const_density,
    probabilities_layered,
    z_group_order,
)
from ..splines.eval import eval_table, find_segments
from ..splines.grad import (
    fused_reweight_diff,
    fused_reweight_diff_perchain,
    fused_reweight_diff_shifted,
)
from ..splines.reweight import (
    SHIFT_KINDS,
    PerchainBins,
    fused_reweight_histogram,
    fused_reweight_histogram_shared,
    fused_reweight_histogram_shifted,
)
from .binning import NonUniformBinning, PolygonBinning, SampleBinning, histogram
from .gather import event_gather, norm_product
from .routing import KernelRoute
from .teststats import TestStatistic, get_test_stat_fn

#: A functional shift: (param_value [C, 1], var_values [C, E], kin [C, V, E])
#: -> new var values.
ShiftFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]
#: A weight-valued functional response: (param_value [C, 1], nominal kin
#: [V, E]) -> weight [C, E].
WeightFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class NamedShiftFn:
    """The plain torch form of a named shift kind, as a ``ShiftFn``; an
    object, not a closure, so that a built model pickles
    (``core/fixture_cache.py``)."""

    kind: str

    def __call__(self, value: torch.Tensor, x: torch.Tensor, kin: torch.Tensor) -> torch.Tensor:
        return SHIFT_KINDS[self.kind][1](value, x)


@dataclasses.dataclass(frozen=True)
class ShiftSpec:
    """One functional parameter applied to one kinematic variable.

    ``kind`` names a shift the shifted kernel forms itself
    (``splines/reweight.SHIFT_KINDS``), or is None for a shift known only by
    its torch body (``samples/experiment.register_shift``); ``fn`` is the
    plain torch form. A sample whose single binned-axis shift has no kind
    takes the ``generic`` route (per-chain bins computed with ``fn``)."""

    kind: str | None
    fn: ShiftFn
    param_index: int
    var_row: int

    @classmethod
    def named(cls, kind: str, param_index: int, var_row: int) -> "ShiftSpec":
        """The shift of kind ``kind`` (a key of ``SHIFT_KINDS``)."""
        if kind not in SHIFT_KINDS:
            raise KeyError(f"no shift kind {kind!r} (kinds: {sorted(SHIFT_KINDS)})")
        return cls(kind, NamedShiftFn(kind), param_index, var_row)

    @classmethod
    def scale(cls, param_index: int, var_row: int) -> "ShiftSpec":
        """The energy-scale shift ``x * (1 + v)``."""
        return cls.named("scale", param_index, var_row)


@dataclasses.dataclass(frozen=True)
class WeightSpec:
    """One weight-valued functional parameter (the weight half of the
    reference's ``FuncParFuncType`` callbacks, ``SampleHandlerFD.cpp:465-564``):
    ``fn(value, kin)`` multiplies the weight of the events of ``mask`` [E]
    bool. ``kin`` is the nominal kinematics (weights see unshifted values).
    A :class:`SampleModel` keeps the masks in its ``weight_mask`` buffer,
    where they move and are laid out with the events."""

    fn: WeightFn
    param_index: int
    mask: Any = None


class OscConfig(nn.Module):
    """Per-sample beam oscillation setup (constant density).

    Buffers: e_grid [NE] f64, event_grid_idx / event_channel [E], chan_alpha /
    chan_beta [NC] (flavour 0=e, 1=mu, 2=tau), chan_anti [NC] bool, nc_mask
    [E] bool (NC events get unit weight), osc_param_idx [6] into θ."""

    def __init__(self, e_grid, event_grid_idx, event_channel, chan_alpha, chan_beta,
                 chan_anti, nc_mask, osc_param_idx, *, baseline: float, density: float,
                 electron_fraction: float = 0.5, dtype=FTYPE, phase_dtype=ATYPE):
        super().__init__()
        long = torch.long
        self.register_buffer("e_grid", torch.as_tensor(e_grid, dtype=ATYPE))
        self.register_buffer("event_grid_idx", torch.as_tensor(event_grid_idx, dtype=long))
        self.register_buffer("event_channel", torch.as_tensor(event_channel, dtype=long))
        self.register_buffer("chan_alpha", torch.as_tensor(chan_alpha, dtype=long))
        self.register_buffer("chan_beta", torch.as_tensor(chan_beta, dtype=long))
        # (alpha, beta) as one index into a flattened 3 x 3 probability matrix.
        self.register_buffer("chan_flat", self.chan_alpha * 3 + self.chan_beta, persistent=False)
        self.register_buffer("chan_anti", torch.as_tensor(chan_anti, dtype=torch.bool))
        self.register_buffer("nc_mask", torch.as_tensor(nc_mask, dtype=torch.bool))
        self.register_buffer("osc_param_idx", torch.as_tensor(osc_param_idx, dtype=long))
        # One flat gather index into the [NC * NE] channel table.
        self.register_buffer(
            "flat_idx", self.event_channel * self.e_grid.shape[0] + self.event_grid_idx,
            persistent=False,
        )
        self.baseline = float(baseline)
        self.density = float(density)
        self.electron_fraction = float(electron_fraction)
        self.dtype = dtype
        self.phase_dtype = phase_dtype

    def prob_grids(self, thetas: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(nu, antinu) probability grids [C, NE, 3, 3] — shareable between
        samples with equal (grid, baseline, density) (``share_signature``)."""
        pars = OscParams.from_array(take(thetas, 1, self.osc_param_idx).to(ATYPE))
        kw = dict(length=self.baseline, rho=self.density, ye=self.electron_fraction,
                  dtype=self.dtype, phase_dtype=self.phase_dtype)
        p_nu = probabilities_const_density(pars, self.e_grid, antineutrino=False, **kw)
        p_bar = probabilities_const_density(pars, self.e_grid, antineutrino=True, **kw)
        return p_nu, p_bar

    def chan_table(self, thetas: torch.Tensor, grids: tuple | None = None) -> torch.Tensor:
        """Per-channel probability rows [C, NC, NE]."""
        p_nu, p_bar = self.prob_grids(thetas) if grids is None else grids
        chan_nu = take(p_nu.flatten(-2), -1, self.chan_flat).transpose(-1, -2)
        chan_bar = take(p_bar.flatten(-2), -1, self.chan_flat).transpose(-1, -2)
        return torch.where(self.chan_anti[:, None], chan_bar, chan_nu)

    def weights(self, thetas: torch.Tensor, grids: tuple | None = None) -> torch.Tensor:
        """Per-event oscillation weights [C, E] f32 (one flat gather)."""
        chan = self.chan_table(thetas, grids)
        # The table in f32 before the gather (the same values as after it):
        # the gathers' backward kernel sums f32.
        w = event_gather(chan.reshape(chan.shape[0], -1).to(FTYPE), self.flat_idx)
        return torch.where(self.nc_mask, 1.0, w)

    def event_sort_key(self) -> torch.Tensor:
        """[E] flat (channel, energy) gather index: the secondary sort key of
        the shared route's event layout (``splines/plan.py``)."""
        return self.flat_idx

    def take_events(self, perm) -> "OscConfig":
        """The same config for the events ``perm`` (a reorder and/or copies)."""
        perm = torch.as_tensor(perm, dtype=torch.long)
        return OscConfig(
            self.e_grid, self.event_grid_idx[perm], self.event_channel[perm],
            self.chan_alpha, self.chan_beta, self.chan_anti, self.nc_mask[perm],
            self.osc_param_idx, baseline=self.baseline, density=self.density,
            electron_fraction=self.electron_fraction, dtype=self.dtype,
            phase_dtype=self.phase_dtype,
        )

    def share_signature(self) -> tuple:
        """Host-side key: configs with equal keys produce identical grids."""
        return (
            "beam",
            self.e_grid.cpu().numpy().tobytes(),
            self.osc_param_idx.cpu().numpy().tobytes(),
            self.baseline,
            self.density,
            self.electron_fraction,
            str(self.dtype),
            str(self.phase_dtype),
        )


class AtmoOscConfig(nn.Module):
    """Atmospheric oscillation: probabilities on an (E, cosZ) grid through a
    layered earth (the reference's CUDAProb3 road; paths from ``osc/prem.py``).
    Events gather by the flat (channel, zenith, energy) index.

    Buffers: e_grid [NE], layer_lengths / layer_rho [NZ, NL] f64 (a leading
    [H] axis with production-height averaging; rho is the Ye-folded
    effective density), rho_unique [NR] and rho_idx (the eigensystem runs
    once per unique density), event_flat_idx [E] = (chan * NZ + z) * NE + e,
    chan_alpha / chan_beta / chan_anti [NC], nc_mask [E], osc_param_idx [6],
    height_weights [H] or None. ``z_groups`` is the static zenith partition
    of :func:`~mach3_tpu_torch.osc.prob.probabilities_layered`, and the
    buffers z_order / z_inverse [NZ] (or None) its index tensors."""

    def __init__(self, e_grid, layer_lengths, layer_rho, event_flat_idx, chan_alpha,
                 chan_beta, chan_anti, nc_mask, osc_param_idx, *, rho_unique, rho_idx,
                 height_weights=None, z_groups: tuple | None = None, dtype=FTYPE):
        super().__init__()
        long = torch.long
        self.register_buffer("e_grid", torch.as_tensor(e_grid, dtype=ATYPE))
        self.register_buffer("layer_lengths", torch.as_tensor(layer_lengths, dtype=ATYPE))
        self.register_buffer("layer_rho", torch.as_tensor(layer_rho, dtype=ATYPE))
        self.register_buffer("rho_unique", torch.as_tensor(rho_unique, dtype=ATYPE))
        self.register_buffer("rho_idx", torch.as_tensor(rho_idx, dtype=long))
        self.register_buffer("event_flat_idx", torch.as_tensor(event_flat_idx, dtype=long))
        self.register_buffer("chan_alpha", torch.as_tensor(chan_alpha, dtype=long))
        self.register_buffer("chan_beta", torch.as_tensor(chan_beta, dtype=long))
        # (alpha, beta) as one index into a flattened 3 x 3 probability matrix.
        self.register_buffer("chan_flat", self.chan_alpha * 3 + self.chan_beta, persistent=False)
        self.register_buffer("chan_anti", torch.as_tensor(chan_anti, dtype=torch.bool))
        self.register_buffer("nc_mask", torch.as_tensor(nc_mask, dtype=torch.bool))
        self.register_buffer("osc_param_idx", torch.as_tensor(osc_param_idx, dtype=long))
        self.register_buffer("height_weights", _buffer(height_weights, ATYPE))
        self.z_groups = None if z_groups is None else tuple(
            (tuple(int(i) for i in idxs), int(nl)) for idxs, nl in z_groups
        )
        order = (None, None) if z_groups is None else z_group_order(self.z_groups)
        self.register_buffer("z_order", _buffer(order[0], long))
        self.register_buffer("z_inverse", _buffer(order[1], long))
        self.dtype = dtype

    def prob_grids(self, thetas: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(nu, antinu) probability grids [C, NZ, NE, 3, 3], averaged over
        the production heights when there are several; shareable between
        samples with equal ``share_signature``. Both from one launch of the
        kernel where ``osc/layered.py``'s ``kernel_takes`` says so, else each
        from the plain path."""
        pars = OscParams.from_array(take(thetas, 1, self.osc_param_idx).to(ATYPE))
        if kernel_takes(pars.dm31_sq, self.dtype):
            grids = layered_grids(pars, self.e_grid, self.layer_lengths, self.rho_idx,
                                  self.rho_unique).unbind(0)
        else:
            count_fallback(pars.dm31_sq)
            grids = [probabilities_layered(
                pars, self.e_grid, self.layer_lengths, self.layer_rho,
                antineutrino=antineutrino, dtype=self.dtype,
                rho_unique=self.rho_unique, rho_idx=self.rho_idx, z_groups=self.z_groups,
                z_order=self.z_order, z_inverse=self.z_inverse,
            ) for antineutrino in (False, True)]
        if self.height_weights is not None:  # p [C, H, NZ, NE, 3, 3]
            w = self.height_weights.to(grids[0].dtype)
            grids = [(w[:, None, None, None, None] * p).sum(1) for p in grids]
        return grids[0], grids[1]

    def chan_table(self, thetas: torch.Tensor, grids: tuple | None = None) -> torch.Tensor:
        """Flat per-channel table [C, NC * NZ * NE]."""
        p_nu, p_bar = self.prob_grids(thetas) if grids is None else grids
        chan_nu = take(p_nu.flatten(-2), -1, self.chan_flat)  # [C, NZ, NE, NC]
        chan_bar = take(p_bar.flatten(-2), -1, self.chan_flat)
        chan = torch.where(self.chan_anti, chan_bar, chan_nu)
        return chan.movedim(-1, 1).reshape(chan.shape[0], -1)

    def weights(self, thetas: torch.Tensor, grids: tuple | None = None) -> torch.Tensor:
        """Per-event oscillation weights [C, E] f32 (one flat gather)."""
        w = event_gather(self.chan_table(thetas, grids).to(FTYPE), self.event_flat_idx)
        return torch.where(self.nc_mask, 1.0, w)

    def event_sort_key(self) -> torch.Tensor:
        return self.event_flat_idx

    def take_events(self, perm) -> "AtmoOscConfig":
        """The same config for the events ``perm`` (a reorder and/or copies)."""
        perm = torch.as_tensor(perm, dtype=torch.long)
        return AtmoOscConfig(
            self.e_grid, self.layer_lengths, self.layer_rho, self.event_flat_idx[perm],
            self.chan_alpha, self.chan_beta, self.chan_anti, self.nc_mask[perm],
            self.osc_param_idx, rho_unique=self.rho_unique, rho_idx=self.rho_idx,
            height_weights=self.height_weights, z_groups=self.z_groups, dtype=self.dtype,
        )

    def share_signature(self) -> tuple:
        """Host-side key: configs with equal keys produce identical grids."""
        return (
            "atmo",
            self.e_grid.cpu().numpy().tobytes(),
            self.layer_lengths.cpu().numpy().tobytes(),
            self.layer_rho.cpu().numpy().tobytes(),
            self.osc_param_idx.cpu().numpy().tobytes(),
            None if self.height_weights is None else self.height_weights.cpu().numpy().tobytes(),
            self.z_groups,
            str(self.dtype),
        )


def _buffer(x, dtype):
    return None if x is None else torch.as_tensor(x, dtype=dtype).contiguous()


class BinMap(nn.Module):
    """The per-chain binning of a generic-route sample whose binned axes are
    moved by named shifts only, as the kernels evaluate it
    (``reweight.PerchainBins``, ``csrc/spline_response.cuh`` ``perchain_bin``):
    the moved axes, each with its kinematic row, edges and stride in the
    flat index, and the shifts on them grouped by axis (an axis's in the
    order the sample applies them; shifts of different axes commute).

    Buffers: ``edges`` [NA, K] f32 padded with +inf, ``cell_to_bin``
    [n_cells] i32 (a hyper-rectangle binning's cell -> bin, ``n_bins`` for a
    gap) or None, ``param_index`` [NSH] i64 (each shift's parameter). On the
    host: ``axes`` ((kin row, n_edges, stride), ...) and ``shifts`` ((axis,
    kind), ...). The part of the flat index that the other axes give is the
    sample's ``shift_static_base``, laid out with its events."""

    def __init__(self, edges, cell_to_bin, param_index, axes, shifts):
        super().__init__()
        self.register_buffer("edges", _buffer(edges, FTYPE))
        self.register_buffer("cell_to_bin", _buffer(cell_to_bin, torch.int32))
        self.register_buffer("param_index", _buffer(param_index, torch.long))
        self.axes = tuple(tuple(int(v) for v in ax) for ax in axes)
        self.shifts = tuple((int(a), str(kind)) for a, kind in shifts)

    def bins(self, thetas: torch.Tensor, kin: torch.Tensor,
             static_base: torch.Tensor) -> PerchainBins:
        """The map at a chain batch: each shift's value rounded to f32, as
        ``SampleModel._shifted_kinematics`` takes it (no gradient: bins are
        piecewise constant in θ)."""
        vals = thetas.detach().index_select(1, self.param_index).to(FTYPE).contiguous()
        return PerchainBins(vals, kin, static_base, self.edges, self.cell_to_bin, self.axes,
                            self.shifts)


class SampleModel(nn.Module):
    """Static arrays + config of one binned sample.

    Buffers: kin [V, E] f32, mc_weight [E] f32, norm_idx [E, Wn] into the
    (compressed) extended norm vector, data [B] f64, and optionally norm_s
    [NA+1, E] f32 (match counts of the in-kernel norm product), norm_applied
    [NA] (global indices of the sample's norm params), static_bins [E]
    (bins that no shift moves), shift_static_base [E] i32 (the part of the
    flat bin index that the axes no shift moves give, -1 where one is out of
    range: the shifted route's and a bin map's), shift_edges [n_axis + 1] f32
    (the shifted route's shifted-axis edges), weight_mask [Nw, E] bool (the
    events of each weight function). ``kernel_shift`` = (kind, param_index,
    stride, n_axis); ``bin_map`` a :class:`BinMap` (a generic-route sample
    whose binned axes only named shifts move) or None; ``tf1_table`` a
    :class:`~mach3_tpu_torch.splines.tf1.TF1Table`.

    On the shared, shifted and generic routes the events are laid out by
    ``splines/plan.py`` and the kernel's per-tile plan is kept as
    hist_plan_ptr [T + 1] / hist_plan_idx [nnz] i32 (CSR lists of each event
    tile's active spline params) and, on the shared route, hist_tile_start /
    hist_tile_width [T] i32 (the histogram window of each tile) and
    ``hist_nbl`` (the widest window, in bins). event_perm [E] i64 (each
    event's index before the layout) and event_pad [E] bool (zero-weight
    copies that fill a tile) say where a laid-out sample's events came from."""

    def __init__(
        self,
        name: str,
        kin,
        mc_weight,
        norm_idx,
        binning: SampleBinning,
        data,
        *,
        norm_s=None,
        norm_applied=None,
        spline_table=None,
        osc: OscConfig | AtmoOscConfig | None = None,
        shifts: tuple[ShiftSpec, ...] = (),
        test_statistic: TestStatistic = TestStatistic.BARLOW_BEESTON,
        stat_dtype: Any = None,
        kernel_route: KernelRoute | None = None,
        static_bins=None,
        kernel_shift: tuple | None = None,
        shift_static_base=None,
        shift_edges=None,
        tf1_table=None,
        weight_fns: tuple[WeightSpec, ...] = (),
        weight_mask=None,
        hist_tile_start=None,
        hist_tile_width=None,
        hist_plan_ptr=None,
        hist_plan_idx=None,
        hist_nbl: int | None = None,
        event_perm=None,
        event_pad=None,
        bin_map: BinMap | None = None,
    ):
        super().__init__()
        if (weight_mask is None) != (not weight_fns):
            raise ValueError("weight_fns and weight_mask come together or not at all")
        self.name = name
        self.register_buffer("kin", _buffer(kin, FTYPE))
        self.register_buffer("mc_weight", _buffer(mc_weight, FTYPE))
        self.register_buffer("norm_idx", _buffer(norm_idx, torch.long))
        self.register_buffer("data", _buffer(data, ATYPE))
        self.register_buffer("norm_s", _buffer(norm_s, FTYPE))
        self.register_buffer("norm_applied", _buffer(norm_applied, torch.long))
        self.register_buffer("static_bins", _buffer(static_bins, torch.int32))
        self.register_buffer("shift_static_base", _buffer(shift_static_base, torch.int32))
        self.register_buffer("shift_edges", _buffer(shift_edges, FTYPE))
        self.register_buffer("hist_tile_start", _buffer(hist_tile_start, torch.int32))
        self.register_buffer("hist_tile_width", _buffer(hist_tile_width, torch.int32))
        self.register_buffer("hist_plan_ptr", _buffer(hist_plan_ptr, torch.int32))
        self.register_buffer("hist_plan_idx", _buffer(hist_plan_idx, torch.int32))
        self.register_buffer("weight_mask", _buffer(weight_mask, torch.bool))
        self.register_buffer("event_perm", _buffer(event_perm, torch.long))
        self.register_buffer("event_pad", _buffer(event_pad, torch.bool))
        self.hist_nbl = hist_nbl
        self.binning = binning
        self.spline_table = spline_table
        self.tf1_table = tf1_table
        self.osc = osc
        self.shifts = tuple(shifts)
        self.weight_fns = tuple(dataclasses.replace(w, mask=None) for w in weight_fns)
        self.test_statistic = test_statistic
        self.stat_dtype = stat_dtype
        self.kernel_route = kernel_route or KernelRoute(False, "xla", reason="no route")
        self.kernel_shift = kernel_shift
        self.bin_map = bin_map
        #: The generic route's histogram form: ``"maskreduce"`` (K5) or
        #: ``"blockdiag"`` (K5b, the same sums in a fixed order).
        self.perchain_hist = "maskreduce"

    @property
    def n_events(self) -> int:
        return self.kin.shape[1]

    @property
    def n_bins(self) -> int:
        return self.binning.n_bins

    # ------------------------------------------------------------ weights
    def _norm_ext_batch(self, thetas: torch.Tensor) -> torch.Tensor:
        """[C, NP] -> [C, NA+1] f32: the sample's applied norm params plus
        the literal 1.0 unit slot that padding indexes."""
        t = thetas if self.norm_applied is None else take(thetas, 1, self.norm_applied)
        ones = torch.ones((t.shape[0], 1), dtype=FTYPE, device=t.device)
        return torch.cat([t.to(FTYPE), ones], dim=1)

    def _norm_weights(self, thetas: torch.Tensor) -> torch.Tensor:
        """[C, E] product of each event's matched norm values (exact zero for
        a zero norm; the reference's ``norm_pointers`` product): an
        ``index_select`` and a product forward, the gathers' kernel backward
        (``samples/gather.py``)."""
        return norm_product(self._norm_ext_batch(thetas), self.norm_idx)

    def _osc_weights(self, thetas: torch.Tensor, osc_grids: tuple | None = None) -> torch.Tensor:
        """[C, E] f32; ``osc_grids`` injects (nu, antinu) grids shared across
        samples (``OscillationHandler.cpp:18-35``)."""
        if self.osc is None:
            return torch.ones((thetas.shape[0], self.n_events), dtype=FTYPE, device=thetas.device)
        return self.osc.weights(thetas, osc_grids)

    def _func_weights(self, thetas: torch.Tensor) -> torch.Tensor | None:
        """[C, E] product of the weight-valued functional responses on their
        matched events, or None without any (JAX ``_func_weights``)."""
        w = None
        for i, ws in enumerate(self.weight_fns):
            wf = ws.fn(thetas[:, ws.param_index, None], self.kin).to(FTYPE)
            wf = torch.where(self.weight_mask[i], wf, 1.0)
            w = wf if w is None else w * wf
        return w

    def _functional_weights(self, w: torch.Tensor, thetas: torch.Tensor) -> torch.Tensor:
        """``w`` [C, E] times the TF1 and weight-function responses."""
        if self.tf1_table is not None:
            w = w * self.tf1_table.eval(thetas)
        fw = self._func_weights(thetas)
        return w if fw is None else w * fw

    def _base_weight(self, thetas: torch.Tensor, osc_grids_batch: tuple | None,
                     norm: bool) -> torch.Tensor:
        """The kernels' base weight [C, E]: MC weight x oscillation (x the
        norm product when ``norm``; the shifted and shared kernels form it
        themselves on the sampling path) x TF1 x weight functions."""
        w = self.mc_weight * self._osc_weights(thetas, osc_grids_batch)
        if norm:
            w = w * self._norm_weights(thetas)
        return self._functional_weights(w, thetas)

    def _shifted_kinematics(self, thetas: torch.Tensor) -> torch.Tensor:
        """[C, V, E] kinematics after the functional shifts. The parameter
        value is rounded to f32 first, as the kernel takes it, so both routes
        put an event near an edge in the same bin (the JAX XLA route shifts
        with the f64 value and can differ from its kernel by one ulp)."""
        kin = self.kin.expand((thetas.shape[0],) + self.kin.shape)
        if self.shifts:
            kin = kin.clone()
            for s in self.shifts:
                value = thetas[:, s.param_index, None].to(FTYPE)
                shifted = s.fn(value, kin[:, s.var_row], kin)
                kin[:, s.var_row] = shifted.to(FTYPE)
        return kin

    def event_weights(
        self, thetas: torch.Tensor, osc_grids: tuple | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-event (weight [C, E], bin [C, E]) before the histogram fill."""
        w = self.mc_weight * self._norm_weights(thetas)
        if self.spline_table is not None:
            w = w * eval_table(self.spline_table, thetas)
        w = self._functional_weights(w * self._osc_weights(thetas, osc_grids), thetas)
        if self.static_bins is not None:
            return w, self.static_bins.expand(w.shape)
        return w, self._perchain_bins(thetas)

    def _perchain_bins(self, thetas: torch.Tensor) -> torch.Tensor:
        """[C, E] bins of the shifted kinematics (int64; ``n_bins`` =
        garbage). Bins are integers, piecewise constant in θ: no gradient."""
        with torch.no_grad():
            return self.binning.find_bins(self._shifted_kinematics(thetas))

    # ---------------------------------------------------------- reweight
    def reweight(self, params: torch.Tensor, osc_grids: tuple | None = None):
        """Unbatched plain reweight: params [NP] -> (mc [B], w2 [B])."""
        grids = None if osc_grids is None else tuple(g[None] for g in osc_grids)
        mc, w2 = self.reweight_batch_plain(params[None], grids)
        return mc[0], w2[0]

    def reweight_batch_plain(self, thetas: torch.Tensor, osc_grids_batch: tuple | None = None):
        """Plain-torch batched reweight (the JAX package's XLA route): [C, NP]
        -> (mc [C, B], w2 [C, B]); the reference the kernel route is checked
        against."""
        w, bins = self.event_weights(thetas, osc_grids_batch)
        return histogram(w, bins, self.n_bins)

    def shifted_kernel_args(
        self, thetas: torch.Tensor, osc_grids_batch: tuple | None = None
    ) -> tuple[tuple, dict]:
        """Arguments of the shifted-route kernel call for a chain batch (the
        activity plan of a laid-out sample included)."""
        norm_in_kernel = self.norm_s is not None
        base_w = self._base_weight(thetas, osc_grids_batch, norm=not norm_in_kernel)
        table = self.spline_table
        seg, t = find_segments(table.knots_x, table.n_knots, take(thetas, 1, table.param_index))
        kind, param_index, stride_j, n_axis_j = self.kernel_shift
        args = (
            seg.contiguous(), t.contiguous(), table.coeffs, base_w.contiguous(),
            thetas[:, param_index].to(FTYPE).contiguous(),
            self.kin[self.shifts[0].var_row], self.shift_static_base, self.shift_edges,
        )
        kwargs = dict(n_bins=self.n_bins, shift_kind=kind, stride_j=stride_j, n_axis_j=n_axis_j,
                      plan_ptr=self.hist_plan_ptr, plan_idx=self.hist_plan_idx)
        if norm_in_kernel:
            kwargs.update(norm_ext=self._norm_ext_batch(thetas), norm_s=self.norm_s)
        return args, kwargs

    def shared_kernel_args(
        self, thetas: torch.Tensor, osc_grids_batch: tuple | None = None
    ) -> tuple[tuple, dict]:
        """Arguments of the shared-route kernel call for a chain batch."""
        base_w = self._base_weight(thetas, osc_grids_batch, norm=self.norm_s is None)
        table = self.spline_table
        seg, t = find_segments(table.knots_x, table.n_knots, take(thetas, 1, table.param_index))
        args = (seg.contiguous(), t.contiguous(), table.coeffs, base_w.contiguous(),
                self.static_bins)
        kwargs = dict(n_bins=self.n_bins, tile_start=self.hist_tile_start,
                      tile_width=self.hist_tile_width, plan_ptr=self.hist_plan_ptr,
                      plan_idx=self.hist_plan_idx, nbl=self.hist_nbl)
        if self.norm_s is not None:
            kwargs.update(norm_ext=self._norm_ext_batch(thetas), norm_s=self.norm_s)
        return args, kwargs

    def perchain_bins(self, thetas: torch.Tensor):
        """The generic route's bins at a chain batch, as its kernels take
        them: the sample's bin map (:class:`BinMap`), or, for a shift that
        is torch code, [C, E] int32 bins of the shifted kinematics by plain
        torch ops (the JAX package computes those in XLA)."""
        if self.bin_map is not None:
            return self.bin_map.bins(thetas, self.kin, self.shift_static_base)
        return self._perchain_bins(thetas).to(torch.int32).contiguous()

    def perchain_kernel_args(
        self, thetas: torch.Tensor, osc_grids_batch: tuple | None = None
    ) -> tuple[tuple, dict]:
        """Arguments of the generic-route kernel call for a chain batch: the
        bins of :meth:`perchain_bins`, the norm product in the kernel when
        the sample has its match counts (else in the base weight, as JAX
        ``sample.py:497-510`` has it), the activity plan of a laid-out
        sample."""
        norm_in_kernel = self.norm_s is not None
        base_w = self._base_weight(thetas, osc_grids_batch, norm=not norm_in_kernel)
        table = self.spline_table
        seg, t = find_segments(table.knots_x, table.n_knots, take(thetas, 1, table.param_index))
        kwargs = dict(n_bins=self.n_bins, hist=self.perchain_hist, plan_ptr=self.hist_plan_ptr,
                      plan_idx=self.hist_plan_idx)
        if norm_in_kernel:
            kwargs.update(norm_ext=self._norm_ext_batch(thetas), norm_s=self.norm_s)
        return (seg.contiguous(), t.contiguous(), table.coeffs, base_w.contiguous(),
                self.perchain_bins(thetas)), kwargs

    def reweight_batch(
        self, thetas: torch.Tensor, osc_grids_batch: tuple | None = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Chain-batched reweight on the sample's route: [C, NP] ->
        (mc [C, B], w2 [C, B])."""
        tracing.stamp("base")
        route = self.kernel_route
        if not route.use_kernel:
            return self.reweight_batch_plain(thetas, osc_grids_batch)
        if route.variant not in _FORWARD:
            raise NotImplementedError(f"{self.name}: no kernel route {route.variant!r}")
        make_args, kernel = _FORWARD[route.variant]
        args, kwargs = make_args(self, thetas, osc_grids_batch)
        tracing.stamp("reweight")
        return kernel(*args, **kwargs)

    def _diff_route(self) -> str | None:
        """The fused differentiable route — ``"shared"``, ``"shifted"`` or
        ``"generic"``, the route of the sample's forward kernel — or None for
        the plain route under autograd. The card has no VMEM limit, so every
        sample with a forward kernel takes it (the JAX package's VMEM guards
        do not apply)."""
        route = self.kernel_route
        if route.use_kernel and route.variant in _FORWARD:
            return route.variant
        return None

    def log_likelihood_batch_plain(
        self, thetas: torch.Tensor, osc_grids_batch: tuple | None = None
    ) -> torch.Tensor:
        """[C, NP] -> [C] -logL through plain torch ops (the JAX package's
        ``log_likelihood_batch_xla``): differentiable to any order."""
        return self._stat_sum(*self.reweight_batch_plain(thetas, osc_grids_batch))

    def diff_kernel_args(
        self, thetas: torch.Tensor, osc_grids_batch: tuple | None = None
    ) -> tuple[tuple, dict]:
        """Arguments of the sample's differentiable fused call
        (``fused_reweight_diff`` on the shared route,
        ``fused_reweight_diff_shifted`` on the shifted one,
        ``fused_reweight_diff_perchain`` on the generic one): the first four
        are (t, base_w, seg, coeffs), then the static bins (shared), the bins
        of :meth:`perchain_bins` (generic) or the shift arguments from which
        the forward and the backward kernel both bin in-kernel (shifted; the
        shift value rounded to f32, as the plain binning takes it). The base
        weight carries the norm product (the gather product, an exact 0 for
        a zero norm), TF1 and weight functions. The forward and the backward
        run under the sample's activity plan."""
        base_w = self._base_weight(thetas, osc_grids_batch, norm=True)
        table = self.spline_table
        seg, t = find_segments(table.knots_x, table.n_knots, take(thetas, 1, table.param_index))
        head = (t, base_w, seg, table.coeffs)
        route = self._diff_route()
        if route == "shared":
            return head + (self.static_bins,), dict(
                n_bins=self.n_bins, tile_start=self.hist_tile_start,
                tile_width=self.hist_tile_width, plan_ptr=self.hist_plan_ptr,
                plan_idx=self.hist_plan_idx, nbl=self.hist_nbl)
        if route == "generic":
            return head + (self.perchain_bins(thetas),), dict(
                n_bins=self.n_bins, plan_ptr=self.hist_plan_ptr, plan_idx=self.hist_plan_idx)
        kind, param_index, stride_j, n_axis_j = self.kernel_shift
        return head + (thetas[:, param_index].to(FTYPE), self.kin[self.shifts[0].var_row],
                       self.shift_static_base, self.shift_edges), dict(
            n_bins=self.n_bins, shift_kind=kind, stride_j=stride_j, n_axis_j=n_axis_j,
            plan_ptr=self.hist_plan_ptr, plan_idx=self.hist_plan_idx)

    def log_likelihood_batch_diff(
        self, thetas: torch.Tensor, osc_grids_batch: tuple | None = None
    ) -> torch.Tensor:
        """[C, NP] -> [C] -logL, differentiable through the fused kernels: the
        forward is the sample's reweight kernel with the norm product in the
        base weight, the backward the kernel of ``splines/grad.py``. A
        sample with no kernel route takes :meth:`log_likelihood_batch_plain`."""
        tracing.stamp("base")
        route = self._diff_route()
        if route is None:
            return self.log_likelihood_batch_plain(thetas, osc_grids_batch)
        args, kwargs = self.diff_kernel_args(thetas, osc_grids_batch)
        tracing.stamp("reweight")
        return self._stat_sum(*_DIFF[route](*args, **kwargs))

    def _stat_sum(self, mc: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
        """Per-bin test statistic (in ``stat_dtype``, default f64) summed over
        bins in f64 (``SampleHandlerFD.cpp:1284-1300``): [..., B] -> [...]."""
        tracing.stamp("stat")
        sd = self.stat_dtype or ATYPE
        stat_fn = get_test_stat_fn(self.test_statistic)
        per_bin = stat_fn(self.data.to(sd), mc.to(sd), w2.to(sd))
        return per_bin.sum(-1, dtype=ATYPE)

    def log_likelihood_batch(
        self, thetas: torch.Tensor, osc_grids_batch: tuple | None = None
    ) -> torch.Tensor:
        """[C, NP] -> [C] -logL on the sample's route."""
        return self._stat_sum(*self.reweight_batch(thetas, osc_grids_batch))

    def log_likelihood(self, params: torch.Tensor, osc_grids: tuple | None = None) -> torch.Tensor:
        """-logL of one θ [NP] (f64 scalar, ``GetLikelihood``): the batched
        route at C = 1; ``osc_grids`` this θ's (nu, antinu) grids."""
        grids = None if osc_grids is None else tuple(g[None] for g in osc_grids)
        return self.log_likelihood_batch(params[None], grids)[0]

    def osc_prob_grids(self, thetas: torch.Tensor) -> tuple | None:
        return None if self.osc is None else self.osc.prob_grids(thetas)

    def osc_share_signature(self) -> tuple | None:
        return None if self.osc is None else self.osc.share_signature()

    def set_data(self, data) -> None:
        """Replace the observed histogram [B] in place."""
        self.data = torch.as_tensor(data, dtype=ATYPE, device=self.kin.device)

    def asimov_data(self, params: torch.Tensor) -> torch.Tensor:
        """MC prediction at ``params`` [NP] (the reference's Asimov default,
        ``MaCh3Factory.h:134-157``), f64 [B]."""
        return self.reweight(params)[0].to(ATYPE)

    def with_binning(self, binning: SampleBinning | NonUniformBinning | PolygonBinning
                     ) -> "SampleModel":
        """The same sample under another binning (on this sample's device,
        data zeroed): the static bins, the kernel route and, on the shared
        and shifted routes, the whole event layout and plan are rebuilt for
        it (``samples/events.assemble_sample``); nothing of the old plan is
        kept. A laid-out sample's zero-weight pad events stay as events."""
        from .events import assemble_sample

        def host(x):
            return None if x is None else x.numpy()

        dev = self.kin.device
        src = copy.deepcopy(self).cpu()  # shares no module with this sample
        arrays = dict(kin=host(src.kin), mc_weight=host(src.mc_weight),
                      norm_idx=host(src.norm_idx), norm_s=host(src.norm_s),
                      weight_mask=host(src.weight_mask), spline_table=src.spline_table,
                      osc=src.osc, tf1_table=src.tf1_table, event_perm=host(src.event_perm),
                      event_pad=host(src.event_pad))
        sample = assemble_sample(
            self.name, arrays, binning.cpu(), shifts=self.shifts, weight_fns=self.weight_fns,
            norm_applied=host(src.norm_applied), data=None,
            test_statistic=self.test_statistic, stat_dtype=self.stat_dtype,
            use_kernel=self.kernel_route.requested)
        return sample.to(dev)


def total_log_likelihood(samples, params: torch.Tensor) -> torch.Tensor:
    """Sum of the samples' -logL at one θ [NP] (f64), each on its route
    (:meth:`SampleModel.log_likelihood`)."""
    total = torch.zeros((), dtype=ATYPE, device=params.device)
    for s in samples:
        total = total + s.log_likelihood(params)
    return total

#: Route -> (argument maker, kernel wrapper) of the sampling path, and the
#: differentiable call of each.
_FORWARD = {
    "shifted": (SampleModel.shifted_kernel_args, fused_reweight_histogram_shifted),
    "shared": (SampleModel.shared_kernel_args, fused_reweight_histogram_shared),
    "generic": (SampleModel.perchain_kernel_args, fused_reweight_histogram),
}
_DIFF = {"shared": fused_reweight_diff, "shifted": fused_reweight_diff_shifted,
         "generic": fused_reweight_diff_perchain}
