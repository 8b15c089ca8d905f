"""Build this package's ``FitModel`` from a ``mach3_tpu`` (JAX) ``FitModel``.

Used by the tests that hold the port against the JAX package. It imports no
jax: array leaves are read with ``np.asarray`` and static fields by
attribute. JAX shift callables cannot cross: each shift becomes the port's
``"scale"`` kind (``x * (1 + v)``, the toy's energy scale), after the JAX
callable is evaluated on a few numpy values to check that it is that shift.

A shared-route sample arrives sorted and padded for JAX's own event tile
(its pad events carry zero weight); the port lays it out again for its own
kernel (``samples/events.apply_shared_layout``) and reads none of JAX's
``hist_*`` plan, which was sized for the TPU's VMEM.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.precision import FTYPE
from .fitters.model import FitModel
from .params.state import _FIELDS, PriorModel
from .samples.binning import SampleBinning
from .samples.events import apply_shared_layout
from .samples.routing import choose_kernel_route
from .samples.sample import AtmoOscConfig, OscConfig, SampleModel, ShiftSpec
from .samples.teststats import TestStatistic
from .splines.monolith import DenseSplineTable
from .splines.reweight import SHIFT_KINDS

_DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}


def _np(x):
    """A writable numpy copy (JAX arrays read as read-only views)."""
    return None if x is None else np.array(x)


def _dtype(jdtype):
    return None if jdtype is None else _DTYPES[np.dtype(jdtype).name]


def _tensor(x):
    """numpy (incl. ml_dtypes bfloat16) -> torch, keeping bf16 as bf16."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a)


def _prior(jp) -> PriorModel:
    return PriorModel(**{f: _np(getattr(jp, f)) for f in _FIELDS})


def _shift(js) -> ShiftSpec:
    x = np.linspace(0.1, 2.9, 7).astype(np.float32)
    for v in (-0.2, 0.0, 0.13):
        want = SHIFT_KINDS["scale"][1](torch.tensor([[v]], dtype=FTYPE), torch.from_numpy(x))
        got = np.asarray(js.fn(np.float32(v), x, None), np.float32)
        if not np.allclose(got, want.numpy()[0], rtol=1e-6, atol=0.0):
            raise NotImplementedError(
                f"JAX shift on row {js.var_row} is not x * (1 + v); only that kind is ported"
            )
    return ShiftSpec.scale(js.param_index, js.var_row)


def _osc(jo) -> OscConfig | AtmoOscConfig | None:
    if jo is None:
        return None
    if hasattr(jo, "event_flat_idx"):
        return AtmoOscConfig(
            _np(jo.e_grid), _np(jo.layer_lengths), _np(jo.layer_rho), _np(jo.event_flat_idx),
            _np(jo.chan_alpha), _np(jo.chan_beta), _np(jo.chan_anti), _np(jo.nc_mask),
            _np(jo.osc_param_idx), rho_unique=_np(jo.rho_unique), rho_idx=_np(jo.rho_idx),
            height_weights=_np(jo.height_weights), z_groups=jo.z_groups,
            dtype=_dtype(jo.dtype),
        )
    return OscConfig(
        _np(jo.e_grid), _np(jo.event_grid_idx), _np(jo.event_channel),
        _np(jo.chan_alpha), _np(jo.chan_beta), _np(jo.chan_anti), _np(jo.nc_mask),
        _np(jo.osc_param_idx), baseline=jo.baseline, density=jo.density,
        electron_fraction=jo.electron_fraction, dtype=_dtype(jo.dtype),
        phase_dtype=_dtype(jo.phase_dtype),
    )


def _sample(js) -> SampleModel:
    jb = js.binning
    if not hasattr(jb, "strides"):
        raise NotImplementedError(
            f"{js.name}: only rectangular binnings are ported (ROADMAP)"
        )
    binning = SampleBinning(
        _tensor(jb.edges), _np(jb.n_bins_axis), _np(jb.strides), _np(jb.axis_vars),
        jb.n_bins,
    )
    jt = js.spline_table
    table = None
    if jt is not None:
        if not hasattr(jt, "coeffs"):
            raise NotImplementedError(f"{js.name}: only dense spline tables are ported")
        table = DenseSplineTable(
            _tensor(jt.coeffs), _tensor(jt.knots_x), _np(jt.n_knots), _np(jt.param_index)
        )
    shifts = tuple(_shift(s) for s in js.shifts)
    kernel_shift = None
    shift_edges = None
    if js.kernel_shift is not None:
        _, param_index, edges, stride_j, n_axis_j = js.kernel_shift
        kernel_shift = ("scale", int(param_index), int(stride_j), int(n_axis_j))
        shift_edges = np.asarray(edges, np.float32)
    requested = js.kernel_route.requested if js.kernel_route is not None else js.use_pallas
    route = choose_kernel_route(
        jb.n_bins, table,
        has_static_bins=js.static_bins is not None,
        has_kernel_shift=kernel_shift is not None,
        requested=requested,
    )
    arrays = dict(kin=_np(js.kin), mc_weight=_np(js.mc_weight), norm_idx=_np(js.norm_idx),
                  norm_s=_np(js.norm_s), static_bins=_np(js.static_bins),
                  spline_table=table, osc=_osc(js.osc))
    if route.use_kernel and route.variant == "shared":
        arrays = apply_shared_layout(js.name, arrays, table, arrays["osc"], jb.n_bins)
    return SampleModel(
        js.name,
        binning=binning,
        data=_np(js.data),
        norm_applied=_np(js.norm_applied),
        shifts=shifts,
        test_statistic=TestStatistic(js.test_statistic.value),
        stat_dtype=_dtype(js.stat_dtype),
        kernel_route=route,
        kernel_shift=kernel_shift,
        shift_static_base=_np(js.shift_static_base),
        shift_edges=shift_edges,
        tf1_table=js.tf1_table,
        weight_fns=tuple(js.weight_fns),
        **arrays,
    )


def from_jax_model(jax_fit_model, device="cpu") -> FitModel:
    """The port's ``FitModel`` holding the JAX model's arrays, on ``device``."""
    priors = [_prior(p) for p in jax_fit_model.priors]
    samples = [_sample(s) for s in jax_fit_model.samples]
    flat = _prior(jax_fit_model.flat) if jax_fit_model.flat is not None else None
    model = FitModel(priors, samples, jax_fit_model.slices, flat=flat,
                     osc_groups=jax_fit_model.osc_groups)
    return model.to(device)

