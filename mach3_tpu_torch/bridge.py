"""Build this package's ``FitModel`` from a ``mach3_tpu`` (JAX) ``FitModel``.

Used by the tests that hold the port against the JAX package. It imports no
jax: array leaves are read with ``np.asarray`` and static fields by
attribute. JAX shift callables cannot cross: each shift becomes one of the
port's named kinds (``splines/reweight.SHIFT_KINDS``), found by evaluating
the JAX callable on a few numpy values; a shift of no named kind and every
weight-valued function (closures over JAX code) raise — build such a model
from the same experiment files with the port's ``build_experiment``. Dense
and sparse spline tables, TF1 tables, and hyper-rectangle and polygon
binnings cross as arrays.

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
from .samples.binning import NonUniformBinning, PolygonBinning, SampleBinning
from .samples.events import assemble_sample
from .samples.sample import AtmoOscConfig, OscConfig, ShiftSpec
from .samples.teststats import TestStatistic
from .splines.monolith import DenseSplineTable, SparseSplineTable
from .splines.reweight import SHIFT_KINDS
from .splines.tf1 import TF1Table

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


_FROM_FILES = ("build the model from the same experiment files with "
               "mach3_tpu_torch.samples.experiment.build_experiment")


def _shift(js) -> ShiftSpec:
    """The port's named shift that the JAX callable computes."""
    x = np.linspace(-0.9, 2.9, 9).astype(np.float32)
    for kind, (_, plain) in SHIFT_KINDS.items():
        if all(np.allclose(np.asarray(js.fn(np.float32(v), x, None), np.float32),
                           plain(torch.tensor([[v]], dtype=FTYPE), torch.from_numpy(x)).numpy()[0],
                           rtol=1e-6, atol=1e-7)
               for v in (-0.2, 0.0, 0.13)):
            return ShiftSpec.named(kind, js.param_index, js.var_row)
    raise NotImplementedError(
        f"JAX shift on row {js.var_row} is none of {sorted(SHIFT_KINDS)}; a JAX callable "
        f"cannot cross: {_FROM_FILES}")


def _binning(jb):
    if hasattr(jb, "strides"):
        return SampleBinning(_tensor(jb.edges), _np(jb.n_bins_axis), _np(jb.strides),
                             _np(jb.axis_vars), jb.n_bins)
    if hasattr(jb, "cell_to_bin"):
        return NonUniformBinning(_tensor(jb.cell_edges), _np(jb.n_cells_axis),
                                 _np(jb.cell_strides), _np(jb.cell_to_bin), _np(jb.axis_vars),
                                 jb.n_bins, _np(jb.extents))
    return PolygonBinning(_tensor(jb.ex1), _tensor(jb.ey1), _tensor(jb.ex2), _tensor(jb.ey2),
                          _np(jb.edge_poly), _np(jb.axis_vars), jb.n_bins, jb.polygons or ())


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


def _sample(js):
    if js.weight_fns:
        raise NotImplementedError(f"{js.name}: weight-valued functions are JAX closures; "
                                  + _FROM_FILES)
    jt = js.spline_table
    table = None
    if jt is not None and hasattr(jt, "coeffs"):
        table = DenseSplineTable(
            _tensor(jt.coeffs), _tensor(jt.knots_x), _np(jt.n_knots), _np(jt.param_index)
        )
    elif jt is not None:
        table = SparseSplineTable(
            _tensor(jt.spline_coeffs), _np(jt.spline_param), _np(jt.event_splines),
            _tensor(jt.knots_x), _np(jt.n_knots), _np(jt.param_index)
        )
    tf1 = js.tf1_table
    if tf1 is not None:
        tf1 = TF1Table(_np(tf1.slope), _np(tf1.intercept), _np(tf1.param_index))
    requested = js.kernel_route.requested if js.kernel_route is not None else js.use_pallas
    # The bin map, route and (shared route) layout are the port's own,
    # rebuilt from the arrays; a JAX shared-route sample arrives sorted and
    # padded with zero-weight events, which stay events here.
    arrays = dict(kin=_np(js.kin), mc_weight=_np(js.mc_weight), norm_idx=_np(js.norm_idx),
                  norm_s=_np(js.norm_s), spline_table=table, osc=_osc(js.osc),
                  tf1_table=tf1, weight_mask=None)
    return assemble_sample(
        js.name, arrays, _binning(js.binning), shifts=tuple(_shift(s) for s in js.shifts),
        norm_applied=_np(js.norm_applied), data=_np(js.data),
        test_statistic=TestStatistic(js.test_statistic.value),
        stat_dtype=_dtype(js.stat_dtype), use_kernel=requested)


def from_jax_model(jax_fit_model, device="cpu") -> FitModel:
    """The port's ``FitModel`` holding the JAX model's arrays, on ``device``."""
    priors = [_prior(p) for p in jax_fit_model.priors]
    samples = [_sample(s) for s in jax_fit_model.samples]
    flat = _prior(jax_fit_model.flat) if jax_fit_model.flat is not None else None
    model = FitModel(priors, samples, jax_fit_model.slices, flat=flat,
                     osc_groups=jax_fit_model.osc_groups)
    return model.to(device)

