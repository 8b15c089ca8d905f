"""The system under test: the benchmark's inputs handed to ``mach3_tpu_torch``
through its normal constructors (``ParameterSet``, ``EventData``, the dense
spline table builder, ``build_sample_model`` with the oscillation configs,
``FitModel``). Nothing here computes a likelihood: the model does."""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "float64": torch.float64}


def build_model(inp, device):
    """The program's ``FitModel`` of ``inp`` (an :class:`~m3bench.fixtures.Inputs`
    with its Asimov data made) on ``device``."""
    from mach3_tpu_torch.core.config import Config
    from mach3_tpu_torch.fitters.model import FitModel
    from mach3_tpu_torch.params.parameterset import ParameterSet, ParamType, SplineInterpolation
    from mach3_tpu_torch.samples.events import (
        EventData,
        build_atmo_osc_config,
        build_osc_config,
        build_sample_model,
        match_norm_params,
    )
    from mach3_tpu_torch.samples.sample import ShiftSpec
    from mach3_tpu_torch.samples.teststats import TestStatistic
    from mach3_tpu_torch.splines.monolith import SplineParamSpec, build_dense_table

    from .fixtures import KNOT_HIGH, KNOT_LOW, SIGMA_KNOTS

    prec = inp.precision
    sets = [ParameterSet.from_config(Config(t), name=n) for t, n in zip(inp.trees, ("xsec", "osc"))]
    n_total = sum(len(s) for s in sets)
    norm_metas = [(m, m.index) for m in sets[0].of_type(ParamType.NORM)]
    low_memory = prec["tables"] == "bfloat16"
    samples = []
    for s, data in zip(inp.samples, inp.data):
        ev = EventData(kinematics=dict(s.kin), mode=s.mode, target=s.target, pdg=s.pdg,
                       preosc_pdg=s.preosc_pdg, mc_weight=s.mc_weight)
        specs = [SplineParamSpec(name=f"p{sp.param_index}", param_index=sp.param_index,
                                 x_knots=SIGMA_KNOTS, event_ids=sp.event_ids, y_knots=sp.y_knots,
                                 interpolation=SplineInterpolation(sp.interpolation),
                                 knot_low=KNOT_LOW, knot_high=KNOT_HIGH) for sp in s.splines]
        table = build_dense_table(specs, s.n_events, low_memory=low_memory)
        o = s.osc
        if o["kind"] == "beam":
            osc = build_osc_config(ev, o["e_grid"], inp.osc_param_index,
                                   baseline=o["baseline_km"], density=o["density"],
                                   nc_modes=list(inp.nc_modes),
                                   dtype=_DTYPES[prec["oscillation"]],
                                   phase_dtype=_DTYPES[prec["oscillation"]])
        else:
            osc = build_atmo_osc_config(ev, o["e_grid"], o["cosz_grid"], inp.osc_param_index,
                                        nc_modes=list(inp.nc_modes),
                                        production_height_km=o["production_height_km"],
                                        dtype=_DTYPES[prec["oscillation"]])
        shifts = () if s.shift is None else (ShiftSpec.scale(s.shift[0], var_row=s.shift[1]),)
        samples.append(build_sample_model(
            s.name, ev, var_order=list(s.var_order), binning_edges=s.edges,
            binning_vars=list(s.bin_vars), n_total_params=n_total,
            norm_idx=match_norm_params(ev, norm_metas, s.name), spline_table=table, osc=osc,
            shifts=shifts, data=np.asarray(data, np.float64),
            test_statistic=TestStatistic.BARLOW_BEESTON,
            stat_dtype=_DTYPES[prec["statistic"]], use_kernel="auto"))
    return FitModel.build(sets, samples).to(device)
