"""Config-driven experiment construction: YAML -> FitModel (port of
``mach3_tpu/samples/experiment.py``).

The reference's experiment-definition pipeline
(``Samples/SampleHandlerFD.cpp:169-202``: ``ReadConfig -> SetupExperimentMC
-> SetBinning -> SetupSplines -> SetupNormParameters -> ...``, plus the
covariance and sample factories of ``Fitters/MaCh3Factory.h:69-157``) as one
declarative YAML tree: event columns from ``.npz``, ``.m3evt`` or ``.csv``
files (the last two through ``core/nativeio.py``), spline and TF1
responses from per-sample ``.npz`` files, functional shifts and weight
functions picked by name from registries (extensible with
:func:`register_shift` and :func:`register_weight_fn`). The schema is the
JAX package's (``docs/TUTORIAL.md`` §3):

.. code-block:: yaml

    Experiment:
      Systematics:
        - File: xsec.yaml          # ParameterSet YAML (reference schema)
        - File: osc.yaml
      Samples:
        - Name: numu_sample
          MCFile: numu.npz         # or .m3evt / .csv: kinematic columns +
                                   # mode/target/pdg/preosc_pdg/mc_weight
          VarOrder: [e_true, e_reco]
          Binning:
            Vars: [e_reco]
            Edges: [[0.0, 0.25, 0.5, 1.0, 3.0]]   # or Uniform / NonUniformBins
          Oscillation:             # optional
            EGrid: {Low: 0.05, High: 10.0, N: 200, Log: true}
            Baseline: 295.0
            Density: 2.6
            NCModes: [3]
          SplineFile: numu_splines.npz  # optional: <name>:knots/:event_ids/:y
          TF1File: numu_tf1.npz         # optional: <name>:event_ids/:slope/:intercept
          Shifts:
            - {Function: scale, Parameter: EScale, Var: e_reco}
          WeightFunctions:
            - {Function: res_scale_weight, Parameter: eres, Var: e_reco,
               Args: {true_var: e_true, sigma_frac: 0.35}}
          TestStatistic: BarlowBeeston
      Data: Asimov               # or per-sample DataFile (.npz with "data")

A shift of a kind the shifted kernel knows (``splines/reweight.SHIFT_KINDS``)
is formed there when it is a sample's only shift on a binned axis of a
rectangular binning; a registered shift is known only by its torch body and
takes the per-chain-bins (generic) route.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

from ..core import nativeio
from ..core.config import Config
from ..core.device import target_device
from ..core.exceptions import ConfigError
from ..core.logging import get_logger
from ..fitters.model import FitModel
from ..params.parameterset import ParameterSet, ParamType
from ..splines.monolith import SplineParamSpec, build_dense_table
from ..splines.reweight import SHIFT_KINDS
from ..splines.tf1 import TF1ParamSpec, build_tf1_table
from .binning import NonUniformBinning
from .events import (
    EventData,
    build_osc_config,
    build_sample_model,
    match_event_mask,
    match_norm_params,
)
from .sample import SampleModel, ShiftFn, ShiftSpec, WeightSpec
from .teststats import TestStatistic

_log = get_logger("experiment")

#: Named functional shifts (the reference's ``RegisterFunctionalParameters``
#: callbacks, ``SampleHandlerFD.cpp:465-564``): name -> (kernel kind or
#: None, torch function (value [C, 1], x [C, E], kin [C, V, E]) -> x').
_SHIFT_REGISTRY: dict[str, tuple[str | None, ShiftFn]] = {
    kind: (kind, ShiftSpec.named(kind, 0, 0).fn) for kind in SHIFT_KINDS
}


def register_shift(name: str, fn: ShiftFn) -> None:
    """Register a named functional shift for experiment YAMLs:
    ``fn(value [C, 1], x [C, E], kin [C, V, E]) -> x'`` in torch ops. It has
    no kernel kind: a sample that uses it bins per chain (generic route)."""
    _SHIFT_REGISTRY[name] = (None, fn)


def _res_scale_weight(v, x, kin, true_var=0, sigma_frac=0.1):
    """Resolution-scale weight: the ratio of smearing kernels
    N(x; x_true, (1+v)·σ) / N(x; x_true, σ), σ = sigma_frac · x_true. Scales
    the detector resolution by (1+v) without moving events."""
    xt = kin[true_var]
    s = sigma_frac * torch.clamp(xt, min=1e-6)
    z = (x - xt) / s
    r = 1.0 + v
    return torch.exp(0.5 * z * z * (1.0 - 1.0 / (r * r))) / r


#: Weight-valued functional parameters (the other half of the reference's
#: ``FuncParFuncType`` callbacks): name -> ``(value [C, 1], x [E], kin
#: [V, E], **args) -> weight [C, E]``. ``x`` is the YAML-selected row of the
#: nominal kinematics; Args naming a kinematic variable become row indices.
_WEIGHT_REGISTRY: dict[str, Callable] = {
    "linear_weight": lambda v, x, kin: 1.0 + v * x,
    "scale_weight": lambda v, x, kin: (1.0 + v) * torch.ones_like(x),
    "res_scale_weight": _res_scale_weight,
}


def register_weight_fn(name: str, fn: Callable) -> None:
    """Register a named weight-valued functional response for experiment
    YAMLs: ``fn(value [C, 1], x [E], kin [V, E], **args) -> weight [C, E]``."""
    _WEIGHT_REGISTRY[name] = fn


@dataclasses.dataclass
class Experiment:
    model: FitModel
    param_sets: list[ParameterSet]
    samples: list[SampleModel]
    config: Config


def _load_columns(path: str) -> dict[str, np.ndarray]:
    if path.endswith(".npz"):
        with np.load(path, allow_pickle=False) as f:
            return {k: np.asarray(f[k]) for k in f.files}
    if path.endswith(".csv"):
        with open(path) as f:
            header = f.readline().strip().split(",")
        return nativeio.parse_csv(path, header)
    if path.endswith(".m3evt"):
        return nativeio.read_events(path)
    raise ConfigError(f"Unknown MC file format: {path} (.npz/.csv/.m3evt)")


def _event_data(columns: Mapping[str, np.ndarray]) -> EventData:
    special = {"mode", "target", "pdg", "preosc_pdg", "mc_weight"}
    missing = special - set(columns)
    if missing:
        raise ConfigError(f"MC file missing required columns: {sorted(missing)}")
    kin = {k: np.asarray(v, np.float64) for k, v in columns.items() if k not in special}
    if not kin:
        raise ConfigError("MC file has no kinematic columns")
    return EventData(
        kinematics=kin,
        mode=np.asarray(columns["mode"], np.int32),
        target=np.asarray(columns["target"], np.int32),
        pdg=np.asarray(columns["pdg"], np.int32),
        preosc_pdg=np.asarray(columns["preosc_pdg"], np.int32),
        mc_weight=np.asarray(columns["mc_weight"], np.float64),
    )


def _binning_edges(bcfg: Config) -> list[np.ndarray]:
    if bcfg.has("Edges"):
        return [np.asarray(e, np.float64) for e in bcfg.get("Edges")]
    if bcfg.has("Uniform"):
        out = []
        for u in bcfg.get("Uniform"):
            u = Config(u)
            out.append(np.linspace(float(u.get("Low")), float(u.get("High")), int(u.get("N")) + 1))
        return out
    raise ConfigError("Binning needs Edges, Uniform, or NonUniformBins")


def _spline_table(path: str, metas, events: EventData, param_index: Mapping[str, int]):
    """Spline file: per spline parameter ``<name>:knots`` [K],
    ``<name>:event_ids`` [S], ``<name>:y`` [S, K]."""
    with np.load(path, allow_pickle=False) as f:
        keys = set(f.files)
        specs = []
        for meta in metas:
            base = meta.spline_name or meta.name
            if f"{base}:knots" not in keys:
                continue
            specs.append(SplineParamSpec(
                name=meta.name,
                param_index=param_index[meta.name],
                x_knots=np.asarray(f[f"{base}:knots"], np.float64),
                event_ids=np.asarray(f[f"{base}:event_ids"], np.int64),
                y_knots=np.asarray(f[f"{base}:y"], np.float64),
                interpolation=meta.spline_interpolation,
                knot_low=meta.spline_knot_low,
                knot_high=meta.spline_knot_high,
            ))
    if not specs:
        raise ConfigError(f"{path}: no spline arrays match any spline systematic")
    return build_dense_table(specs, events.n_events)


def _tf1_table(path: str, metas, events: EventData, param_index: Mapping[str, int]):
    """TF1 file: per functional parameter ``<name>:event_ids`` [S],
    ``<name>:slope`` [S], ``<name>:intercept`` [S]."""
    with np.load(path, allow_pickle=False) as f:
        keys = set(f.files)
        specs = [
            TF1ParamSpec(
                name=meta.name,
                param_index=param_index[meta.name],
                event_ids=np.asarray(f[f"{meta.name}:event_ids"], np.int64),
                slope=np.asarray(f[f"{meta.name}:slope"], np.float64),
                intercept=np.asarray(f[f"{meta.name}:intercept"], np.float64),
            )
            for meta in metas if f"{meta.name}:event_ids" in keys
        ]
    if not specs:
        raise ConfigError(f"{path}: no TF1 arrays match any functional systematic")
    return build_tf1_table(specs, events.n_events)


def _osc_config(name: str, ocfg: Config, events: EventData, param_sets, gindex):
    g = ocfg.sub("EGrid")
    lo, hi, n = float(g.get("Low")), float(g.get("High")), int(g.get("N"))
    e_grid = np.geomspace(lo, hi, n) if bool(g.get("Log", False)) else np.linspace(lo, hi, n)
    osc_names = [m.name for ps in param_sets for m in ps.of_type(ParamType.OSC, name)]
    if len(osc_names) != 6:
        raise ConfigError(f"{name}: oscillation needs exactly 6 osc-type params, got {osc_names}")
    kw = {}
    phase = ocfg.get("PhaseDtype", None)
    if phase:
        if str(phase) not in ("float32", "float64"):
            raise ConfigError(f"{name}: PhaseDtype {phase!r} is neither float32 nor float64")
        kw["phase_dtype"] = getattr(torch, str(phase))
    return build_osc_config(
        events, e_grid, [gindex[nm] for nm in osc_names],
        baseline=float(ocfg.get("Baseline")),
        density=float(ocfg.get("Density")),
        electron_fraction=float(ocfg.get("ElectronFraction", 0.5)),
        nc_modes=[int(x) for x in ocfg.get("NCModes", []) or []],
        e_true_var=str(ocfg.get("ETrueVar", "e_true")),
        **kw,
    )


def _shifts(scfg: Config, var_order: list[str], gindex) -> list[ShiftSpec]:
    shifts = []
    for sh in scfg.get("Shifts", []) or []:
        sh = Config(sh)
        fn_name = str(sh.get("Function"))
        if fn_name not in _SHIFT_REGISTRY:
            raise ConfigError(
                f"Unknown shift function '{fn_name}' (registered: {sorted(_SHIFT_REGISTRY)})"
            )
        kind, fn = _SHIFT_REGISTRY[fn_name]
        shifts.append(ShiftSpec(kind, fn, gindex[str(sh.get("Parameter"))],
                                var_order.index(str(sh.get("Var")))))
    return shifts


def _weight_fns(scfg: Config, name: str, var_order: list[str], events: EventData,
                param_sets, gindex) -> list[WeightSpec]:
    out = []
    for wf in scfg.get("WeightFunctions", []) or []:
        wf = Config(wf)
        fn_name = str(wf.get("Function"))
        if fn_name not in _WEIGHT_REGISTRY:
            raise ConfigError(
                f"Unknown weight function '{fn_name}' (registered: {sorted(_WEIGHT_REGISTRY)})"
            )
        base_fn = _WEIGHT_REGISTRY[fn_name]
        var_row = var_order.index(str(wf.get("Var")))
        wargs = {
            str(k): (var_order.index(v) if isinstance(v, str) and v in var_order else v)
            for k, v in (wf.get("Args", {}) or {}).items()
        }
        pname = str(wf.get("Parameter"))
        meta = next((m for ps in param_sets for m in ps.meta if m.name == pname), None)
        if meta is None:
            raise ConfigError(f"WeightFunctions: unknown parameter '{pname}'")
        out.append(WeightSpec(
            fn=lambda v, kin, _f=base_fn, _r=var_row, _a=wargs: _f(v, kin[_r], kin, **_a),
            param_index=gindex[pname],
            mask=match_event_mask(events, meta, name),
        ))
    return out


def build_experiment(cfg: Config, use_kernel: bool | str = "auto",
                     device: str | torch.device = "cuda") -> Experiment:
    """Build the fit model of an ``Experiment`` config tree. The host arrays
    are built on the CPU and the model is returned on ``device``: the card by
    default (raises when none is visible); ``device="cpu"`` keeps it on the
    CPU. ``use_kernel=False`` puts every sample on the plain route."""
    dev = target_device(device)
    exp = cfg.sub("Experiment") if cfg.has("Experiment") else cfg

    param_sets: list[ParameterSet] = []
    for i, entry in enumerate(exp.get("Systematics")):
        entry = Config(entry)
        pcfg = Config.from_file(entry.get("File")) if entry.has("File") else entry
        param_sets.append(ParameterSet.from_config(pcfg, name=str(entry.get("Name", f"params{i}"))))
    # Global parameter indexing: concatenation order of the sets.
    gindex: dict[str, int] = {}
    for ps in param_sets:
        for nm in ps.names:
            if nm in gindex:
                raise ConfigError(f"Duplicate parameter name across sets: {nm}")
            gindex[nm] = len(gindex)
    n_total = len(gindex)

    samples: list[SampleModel] = []
    for scfg in exp.get("Samples"):
        scfg = Config(scfg)
        name = str(scfg.get("Name"))
        events = _event_data(_load_columns(str(scfg.get("MCFile"))))
        var_order = [str(v) for v in scfg.get("VarOrder")]

        norm_metas, spline_metas, func_metas = [], [], []
        for ps in param_sets:
            norm_metas += [(m, gindex[m.name]) for m in ps.of_type(ParamType.NORM, name)]
            spline_metas += ps.of_type(ParamType.SPLINE, name)
            func_metas += ps.of_type(ParamType.FUNCTIONAL, name)

        spline_table = tf1_table = osc = None
        if scfg.get("SplineFile", None):
            spline_table = _spline_table(str(scfg.get("SplineFile")), spline_metas, events, gindex)
        if scfg.get("TF1File", None):
            tf1_table = _tf1_table(str(scfg.get("TF1File")), func_metas, events, gindex)
        if scfg.get("Oscillation", None):
            osc = _osc_config(name, scfg.sub("Oscillation"), events, param_sets, gindex)

        bcfg = scfg.sub("Binning")
        bin_vars = [str(v) for v in bcfg.get("Vars")]
        binning = edges = None
        if bcfg.has("NonUniformBins"):
            binning = NonUniformBinning.build(bcfg.get("NonUniformBins"),
                                              [var_order.index(v) for v in bin_vars])
        else:
            edges = _binning_edges(bcfg)
        sm = build_sample_model(
            name, events, var_order=var_order, binning_edges=edges, binning_vars=bin_vars,
            n_total_params=n_total, norm_idx=match_norm_params(events, norm_metas, name),
            spline_table=spline_table, tf1_table=tf1_table, osc=osc,
            shifts=_shifts(scfg, var_order, gindex),
            weight_fns=_weight_fns(scfg, name, var_order, events, param_sets, gindex),
            test_statistic=TestStatistic(scfg.get("TestStatistic", "BarlowBeeston")),
            use_kernel=use_kernel, binning=binning,
        )
        samples.append(sm)
        _log.info("Sample %s: %d events, %d bins, splines %s, TF1s %s, osc %s, route %s",
                  name, events.n_events, sm.n_bins, spline_table is not None,
                  tf1_table is not None, osc is not None, sm.kernel_route.variant)

    model = FitModel.build(param_sets, samples)
    data_mode = str(exp.get("Data", "Asimov"))
    if data_mode == "Asimov":
        prefit = model.prefit_vector()
        with torch.no_grad():
            for s in samples:
                s.set_data(s.asimov_data(prefit))
    else:
        for s, scfg in zip(samples, exp.get("Samples")):
            scfg = Config(scfg)
            if not scfg.get("DataFile", None):
                raise ConfigError(f"Data: {data_mode} requires DataFile per sample")
            with np.load(str(scfg.get("DataFile")), allow_pickle=False) as f:
                s.set_data(np.asarray(f["data"], np.float64))
    model.to(dev)
    return Experiment(model=model, param_sets=param_sets, samples=samples, config=cfg)
