"""The in-repo toy experiment: a T2K-like two-sample beam fit (port of
``mach3_tpu/tutorial/toy.py``, built without jax).

Two binned samples (numu disappearance, nue appearance) with 1D E_reco
binning over shared MC events split by oscillation channel; 5 norm and 4
spline systematics, one energy-scale shift ``x*(1+v)``, and the 6
oscillation parameters; Asimov data at the prefit point by default
(``Fitters/MaCh3Factory.h:134-157``). The numpy random calls are the JAX
package's, in the same order, so ``build_toy(seed=s)`` gives the same events
and tables there and here.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import Config
from ..core.device import target_device
from ..fitters.model import FitModel
from ..params.parameterset import ParameterSet, ParamType
from ..samples.events import (
    EventData,
    build_osc_config,
    build_sample_model,
    match_norm_params,
)
from ..samples.sample import SampleModel, ShiftSpec
from ..samples.teststats import TestStatistic
from ..splines.monolith import SplineParamSpec, build_dense_table, build_sparse_table

# Interaction modes of the toy generator
MODE_CCQE, MODE_CCRES, MODE_CCDIS, MODE_NC = 0, 1, 2, 3

BASELINE_KM = 295.0
DENSITY = 2.6


def xsec_config() -> dict:
    """YAML-equivalent systematics definition for the cross-section block."""
    entries = [
        # Norm parameters
        dict(name="norm_ccqe", error=0.10, modes=[MODE_CCQE]),
        dict(name="norm_ccres", error=0.15, modes=[MODE_CCRES]),
        dict(name="norm_ccdis", error=0.12, modes=[MODE_CCDIS]),
        dict(name="norm_nc", error=0.30, modes=[MODE_NC]),
        dict(name="norm_nue_flux", error=0.05, pdgs=[12, -12]),
    ]
    systematics = []
    for e in entries:
        syst = {
            "Names": {"FancyName": e["name"]},
            "ParameterValues": {"PreFitValue": 1.0},
            "StepScale": {"MCMC": 0.1},
            "Error": e["error"],
            "ParameterBounds": [0.0, 3.0],
            "Type": "Norm",
            "ParameterGroup": "Xsec",
        }
        if "modes" in e:
            syst["Mode"] = e["modes"]
        if "pdgs" in e:
            syst["NeutrinoFlavour"] = e["pdgs"]
        systematics.append({"Systematic": syst})

    # Spline parameters (response systematics), different interpolation types
    for name, err, interp in [
        ("spl_maqe", 0.15, "TSpline3"),
        ("spl_ca5", 0.20, "Monotonic"),
        ("spl_mares", 0.15, "Akima"),
        ("spl_dis_shape", 0.10, "Linear"),
    ]:
        systematics.append(
            {
                "Systematic": {
                    "Names": {"FancyName": name},
                    "ParameterValues": {"PreFitValue": 0.0},
                    "StepScale": {"MCMC": 0.2},
                    "Error": err,
                    "ParameterBounds": [-3.0, 3.0],
                    "Type": "Spline",
                    "ParameterGroup": "Xsec",
                    "SplineInformation": {
                        "SplineName": name,
                        "InterpolationType": interp,
                    },
                }
            }
        )
    # Functional parameter: reco-energy scale
    systematics.append(
        {
            "Systematic": {
                "Names": {"FancyName": "escale"},
                "ParameterValues": {"PreFitValue": 0.0},
                "StepScale": {"MCMC": 0.2},
                "Error": 0.02,
                "ParameterBounds": [-0.3, 0.3],
                "Type": "Functional",
                "ParameterGroup": "Detector",
            }
        }
    )
    return {"Systematics": systematics}


def osc_config_yaml(
    flip_hierarchy: bool = False, entry_overrides: dict | None = None
) -> dict:
    """Oscillation-parameter block: sin² parameterisation, PDG-ish priors.

    entry_overrides: per-parameter dict merged over the Systematic entry
    (e.g. ``{"dm2_31": {"ParameterBounds": [-5e-3, -5e-5], "ParameterValues":
    {"PreFitValue": -2.46e-3}}}`` restricts the fit to the inverted
    ordering — the model-comparison setup of an NH-vs-IH evidence run)."""
    entries = [
        ("sin2th12", 0.307, 0.013, [0.0, 1.0], 1.0, False),
        ("sin2th13", 0.0220, 0.0007, [0.0, 1.0], 1.0, False),
        ("sin2th23", 0.561, 0.03, [0.3, 0.7], 1.0, True),
        ("delta_cp", -1.601, 1.0, [-3.14159266, 3.14159266], 0.5, True),
        ("dm2_21", 7.42e-5, 2.1e-6, [6.0e-5, 9.0e-5], 1.0, False),
        ("dm2_31", 2.51e-3, 3.0e-5, [-5.0e-3, 5.0e-3], 1.0, False),
    ]
    systematics = []
    for name, prefit, err, bounds, step, flat in entries:
        syst = {
            "Names": {"FancyName": name},
            "ParameterValues": {"PreFitValue": prefit},
            "StepScale": {"MCMC": step},
            "Error": err,
            "ParameterBounds": bounds,
            "Type": "Osc",
            "ParameterGroup": "Osc",
        }
        if flat:
            syst["FlatPrior"] = True
        if name == "delta_cp":
            syst["SpecialProposal"] = {"CircularBounds": [-3.14159265, 3.14159265]}
        if name == "dm2_31" and flip_hierarchy:
            syst["SpecialProposal"] = {"FlipParameter": 0.0}
        for key, val in ((entry_overrides or {}).get(name, {}) or {}).items():
            if isinstance(val, dict) and isinstance(syst.get(key), dict):
                syst[key] = {**syst[key], **val}
            else:
                syst[key] = val
        systematics.append({"Systematic": syst})
    return {"Systematics": systematics}


@dataclasses.dataclass
class ToyExperiment:
    xsec: ParameterSet
    osc: ParameterSet
    samples: list[SampleModel]
    model: FitModel
    names: list[str]
    #: per-sample [E] interaction-mode labels (by-mode predictive breakdowns)
    event_modes: list[np.ndarray] | None = None

    @property
    def n_params(self) -> int:
        return self.model.n_params


def _generate_events(rng: np.random.Generator, n_events: int) -> EventData:
    """Toy beam MC: mostly numu flux, small intrinsic nue, four modes."""
    e_true = rng.gamma(shape=3.0, scale=0.25, size=n_events) + 0.05
    e_reco = np.clip(e_true * (1.0 + 0.08 * rng.normal(size=n_events)), 0.01, None)
    mode = rng.choice(
        [MODE_CCQE, MODE_CCRES, MODE_CCDIS, MODE_NC], p=[0.45, 0.25, 0.15, 0.15], size=n_events
    )
    # flux: 97% numu, 3% intrinsic nue
    preosc = rng.choice([14, 12], p=[0.97, 0.03], size=n_events)
    # detection channel: numu flux events split into numu (survival) and nue
    # (appearance) "copies" by assigning the detected flavour; weight via osc prob.
    det = preosc.copy()
    numu_idx = np.nonzero(preosc == 14)[0]
    appearance = rng.random(len(numu_idx)) < 0.3  # oversample appearance events
    det[numu_idx[appearance]] = 12
    weight = np.where((preosc == 14) & (det == 12), 1.0 / 0.3, 1.0 / 0.7)
    weight = np.where(preosc == 12, 1.0, weight)
    weight = weight * 50.0 / np.sqrt(np.maximum(e_true, 0.05))
    return EventData(
        kinematics={"e_true": e_true, "e_reco": e_reco},
        mode=mode.astype(np.int32),
        target=np.full(n_events, 12, np.int32),
        pdg=det.astype(np.int32),
        preosc_pdg=preosc.astype(np.int32),
        mc_weight=(weight / n_events * 5e4).astype(np.float64),
    )


def _spline_specs(
    rng: np.random.Generator, events: EventData, xsec: ParameterSet, offset: int
) -> list[SplineParamSpec]:
    """Per-event response splines at sigma knots [-3,-1,0,1,3].

    Responses are mode-dependent smooth functions of sigma with per-event
    variation; at sigma=0 the response is exactly 1.
    """
    sigma = np.array([-3.0, -1.0, 0.0, 1.0, 3.0])
    specs = []
    mode_affinity = {
        "spl_maqe": MODE_CCQE,
        "spl_ca5": MODE_CCRES,
        "spl_mares": MODE_CCRES,
        "spl_dis_shape": MODE_CCDIS,
    }
    for meta in xsec.of_type(ParamType.SPLINE):
        affected = np.nonzero(events.mode == mode_affinity[meta.name])[0]
        n = len(affected)
        slope = 0.08 * (1.0 + 0.3 * rng.normal(size=n))
        curv = 0.01 * rng.normal(size=n)
        y = 1.0 + slope[:, None] * sigma[None, :] + curv[:, None] * sigma[None, :] ** 2
        y = np.clip(y, 0.0, None)
        y[:, 2] = 1.0  # exactly unity at nominal
        specs.append(
            SplineParamSpec(
                name=meta.name,
                param_index=offset + meta.index,
                x_knots=sigma,
                event_ids=affected,
                y_knots=y,
                interpolation=meta.spline_interpolation,
                knot_low=0.0,
                knot_high=9.0,
            )
        )
    return specs


def build_toy(
    n_events: int = 20_000,
    seed: int = 1234,
    flip_hierarchy: bool = False,
    e_grid_size: int = 200,
    use_kernel: bool | str = "auto",
    device: str | torch.device = "cuda",
    dense_splines: bool = True,
    test_statistic: TestStatistic = TestStatistic.BARLOW_BEESTON,
    baseline: float = BASELINE_KM,
    density: float = DENSITY,
    osc_entry_overrides: dict | None = None,
    asimov_overrides: dict | None = None,
) -> ToyExperiment:
    """Build the toy with Asimov data at the prefit point, or at the truth
    of ``asimov_overrides`` (parameter name -> value, e.g. an off-maximal
    ``osc_sin2th23`` for octant studies). The host arrays are built on the
    CPU and the model is returned on ``device``: the card by default (raises
    when none is visible); ``device="cpu"`` keeps it on the CPU.
    ``dense_splines=False`` builds sparse spline tables, whose samples take
    the plain route (as in the JAX package). ``baseline`` [km] and
    ``density`` [g/cm³] set the beam's oscillation; ``osc_entry_overrides``
    is merged over the oscillation block (:func:`osc_config_yaml`)."""
    dev = target_device(device)
    rng = np.random.default_rng(seed)
    xsec = ParameterSet.from_config(Config(xsec_config()), name="xsec")
    osc = ParameterSet.from_config(
        Config(osc_config_yaml(flip_hierarchy, osc_entry_overrides)), name="osc")
    n_xsec = len(xsec)
    n_total = n_xsec + len(osc)
    osc_gidx = list(range(n_xsec, n_xsec + 6))

    events = _generate_events(rng, n_events)

    # numu-like (detected mu, CC) and nue-like (detected e, plus NC) selections
    is_numu_sel = (np.abs(events.pdg) == 14) & (events.mode != MODE_NC)
    is_nue_sel = (np.abs(events.pdg) == 12) | (events.mode == MODE_NC)

    norm_metas = [(m, m.index) for m in xsec.of_type(ParamType.NORM)]
    spline_specs = _spline_specs(rng, events, xsec, offset=0)
    escale_idx = xsec.index_of("escale")

    e_grid = np.linspace(0.05, 3.0, e_grid_size)

    def subset(events: EventData, mask: np.ndarray) -> tuple[EventData, np.ndarray]:
        idx = np.nonzero(mask)[0]
        return EventData(
            kinematics={k: v[idx] for k, v in events.kinematics.items()},
            mode=events.mode[idx],
            target=events.target[idx],
            pdg=events.pdg[idx],
            preosc_pdg=events.preosc_pdg[idx],
            mc_weight=events.mc_weight[idx],
        ), idx

    samples = []
    event_modes = []
    for name, mask, edges in [
        ("numu_sample", is_numu_sel, np.linspace(0.0, 3.0, 31)),
        ("nue_sample", is_nue_sel, np.linspace(0.0, 3.0, 16)),
    ]:
        sub, idx = subset(events, mask)
        event_modes.append(np.asarray(sub.mode))
        remap = -np.ones(len(events.mode), np.int64)
        remap[idx] = np.arange(len(idx))
        sub_specs = []
        for spec in spline_specs:
            keep = np.isin(spec.event_ids, idx)
            sub_specs.append(
                SplineParamSpec(
                    name=spec.name,
                    param_index=spec.param_index,
                    x_knots=spec.x_knots,
                    event_ids=remap[spec.event_ids[keep]],
                    y_knots=spec.y_knots[keep],
                    interpolation=spec.interpolation,
                    knot_low=spec.knot_low,
                    knot_high=spec.knot_high,
                )
            )
        table = (build_dense_table if dense_splines else build_sparse_table)(
            sub_specs, sub.n_events)
        norm_idx = match_norm_params(sub, norm_metas, name)
        osc_cfg = build_osc_config(
            sub,
            e_grid,
            osc_gidx,
            baseline=baseline,
            density=density,
            nc_modes=[MODE_NC],
            # Beam baseline: λL ~ a few rad, f32 phases exact to ~1e-7 rad.
            phase_dtype=torch.float32,
        )
        samples.append(
            build_sample_model(
                name,
                sub,
                var_order=["e_true", "e_reco"],
                binning_edges=[edges],
                binning_vars=["e_reco"],
                n_total_params=n_total,
                norm_idx=norm_idx,
                spline_table=table,
                osc=osc_cfg,
                shifts=(ShiftSpec.scale(escale_idx, var_row=1),),  # e_reco
                test_statistic=test_statistic,
                use_kernel=use_kernel,
            )
        )

    model = FitModel.build([xsec, osc], samples)

    names = [f"xsec_{n}" for n in xsec.names] + [f"osc_{n}" for n in osc.names]
    truth = model.prefit_vector()
    for pname, val in (asimov_overrides or {}).items():
        truth[names.index(pname)] = float(val)
    with torch.no_grad():
        for s in samples:
            s.set_data(s.asimov_data(truth))
    model.to(dev)
    return ToyExperiment(
        xsec=xsec, osc=osc, samples=samples, model=model, names=names,
        event_modes=event_modes,
    )


def build_octant_toy(
    n_events: int = 3000,
    seed: int = 77,
    e_grid_size: int = 56,
    s23_true: float = 0.45,
    hierarchy: str = "NH",
    use_kernel: bool | str = "auto",
    device: str | torch.device = "cuda",
) -> ToyExperiment:
    """The octant-degenerate Asimov toy (JAX ``toy.py:385-428``): truth
    sin²θ23 = ``s23_true`` under a flat sin²θ23 prior, so the posterior has
    a second mode in the mirror octant; a DUNE-like baseline and density
    (1,300 km, 2.85 g/cm³) so that matter effects separate the mass
    orderings. ``hierarchy`` is the fit model's Δm²31 sign ("NH" or "IH");
    the Asimov data are always made at the NH truth (+2.51e-3), so an "IH"
    build is the wrong-ordering model of a Bayes-factor comparison."""
    if hierarchy == "IH":
        overrides = {"dm2_31": {"ParameterBounds": [-5.0e-3, -5.0e-5],
                                "ParameterValues": {"PreFitValue": -2.46e-3}}}
    elif hierarchy == "NH":
        overrides = {"dm2_31": {"ParameterBounds": [5.0e-5, 5.0e-3]}}
    else:
        raise ValueError(f"hierarchy must be 'NH' or 'IH', got {hierarchy!r}")
    return build_toy(
        n_events=n_events, seed=seed, e_grid_size=e_grid_size, use_kernel=use_kernel,
        device=device, baseline=1300.0, density=2.85, osc_entry_overrides=overrides,
        asimov_overrides={"osc_sin2th23": s23_true, "osc_dm2_31": 2.51e-3},
    )
