"""The benchmark's inputs: a frozen generator of beam and atmospheric MC,
spline knots, systematics and binnings, independent of the program.

It follows the generation logic of the reference-scale fixtures of the
framework (``large`` and ``large700``, and their beam samples alone in
``beam1det`` and ``beam2det``), rewritten here so that a change to the
program cannot change what the benchmark feeds it. Everything comes from
one ``numpy.random.Generator`` seeded with ``--seed``; the same seed gives
the same inputs. Kinematics and MC weights are rounded to float32 here, the
precision both sides store them in, so both read the same values.

A configuration module (``configs/<name>.py``) lists its samples and
systematics with these helpers and returns :class:`Inputs`.
"""
from __future__ import annotations

import dataclasses

import numpy as np

MODE_CCQE, MODE_CCRES, MODE_CCDIS, MODE_NC = 0, 1, 2, 3
MODES = (MODE_CCQE, MODE_CCRES, MODE_CCDIS, MODE_NC)
FAMILIES = ("TSpline3", "Linear", "Monotonic", "Akima", "KochanekBartels")
#: The spline knots of every response, in prior sigmas.
SIGMA_KNOTS = np.array([-3.0, -1.0, 0.0, 1.0, 3.0])
#: Clipping of the knot responses (the reference's knot-weight caps).
KNOT_LOW, KNOT_HIGH = 0.0, 9.0


@dataclasses.dataclass
class SplineInputs:
    """The responses of one spline parameter in one sample: ``y_knots``
    [n, K] at ``SIGMA_KNOTS`` for the events ``event_ids`` [n]."""

    param_index: int
    interpolation: str
    event_ids: np.ndarray
    y_knots: np.ndarray


@dataclasses.dataclass
class SampleInputs:
    """One binned sample: its MC events, binning, splines, oscillation and
    functional shift. ``osc`` is ``{"kind": "beam", "e_grid", "baseline_km",
    "density"}`` or ``{"kind": "atmo", "e_grid", "cosz_grid",
    "production_height_km"}``; ``shift`` is ``(param index, row of
    var_order)`` of an energy scale ``x * (1 + v)`` or None."""

    name: str
    kin: dict
    mode: np.ndarray
    target: np.ndarray
    pdg: np.ndarray
    preosc_pdg: np.ndarray
    mc_weight: np.ndarray
    var_order: tuple
    edges: list
    bin_vars: tuple
    splines: list
    osc: dict
    shift: tuple | None = None

    @property
    def n_events(self) -> int:
        return len(self.mode)

    @property
    def n_bins(self) -> int:
        return int(np.prod([len(e) - 1 for e in self.edges]))


@dataclasses.dataclass
class Inputs:
    """Everything a run hands to the program and to the reference: the
    systematics trees (``{"Systematics": [...]}`` of the cross-section and
    the oscillation parameters, in θ's order), the samples, the indices of
    the six oscillation parameters, the NC modes (unit oscillation weight),
    the precision the configuration states and, once made, the Asimov data
    of each sample."""

    trees: list
    samples: list
    osc_param_index: list
    nc_modes: tuple
    precision: dict
    data: list | None = None

    @property
    def n_params(self) -> int:
        return sum(len(t["Systematics"]) for t in self.trees)


def norm_entry(name: str, error: float, **extra) -> dict:
    syst = {"Names": {"FancyName": name}, "ParameterValues": {"PreFitValue": 1.0},
            "StepScale": {"MCMC": 0.05}, "Error": error, "ParameterBounds": [0.0, 3.0],
            "Type": "Norm", "ParameterGroup": "Flux" if name.startswith("flux") else "Xsec"}
    syst.update(extra)
    return {"Systematic": syst}


def flux_and_xsec_norms(beam_samples: list, atmo_samples: list) -> list:
    """Flux norms in E_true bins per beam flavour (8 numu, 4 nue) and, where
    there are atmospheric samples, for them (8); cross-section norms by mode
    x target (8), NC and antineutrino: 30, or 22 without atmospheric
    samples."""
    out = []
    edges = np.linspace(0.0, 3.0, 9)
    for b in range(8):
        out.append(norm_entry(f"flux_numu_{b}", 0.08, NeutrinoFlavourUnosc=[14, -14],
                              KinematicCuts=[{"e_true": [float(edges[b]), float(edges[b + 1])]}],
                              SampleNames=beam_samples))
    edges = np.linspace(0.0, 3.0, 5)
    for b in range(4):
        out.append(norm_entry(f"flux_nue_{b}", 0.10, NeutrinoFlavourUnosc=[12, -12],
                              KinematicCuts=[{"e_true": [float(edges[b]), float(edges[b + 1])]}],
                              SampleNames=beam_samples))
    edges = np.geomspace(0.5, 100.0, 9)
    for b in range(8 if atmo_samples else 0):
        out.append(norm_entry(f"flux_atmo_{b}", 0.12,
                              KinematicCuts=[{"e_true": [float(edges[b]), float(edges[b + 1])]}],
                              SampleNames=atmo_samples))
    for mode, mname in [(MODE_CCQE, "ccqe"), (MODE_CCRES, "ccres"), (MODE_CCDIS, "ccdis"),
                        (MODE_NC, "nc")]:
        for tgt, tname in [(12, "C"), (16, "O")]:
            out.append(norm_entry(f"norm_{mname}_{tname}", 0.12, Mode=[mode], TargetNuclei=[tgt]))
    out.append(norm_entry("norm_nc_extra", 0.30, Mode=[MODE_NC]))
    out.append(norm_entry("norm_nubar", 0.10, NeutrinoFlavour=[-12, -14, -16]))
    return out


def spline_entry(i: int, mode: int, sample_names: list | None) -> dict:
    syst = {"Names": {"FancyName": f"spl_{i:03d}"}, "ParameterValues": {"PreFitValue": 0.0},
            "StepScale": {"MCMC": 0.1}, "Error": 0.2 + 0.1 * (i % 3),
            "ParameterBounds": [-3.0, 3.0], "Type": "Spline", "ParameterGroup": "Xsec",
            "Mode": [mode],
            "SplineInformation": {"SplineName": f"spl_{i:03d}",
                                  "InterpolationType": FAMILIES[i % 5]}}
    if sample_names:
        syst["SampleNames"] = list(sample_names)
    return {"Systematic": syst}


def escale_entry(name: str, sample: str) -> dict:
    return {"Systematic": {
        "Names": {"FancyName": name}, "ParameterValues": {"PreFitValue": 0.0},
        "StepScale": {"MCMC": 0.2}, "Error": 0.02, "ParameterBounds": [-0.3, 0.3],
        "Type": "Functional", "ParameterGroup": "Detector", "SampleNames": [sample]}}


def osc_tree() -> dict:
    """The six oscillation parameters (sin² parameterisation, MaCh3 order)."""
    entries = [
        ("sin2th12", 0.307, 0.013, [0.0, 1.0], 1.0, False),
        ("sin2th13", 0.0220, 0.0007, [0.0, 1.0], 1.0, False),
        ("sin2th23", 0.561, 0.03, [0.3, 0.7], 1.0, True),
        ("delta_cp", -1.601, 1.0, [-3.14159266, 3.14159266], 0.5, True),
        ("dm2_21", 7.42e-5, 2.1e-6, [6.0e-5, 9.0e-5], 1.0, False),
        ("dm2_31", 2.51e-3, 3.0e-5, [-5.0e-3, 5.0e-3], 1.0, False),
    ]
    out = []
    for name, prefit, err, bounds, step, flat in entries:
        syst = {"Names": {"FancyName": name}, "ParameterValues": {"PreFitValue": prefit},
                "StepScale": {"MCMC": step}, "Error": err, "ParameterBounds": bounds,
                "Type": "Osc", "ParameterGroup": "Osc"}
        if flat:
            syst["FlatPrior"] = True
        if name == "delta_cp":
            syst["SpecialProposal"] = {"CircularBounds": [-3.14159265, 3.14159265]}
        out.append({"Systematic": syst})
    return {"Systematics": out}


def _f32(x) -> np.ndarray:
    return np.asarray(x, np.float32)


@dataclasses.dataclass
class Events:
    kin: dict
    mode: np.ndarray
    target: np.ndarray
    pdg: np.ndarray
    preosc_pdg: np.ndarray
    mc_weight: np.ndarray

    def take(self, idx: np.ndarray) -> "Events":
        return Events({k: v[idx] for k, v in self.kin.items()}, self.mode[idx], self.target[idx],
                      self.pdg[idx], self.preosc_pdg[idx], self.mc_weight[idx])


def beam_events(rng: np.random.Generator, n: int) -> Events:
    """Beam MC: gamma-shaped E_true, 8% energy resolution, four modes,
    numu flux with nue appearance."""
    e_true = rng.gamma(shape=3.0, scale=0.25, size=n) + 0.05
    e_reco = np.clip(e_true * (1.0 + 0.08 * rng.normal(size=n)), 0.01, None)
    theta_reco = np.abs(rng.normal(0.0, 15.0, n)) + rng.uniform(0, 5, n)
    mode = rng.choice(MODES, p=[0.45, 0.25, 0.15, 0.15], size=n)
    target = rng.choice([12, 16], p=[0.6, 0.4], size=n)
    preosc = rng.choice([14, 12, -14], p=[0.90, 0.03, 0.07], size=n)
    det = preosc.copy()
    numu = np.nonzero(np.abs(preosc) == 14)[0]
    app = rng.random(len(numu)) < 0.25
    det[numu[app]] = np.sign(preosc[numu[app]]) * 12
    weight = np.where(np.abs(preosc) == 14, np.where(np.abs(det) == 12, 1 / 0.25, 1 / 0.75), 1.0)
    weight = weight * 50.0 / np.sqrt(np.maximum(e_true, 0.05))
    return Events({"e_true": _f32(e_true), "e_reco": _f32(e_reco), "theta_reco": _f32(theta_reco)},
                  mode.astype(np.int32), target.astype(np.int32), det.astype(np.int32),
                  preosc.astype(np.int32), _f32(weight / n * 2e5))


def atmo_events(rng: np.random.Generator, n: int) -> Events:
    """Atmospheric MC: a power-law flux, up/down symmetric zenith, 15%
    energy resolution."""
    e_true = np.clip(0.5 * (1.0 + rng.pareto(1.7, size=n)), 0.5, 100.0)
    e_reco = np.clip(e_true * (1.0 + 0.15 * rng.normal(size=n)), 0.3, 120.0)
    cosz = rng.uniform(-1.0, 1.0, n)
    cosz_reco = np.clip(cosz + 0.08 * rng.normal(size=n), -1.0, 1.0)
    mode = rng.choice(MODES, p=[0.40, 0.25, 0.20, 0.15], size=n)
    target = rng.choice([12, 16], p=[0.5, 0.5], size=n)
    preosc = rng.choice([14, -14, 12, -12], p=[0.40, 0.30, 0.18, 0.12], size=n)
    det = preosc.copy()
    mu = np.nonzero(np.abs(preosc) == 14)[0]
    app = rng.random(len(mu)) < 0.15
    det[mu[app]] = np.sign(preosc[mu[app]]) * 12
    weight = np.where(np.abs(preosc) == 14, np.where(np.abs(det) == 12, 1 / 0.15, 1 / 0.85), 1.0)
    weight = weight * (e_true / 2.0) ** (-1.0)
    return Events({"e_true": _f32(e_true), "e_reco": _f32(e_reco), "cos_zenith": _f32(cosz),
                   "cosz_reco": _f32(cosz_reco)},
                  mode.astype(np.int32), target.astype(np.int32), det.astype(np.int32),
                  preosc.astype(np.int32), _f32(weight / n * 1e5))


def spline_params(tree: dict, sample_name: str) -> list[tuple[int, list, str]]:
    """(index, modes, interpolation) of the spline parameters of ``tree``
    that apply to ``sample_name``."""
    out = []
    for i, entry in enumerate(tree["Systematics"]):
        s = entry["Systematic"]
        if s.get("Type") != "Spline":
            continue
        names = s.get("SampleNames") or []
        if names and sample_name not in names:
            continue
        out.append((i, list(s.get("Mode") or []),
                    s.get("SplineInformation", {}).get("InterpolationType", "TSpline3")))
    return out


def splines_for(rng: np.random.Generator, events: Events, tree: dict,
                sample_name: str) -> list[SplineInputs]:
    """Per-event knot responses of every spline parameter that applies to
    the sample, on the events of its modes: a slope of 6% ± 30% and a small
    curvature per sigma, clipped at 0, exactly 1 at the nominal knot."""
    out = []
    for index, modes, interp in spline_params(tree, sample_name):
        mask = np.isin(events.mode, modes) if modes else np.ones(len(events.mode), bool)
        affected = np.nonzero(mask)[0]
        if len(affected) == 0:
            continue
        n = len(affected)
        slope = 0.06 * (1.0 + 0.3 * rng.normal(size=n))
        curv = 0.008 * rng.normal(size=n)
        y = 1.0 + slope[:, None] * SIGMA_KNOTS[None, :] + curv[:, None] * SIGMA_KNOTS[None, :] ** 2
        y = np.clip(y, 0.0, None)
        y[:, 2] = 1.0
        out.append(SplineInputs(index, interp, affected.astype(np.int64), y))
    return out


def beam_sample(rng, name: str, events: Events, tree: dict, binning: str, e_grid,
                shift_index: int | None) -> SampleInputs:
    """A beam sample: ``binning`` "2d" (E_reco x theta_reco, 48 x 24) or
    "1d" (E_reco, 30 bins); an energy scale on E_reco when ``shift_index``."""
    if binning == "2d":
        edges, bin_vars = [np.linspace(0.0, 3.0, 49), np.linspace(0.0, 60.0, 25)], \
            ("e_reco", "theta_reco")
    else:
        edges, bin_vars = [np.linspace(0.0, 3.0, 31)], ("e_reco",)
    return SampleInputs(
        name, events.kin, events.mode, events.target, events.pdg, events.preosc_pdg,
        events.mc_weight, ("e_true", "e_reco", "theta_reco"), edges, bin_vars,
        splines_for(rng, events, tree, name),
        {"kind": "beam", "e_grid": np.asarray(e_grid, np.float64), "baseline_km": 295.0,
         "density": 2.6},
        None if shift_index is None else (shift_index, 1))


def atmo_sample(rng, name: str, events: Events, tree: dict, e_grid, cosz_grid) -> SampleInputs:
    """An atmospheric sample: log E_reco x cosZ_reco (40 x 25), layered
    PREM oscillation from a production height of 15 km."""
    return SampleInputs(
        name, events.kin, events.mode, events.target, events.pdg, events.preosc_pdg,
        events.mc_weight, ("e_true", "e_reco", "cos_zenith", "cosz_reco"),
        [np.geomspace(0.3, 120.0, 41), np.linspace(-1.0, 1.0, 26)], ("e_reco", "cosz_reco"),
        splines_for(rng, events, tree, name),
        {"kind": "atmo", "e_grid": np.asarray(e_grid, np.float64),
         "cosz_grid": np.asarray(cosz_grid, np.float64), "production_height_km": 15.0})


def index_of(tree: dict, name: str) -> int:
    return next(i for i, e in enumerate(tree["Systematics"])
                if e["Systematic"]["Names"]["FancyName"] == name)
