"""The toy experiment written as the files of the YAML experiment schema
(``samples/experiment.py``, ``docs/TUTORIAL.md`` §3), for
``build_experiment``.

``write_experiment(dir)`` writes, from seeded numpy draws only, a
systematics YAML, an oscillation YAML, per-sample ``.npz`` MC, spline and
TF1 files and the experiment YAML, and returns the experiment YAML's path.
It builds nothing. The events and spline responses are the toy's
(``tutorial/toy.py``: the same generator, seed and order of draws as
``build_toy``), plus a ``cos_theta`` column from a generator of its own
(seed + 1) and TF1 responses from another (seed + 2), so the toy's draws do
not move. Three samples:

* ``numu_2d``: the numu selection, 30 x 8 uniform bins over (e_reco,
  cos_theta), beam oscillation, an energy scale on e_reco and an offset on
  cos_theta: two shifts, so its bins are per chain (the generic route);
* ``nue_nonuniform``: the nue selection (NC included), 20 hyper-rectangle
  bins over (e_reco, cos_theta), finer near the appearance peak, with one
  gap; oscillation, a TF1 response on a third of its events and the energy
  scale: a custom binning with a shift, per-chain bins again;
* ``numu_nd``: the numu selection with no oscillation and no shift, 30
  e_reco bins and a resolution-scale weight function on the CC QE and RES
  modes: static bins, the shared route with P = 4.

19 parameters: the toy's 5 norms, 4 splines and energy scale, three more
functional parameters (``ctheta_offset``, ``tf1_pion``, ``eres_scale``) and
the 6 oscillation parameters. Asimov data.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import yaml

from ..core.config import Config
from ..params.parameterset import ParameterSet
from .toy import MODE_CCQE, MODE_CCRES, MODE_NC, _generate_events, _spline_specs
from .toy import osc_config_yaml, xsec_config

BASELINE_KM = 295.0
DENSITY = 2.6

#: The extra functional parameters: (name, error, bounds, group, extra keys).
FUNCTIONAL = [
    ("ctheta_offset", 0.02, [-0.2, 0.2], "Detector", {}),
    ("tf1_pion", 1.0, [-3.0, 3.0], "Xsec", {}),
    ("eres_scale", 0.2, [-0.5, 0.5], "Detector", {"Mode": [MODE_CCQE, MODE_CCRES]}),
]


def nue_bins() -> list:
    """20 hyper-rectangles [bin][axis][low, high] over (e_reco, cos_theta):
    narrow e_reco bins split in cos_theta around the appearance peak (~0.6
    GeV), wide ones elsewhere, and no bin for e_reco < 0.3 with
    cos_theta < 0 (a gap: those events fall in the garbage bin)."""
    bins = [[[0.0, 0.3], [0.0, 1.0]]]
    for lo, hi in [(0.3, 0.45), (0.75, 0.9), (0.9, 1.2), (1.2, 1.6)]:
        bins += [[[lo, hi], [-1.0, 0.6]], [[lo, hi], [0.6, 1.0]]]
    for lo, hi in [(0.45, 0.55), (0.55, 0.65), (0.65, 0.75)]:
        bins += [[[lo, hi], c] for c in ([-1.0, 0.5], [0.5, 0.8], [0.8, 1.0])]
    bins += [[[1.6, 2.2], [-1.0, 1.0]], [[2.2, 3.0], [-1.0, 1.0]]]
    return bins


def _systematics() -> dict:
    out = xsec_config()
    for name, err, bounds, group, extra in FUNCTIONAL:
        out["Systematics"].append({"Systematic": {
            "Names": {"FancyName": name},
            "ParameterValues": {"PreFitValue": 0.0},
            "StepScale": {"MCMC": 0.2},
            "Error": err,
            "ParameterBounds": bounds,
            "Type": "Functional",
            "ParameterGroup": group,
            **extra,
        }})
    return out


def _write_yaml(path: Path, tree: dict) -> str:
    path.write_text(yaml.safe_dump(tree, sort_keys=False))
    return str(path)


def write_experiment(directory, n_events: int = 100_000, seed: int = 42) -> Path:
    """Write the experiment's files into ``directory`` (created if needed)
    and return the path of its experiment YAML."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    events = _generate_events(rng, n_events)
    xsec = ParameterSet.from_config(Config(xsec_config()), name="xsec")
    splines = _spline_specs(rng, events, xsec, offset=0)
    cos_theta = 1.0 - 2.0 * np.random.default_rng(seed + 1).beta(1.2, 3.0, n_events)
    tf1_rng = np.random.default_rng(seed + 2)

    numu = np.nonzero((np.abs(events.pdg) == 14) & (events.mode != MODE_NC))[0]
    nue = np.nonzero((np.abs(events.pdg) == 12) | (events.mode == MODE_NC))[0]

    def write_sample(name: str, idx: np.ndarray, tf1: bool = False) -> dict:
        np.savez(d / f"{name}_mc.npz", cos_theta=cos_theta[idx], mode=events.mode[idx],
                 target=events.target[idx], pdg=events.pdg[idx],
                 preosc_pdg=events.preosc_pdg[idx], mc_weight=events.mc_weight[idx],
                 **{k: v[idx] for k, v in events.kinematics.items()})
        remap = np.full(n_events, -1, np.int64)
        remap[idx] = np.arange(len(idx))
        arrays = {}
        for spec in splines:
            keep = remap[spec.event_ids] >= 0
            arrays[f"{spec.name}:knots"] = spec.x_knots
            arrays[f"{spec.name}:event_ids"] = remap[spec.event_ids[keep]]
            arrays[f"{spec.name}:y"] = spec.y_knots[keep]
        np.savez(d / f"{name}_splines.npz", **arrays)
        files = {"MCFile": str(d / f"{name}_mc.npz"),
                 "VarOrder": ["e_true", "e_reco", "cos_theta"],
                 "SplineFile": str(d / f"{name}_splines.npz")}
        if tf1:
            # A pion-production response on a third of the events; 2% of
            # them steep enough to reach the floor at 0 within the bounds.
            ev = np.sort(tf1_rng.choice(len(idx), size=len(idx) // 3, replace=False))
            slope = 0.15 * (1.0 + 0.3 * tf1_rng.normal(size=len(ev)))
            slope[tf1_rng.random(len(ev)) < 0.02] = 0.5
            np.savez(d / f"{name}_tf1.npz", **{"tf1_pion:event_ids": ev,
                                               "tf1_pion:slope": slope,
                                               "tf1_pion:intercept": np.ones(len(ev))})
            files["TF1File"] = str(d / f"{name}_tf1.npz")
        return files

    osc = {"EGrid": {"Low": 0.05, "High": 3.0, "N": 200, "Log": False},
           "Baseline": BASELINE_KM, "Density": DENSITY, "NCModes": [MODE_NC],
           "PhaseDtype": "float32"}
    escale = {"Function": "scale", "Parameter": "escale", "Var": "e_reco"}
    samples = [
        {"Name": "numu_2d", **write_sample("numu_2d", numu),
         "Binning": {"Vars": ["e_reco", "cos_theta"],
                     "Uniform": [{"Low": 0.0, "High": 3.0, "N": 30},
                                 {"Low": -1.0, "High": 1.0, "N": 8}]},
         "Oscillation": osc,
         "Shifts": [escale, {"Function": "offset", "Parameter": "ctheta_offset",
                             "Var": "cos_theta"}]},
        {"Name": "nue_nonuniform", **write_sample("nue_nonuniform", nue, tf1=True),
         "Binning": {"Vars": ["e_reco", "cos_theta"], "NonUniformBins": nue_bins()},
         "Oscillation": osc,
         "Shifts": [escale]},
        {"Name": "numu_nd", **write_sample("numu_nd", numu),
         "Binning": {"Vars": ["e_reco"], "Uniform": [{"Low": 0.0, "High": 3.0, "N": 30}]},
         "WeightFunctions": [{"Function": "res_scale_weight", "Parameter": "eres_scale",
                              "Var": "e_reco",
                              "Args": {"true_var": "e_true", "sigma_frac": 0.35}}]},
    ]
    experiment = {"Experiment": {
        "Systematics": [
            {"File": _write_yaml(d / "xsec.yaml", _systematics()), "Name": "xsec"},
            {"File": _write_yaml(d / "osc.yaml", osc_config_yaml()), "Name": "osc"},
        ],
        "Samples": samples,
        "Data": "Asimov",
    }}
    path = d / "experiment.yaml"
    _write_yaml(path, experiment)
    return path
