"""The parameters as the systematics trees state them, read without the
program: prior means and widths, bounds, flat priors, the circular bound of
δCP, and which events each normalisation matches."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Params:
    names: list
    types: list
    prefit: np.ndarray
    error: np.ndarray
    step: np.ndarray
    low: np.ndarray
    high: np.ndarray
    flat: np.ndarray
    fixed: np.ndarray
    circ: np.ndarray
    circ_low: np.ndarray
    circ_high: np.ndarray
    block: np.ndarray  # index of the tree each parameter comes from
    entries: list  # the raw "Systematic" dicts


def read(trees: list) -> Params:
    entries, block = [], []
    for b, tree in enumerate(trees):
        for e in tree["Systematics"]:
            s = e["Systematic"]
            if s.get("Correlations") or s.get("FixParam") or "FlipParameter" in (
                    s.get("SpecialProposal") or {}):
                raise ValueError(f"{s['Names']['FancyName']}: correlations, fixed parameters "
                                 "and flips are not in the reference")
            entries.append(s)
            block.append(b)
    n = len(entries)

    def arr(f):
        return np.array([f(s) for s in entries], np.float64)

    circ = np.array(["CircularBounds" in (s.get("SpecialProposal") or {}) for s in entries])
    cb = [(s.get("SpecialProposal") or {}).get("CircularBounds", [0.0, 0.0]) for s in entries]
    return Params(
        names=[s["Names"]["FancyName"] for s in entries], types=[s["Type"] for s in entries],
        prefit=arr(lambda s: s["ParameterValues"]["PreFitValue"]), error=arr(lambda s: s["Error"]),
        step=arr(lambda s: s["StepScale"]["MCMC"]),
        low=arr(lambda s: s["ParameterBounds"][0]), high=arr(lambda s: s["ParameterBounds"][1]),
        flat=np.array([bool(s.get("FlatPrior", False)) for s in entries]),
        fixed=np.zeros(n, bool), circ=circ,
        circ_low=np.array([c[0] for c in cb], np.float64),
        circ_high=np.array([c[1] for c in cb], np.float64),
        block=np.asarray(block), entries=entries)


def norm_matches(params: Params, sample) -> tuple[np.ndarray, np.ndarray]:
    """(event index, parameter index) of every normalisation that applies to
    an event of ``sample``: its sample list (empty: all), modes, detected and
    unoscillated flavours, targets and kinematic cuts [low, high) on the
    nominal kinematics (empty lists match everything)."""
    ev, par = [], []
    for i, s in enumerate(params.entries):
        if s["Type"] != "Norm":
            continue
        names = s.get("SampleNames") or []
        if names and sample.name not in names:
            continue
        m = np.ones(sample.n_events, bool)
        for key, values in (("Mode", sample.mode), ("NeutrinoFlavour", sample.pdg),
                            ("NeutrinoFlavourUnosc", sample.preosc_pdg),
                            ("TargetNuclei", sample.target)):
            if s.get(key):
                m &= np.isin(values, [int(v) for v in s[key]])
        for cut in s.get("KinematicCuts") or []:
            for var, (lo, hi) in cut.items():
                x = sample.kin[var]
                m &= (x >= lo) & (x < hi)
        idx = np.nonzero(m)[0]
        ev.append(idx)
        par.append(np.full(len(idx), i))
    if not ev:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    return np.concatenate(ev).astype(np.int64), np.concatenate(par).astype(np.int64)
