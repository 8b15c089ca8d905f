"""A beam-only fit at one detector (``beam1det.json``): numu_beam (E_reco x
theta_reco, 48 x 24 bins) and nue_beam (30 E_reco bins, an energy scale).
22 flux and cross-section norms, 43 splines on both samples cycling the
five interpolation families and four modes (the NC ones touch only
nue_beam), one energy scale and 6 oscillation parameters: 72, each read by
some sample."""
from __future__ import annotations

import numpy as np

from .. import fixtures as fx

BEAM = ["numu_beam", "nue_beam"]


def xsec_tree(n_splines: int) -> dict:
    syst = fx.flux_and_xsec_norms(BEAM, [])
    syst += [fx.spline_entry(i, fx.MODES[i % 4], BEAM) for i in range(n_splines)]
    syst.append(fx.escale_entry("escale_nue", "nue_beam"))
    return {"Systematics": syst}


def build(spec: dict, seed: int) -> fx.Inputs:
    rng = np.random.default_rng(seed)
    tree = xsec_tree(spec["n_splines"])
    n_xsec = len(tree["Systematics"])
    e_grid = np.linspace(0.05, 3.0, spec["e_grid_size"])
    beam = fx.beam_events(rng, spec["n_beam_generated"])
    numu = np.nonzero((np.abs(beam.pdg) == 14) & (beam.mode != fx.MODE_NC))[0]
    nue = np.nonzero((np.abs(beam.pdg) == 12) | (beam.mode == fx.MODE_NC))[0]
    if len(numu) < spec["n_numu"] or len(nue) < spec["n_nue"]:
        raise ValueError(f"seed {seed}: too few beam events selected")
    samples = [
        fx.beam_sample(rng, "numu_beam", beam.take(numu[:spec["n_numu"]]), tree, "2d", e_grid,
                       None),
        fx.beam_sample(rng, "nue_beam", beam.take(nue[:spec["n_nue"]]), tree, "1d", e_grid,
                       fx.index_of(tree, "escale_nue")),
    ]
    return fx.Inputs([tree, fx.osc_tree()], samples, list(range(n_xsec, n_xsec + 6)),
                     (fx.MODE_NC,), dict(spec["precision"]))
