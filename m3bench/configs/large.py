"""The reference-scale beam + atmospheric fit (``large.json``): numu_beam
(E_reco x theta_reco, 48 x 24 bins), nue_beam (30 E_reco bins, an energy
scale) and atmo (log E_reco x cosZ_reco, 40 x 25 bins, layered PREM). 30
norms, 64 splines cycling the five interpolation families and four modes
(every third beam-only, every third atmospheric-only), one energy scale and
6 oscillation parameters: 101."""
from __future__ import annotations

import numpy as np

from .. import fixtures as fx

BEAM = ["numu_beam", "nue_beam"]
ATMO = ["atmo"]


def xsec_tree(n_splines: int) -> dict:
    syst = fx.flux_and_xsec_norms(BEAM, ATMO)
    for i in range(n_splines):
        names = BEAM if i % 3 == 1 else ATMO if i % 3 == 2 else None
        syst.append(fx.spline_entry(i, fx.MODES[i % 4], names))
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
    samples.append(fx.atmo_sample(rng, "atmo", fx.atmo_events(rng, spec["n_atmo"]), tree,
                                  np.geomspace(0.5, 100.0, spec["atmo_e_grid_size"]),
                                  np.linspace(-0.99, 0.99, spec["atmo_cosz_grid_size"])))
    return fx.Inputs([tree, fx.osc_tree()], samples, list(range(n_xsec, n_xsec + 6)),
                     (fx.MODE_NC,), dict(spec["precision"]))
