"""A beam-only fit over two detectors (``beam2det.json``): at each, a numu
sample (E_reco x theta_reco, 48 x 24 bins) and a nue sample (30 E_reco
bins, its own energy scale). 26 norms (22 flux and cross-section, one per
sample), 376 splines dealt round-robin to the four samples (94 each; the
numu samples' to a CC mode), 2 energy scales and 6 oscillation parameters:
410, each read by some sample."""
from __future__ import annotations

import numpy as np

from .. import fixtures as fx

BEAM = ["numu_a", "nue_a", "numu_b", "nue_b"]


def xsec_tree(n_splines: int) -> dict:
    syst = fx.flux_and_xsec_norms(BEAM, [])
    syst += [fx.norm_entry(f"det_{s}", 0.05, SampleNames=[s]) for s in BEAM]
    for i in range(n_splines):
        sample, j = BEAM[i % 4], i // 4
        mode = fx.MODES[j % 3] if sample.startswith("numu") else fx.MODES[j % 4]
        syst.append(fx.spline_entry(i, mode, [sample]))
    syst += [fx.escale_entry(f"escale_{s}", s) for s in ("nue_a", "nue_b")]
    return {"Systematics": syst}


def build(spec: dict, seed: int) -> fx.Inputs:
    rng = np.random.default_rng(seed)
    tree = xsec_tree(spec["n_splines"])
    n_xsec = len(tree["Systematics"])
    e_grid = np.linspace(0.05, 3.0, spec["e_grid_size"])
    samples = []
    for det in ("a", "b"):
        beam = fx.beam_events(rng, spec["n_beam_generated"])
        numu = np.nonzero((np.abs(beam.pdg) == 14) & (beam.mode != fx.MODE_NC))[0]
        nue = np.nonzero((np.abs(beam.pdg) == 12) | (beam.mode == fx.MODE_NC))[0]
        if len(numu) < spec["n_numu"] or len(nue) < spec["n_nue"]:
            raise ValueError(f"seed {seed}: too few beam events selected for detector {det}")
        samples.append(fx.beam_sample(rng, f"numu_{det}", beam.take(numu[:spec["n_numu"]]),
                                      tree, "2d", e_grid, None))
        samples.append(fx.beam_sample(rng, f"nue_{det}", beam.take(nue[:spec["n_nue"]]), tree,
                                      "1d", e_grid, fx.index_of(tree, f"escale_nue_{det}")))
    return fx.Inputs([tree, fx.osc_tree()], samples, list(range(n_xsec, n_xsec + 6)),
                     (fx.MODE_NC,), dict(spec["precision"]))
