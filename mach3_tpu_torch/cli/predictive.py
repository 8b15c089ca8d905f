"""mach3-predictive-torch — prior/posterior predictive spectra and p-values
(port of ``mach3_tpu/cli/predictive.py``).

CLI equivalent of the reference's predictive pipeline
(``Fitters/PredictiveThrower``, ``Plotting/PredictivePlotting.cpp``). Builds
a registry experiment (``--experiment``, default the toy) on ``--device``
(the card by default) and runs the toys through each sample's reweight
kernel, the toys on the chain axis (``diagnostics/predictive.py``).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("chain", help="Chain .npz to draw parameter sets from")
    parser.add_argument("--toys", type=int, default=500)
    parser.add_argument("--burn-in", type=float, default=0.2)
    parser.add_argument("--output", "-o", default="predictive.npz")
    parser.add_argument("--experiment", default="toy")
    parser.add_argument("--n-events", type=int, default=20000)
    from .common import add_common_args, setup_platform

    add_common_args(parser)
    args = parser.parse_args(argv)
    device = setup_platform(args)

    from ..diagnostics.chain_io import load_chain
    from ..diagnostics.predictive import draw_parameter_sets, run_predictive
    from ..samples.registry import build_experiment

    draws, meta, _ = load_chain(args.chain)
    exp = build_experiment(args.experiment, n_events=args.n_events, device=device)
    rng = np.random.default_rng(args.seed)
    toys = draw_parameter_sets(draws["theta"], args.toys, rng, burn_in=args.burn_in)
    categories = getattr(exp, "event_modes", None)
    res = run_predictive(exp.model, toys, seed=args.seed, categories=categories)

    print(f"posterior-predictive p-value: {res.p_value:.3f}")
    for s, p in zip(exp.samples, res.p_value_per_sample):
        print(f"  {s.name:<24} p = {p:.3f}")
    # SampleSummary's fluctuation battery (both directions + rate-only)
    print(
        f"fluctuated p-values: pred-vs-draw {res.p_value_fluct_pred:.3f}  "
        f"data-vs-draw {res.p_value_fluct_data:.3f}  "
        f"rate-only {res.p_value_rate:.3f}"
    )

    out = {
        "llh_data": res.llh_data,
        "llh_draw": res.llh_draw,
        "llh_fluctpred_vs_draw": res.llh_fluctpred_vs_draw,
        "llh_data_vs_fluctdraw": res.llh_data_vs_fluctdraw,
        "llh_fluctdata_vs_draw": res.llh_fluctdata_vs_draw,
        "llh_fluctdraw_vs_pred": res.llh_fluctdraw_vs_pred,
        "p_value": np.asarray(res.p_value),
        "p_value_per_sample": res.p_value_per_sample,
        "p_value_fluct_pred": np.asarray(res.p_value_fluct_pred),
        "p_value_fluct_data": np.asarray(res.p_value_fluct_data),
        "p_value_rate": np.asarray(res.p_value_rate),
    }
    for i, s in enumerate(exp.samples):
        out[f"spectra_{s.name}"] = res.spectra[i]
        out[f"band_{s.name}"] = res.predictive_band(i)
        out[f"violin_{s.name}"] = res.violin(i)
        out[f"p_per_bin_{s.name}"] = res.p_value_per_bin[i]
        out[f"data_{s.name}"] = s.data.cpu().numpy()
        if res.spectra_by_mode is not None:
            out[f"by_mode_{s.name}"] = res.spectra_by_mode[i]
    np.savez(args.output, **out)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
