"""mach3-process-torch — posterior processing of a chain file (port of
``mach3_tpu/cli/process.py``).

CLI equivalent of ``Diagnostics/ProcessMCMC.cpp``: 1D summaries (arithmetic /
Gaussian / HPD), credible intervals, posterior covariance/correlation, text +
npz outputs (plots: the JAX package's mach3-plot).

The work is numpy on the host. ``--device`` (default cuda) is checked as in
every CLI of this package; it names no device that the work runs on.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("chain", help="Chain .npz file")
    parser.add_argument("--burn-in", type=float, default=0.2)
    parser.add_argument("--thin", type=int, default=1)
    parser.add_argument("--output", "-o", default=None, help="npz output of summaries")
    parser.add_argument("--credible", type=float, nargs="*", default=[0.6827, 0.9545])
    parser.add_argument(
        "--smear",
        nargs="*",
        default=None,
        metavar="NAME=SIGMA",
        help="Smear parameters with extra Gaussian sigma (SmearChain equivalent)",
    )
    parser.add_argument(
        "--reweight-prior",
        nargs=3,
        default=None,
        metavar=("NAME", "MEAN", "SIGMA"),
        help="Reweight the chain to a new Gaussian prior on NAME "
        "(ReweightMCMC equivalent; old prior assumed flat)",
    )
    parser.add_argument(
        "--jarlskog",
        action="store_true",
        help="Run the Jarlskog-invariant analysis (OscProcessor equivalent)",
    )
    from .common import add_common_args, setup_platform

    add_common_args(parser)
    args = parser.parse_args(argv)
    setup_platform(args)

    from ..diagnostics.chain_io import load_chain
    from ..diagnostics.chaintools import reweight_to_new_prior, smear_chain
    from ..diagnostics.processor import ChainProcessor

    draws, meta, _ = load_chain(args.chain)
    theta = draws["theta"]
    if args.smear:
        sigmas = {}
        for spec in args.smear:
            name, sig = spec.split("=")
            sigmas[meta["names"].index(name)] = float(sig)
        s, c, p = theta.shape
        theta = smear_chain(theta.reshape(-1, p), sigmas, seed=args.seed).reshape(s, c, p)
        print(f"smeared {len(sigmas)} parameter(s)")
    proc = ChainProcessor(
        theta, names=meta["names"], burn_in=args.burn_in, thin=args.thin
    )
    if args.reweight_prior:
        name, mean, sigma = args.reweight_prior
        idx = meta["names"].index(name)
        w = reweight_to_new_prior(proc.flat, idx, None, (float(mean), float(sigma)))
        proc.weights = proc.weights * w
        print(f"reweighted to prior N({mean}, {sigma}) on {name}")
    print(f"{'parameter':<28} {'mean':>10} {'std':>9} {'HPD mode':>10} {'-err':>8} {'+err':>8}")
    rows = []
    for i in range(proc.n_params):
        s = proc.summary(i)
        print(
            f"{s.name:<28} {s.arithmetic_mean:>10.5g} {s.arithmetic_std:>9.3g} "
            f"{s.hpd_mode:>10.5g} {s.hpd_err_low:>8.3g} {s.hpd_err_high:>8.3g}"
        )
        rows.append(
            [s.arithmetic_mean, s.arithmetic_std, s.gaussian_mean, s.gaussian_std,
             s.hpd_mode, s.hpd_err_low, s.hpd_err_high, s.median]
        )
    intervals = {
        f"ci_{int(m*1e4)}": np.array(
            [proc.credible_interval(i, mass=m) for i in range(proc.n_params)]
        )
        for m in args.credible
    }
    if args.jarlskog:
        from ..diagnostics.oscprocessor import OscProcessor

        oproc = OscProcessor(theta, meta["names"], burn_in=args.burn_in)
        res = oproc.jarlskog_analysis()
        print(f"\nJarlskog: P(normal ordering) = {res.p_normal_ordering:.3f}")
        for mass, excluded in res.p_cp_conserving_excluded.items():
            print(f"  J=0 {'excluded' if excluded else 'allowed'} at {mass:.4f} credibility")
        table = oproc.ordering_octant_table()
        for k, v in table.items():
            print(f"  {k:<10} {v:.3f}")
    if args.output:
        np.savez(
            args.output,
            summary=np.asarray(rows),
            names=np.asarray(proc.names),
            covariance=proc.covariance(),
            correlation=proc.correlation(),
            **intervals,
        )
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
