"""mach3-diag-torch — convergence diagnostics for a chain file (port of
``mach3_tpu/cli/diag.py``).

CLI equivalent of ``Diagnostics/DiagMCMC.cpp`` driving
``MCMCProcessor::DiagMCMC``: autocorrelation, ESS, batched means, Geweke,
power spectrum, acceptance-rate trace. ESS, Geweke, batched means and the
autocorrelation run on ``--device`` (the card by default, f64,
``diagnostics/autocorr.py``); R-hat is numpy on the host.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("chain")
    parser.add_argument("--burn-in", type=float, default=0.2)
    parser.add_argument("--max-lag", type=int, default=500)
    parser.add_argument("--output", "-o", default=None)
    from .common import add_common_args, setup_platform

    add_common_args(parser)
    args = parser.parse_args(argv)
    device = setup_platform(args)

    from ..diagnostics.autocorr import (
        autocorrelation_fft,
        batched_means_variance_ratio,
        effective_sample_size,
        geweke,
    )
    from ..diagnostics.chain_io import load_chain
    from ..diagnostics.rhat import folded_rhat, split_rhat

    draws, meta, _ = load_chain(args.chain)
    theta = draws["theta"]  # [S, C, P]
    if theta.ndim == 2:
        theta = theta[:, None, :]
    s = theta.shape[0]
    start = int(args.burn_in * s)
    kept = theta[start:]
    names = meta["names"]

    # per-chain-averaged series for autocorr/ESS; cross-chain for R-hat
    pooled = kept.reshape(kept.shape[0], -1, kept.shape[-1])
    flatish = pooled.mean(axis=1)
    ess = effective_sample_size(pooled.reshape(pooled.shape[0], -1), device=device)
    ess = ess.cpu().numpy().reshape(pooled.shape[1], pooled.shape[2]).sum(axis=0)
    z = geweke(flatish, device=device).cpu().numpy()
    rh = np.asarray(split_rhat(kept)) if kept.shape[1] > 1 else np.full(len(names), np.nan)
    frh = np.asarray(folded_rhat(kept)) if kept.shape[1] > 1 else np.full(len(names), np.nan)
    bm = batched_means_variance_ratio(flatish, device=device).cpu().numpy()

    print(f"{'parameter':<28} {'ESS':>9} {'Geweke z':>9} {'split-Rhat':>11} {'folded':>8} {'BM ratio':>9}")
    for i, n in enumerate(names):
        print(f"{n:<28} {ess[i]:>9.0f} {z[i]:>9.2f} {rh[i]:>11.3f} {frh[i]:>8.3f} {bm[i]:>9.1f}")

    worst = np.nanmax(rh)
    print(f"\nworst split-Rhat: {worst:.3f} ({'CONVERGED' if worst < 1.05 else 'NOT CONVERGED'})")

    if args.output:
        rho = autocorrelation_fft(flatish, max_lag=args.max_lag, device=device).cpu().numpy()
        np.savez(
            args.output,
            names=np.asarray(names),
            ess=ess,
            geweke=z,
            split_rhat=rh,
            folded_rhat=frh,
            batched_means_ratio=bm,
            autocorrelation=rho,
        )
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
