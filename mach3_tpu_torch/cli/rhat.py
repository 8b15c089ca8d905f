"""mach3-rhat-torch — Gelman-Rubin R-hat across chain files (port of
``mach3_tpu/cli/rhat.py``).

CLI equivalent of ``Diagnostics/RHat.cpp`` (streaming accumulators) and
``RHat_HighMem.cpp`` (folded variant): accepts N chain files, each holding one
or more chains; reports plain / split / folded R-hat per parameter.

The work is numpy on the host. ``--device`` (default cuda) is checked as in
every CLI of this package; it names no device that the work runs on.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("chains", nargs="+", help="Chain .npz files")
    parser.add_argument("--burn-in", type=float, default=0.2)
    parser.add_argument("--folded", action="store_true", help="Also compute folded R-hat")
    from .common import add_common_args, setup_platform

    add_common_args(parser)
    args = parser.parse_args(argv)
    setup_platform(args)

    from ..diagnostics.chain_io import load_chain
    from ..diagnostics.rhat import folded_rhat, rhat, split_rhat

    all_chains = []
    names = None
    for p in args.chains:
        draws, meta, _ = load_chain(p)
        theta = draws["theta"]
        if theta.ndim == 2:
            theta = theta[:, None, :]
        if names is None:
            names = meta["names"]
        elif names != meta["names"]:
            print(f"ERROR: parameter names differ in {p}", file=sys.stderr)
            return 1
        start = int(args.burn_in * theta.shape[0])
        all_chains.append(theta[start:])

    s = min(c.shape[0] for c in all_chains)  # truncate to shortest (RHat.cpp)
    merged = np.concatenate([c[:s] for c in all_chains], axis=1)
    n_chains = merged.shape[1]
    if n_chains < 2:
        print("ERROR: need at least 2 chains for R-hat", file=sys.stderr)
        return 1

    r = np.asarray(rhat(merged))
    sr = np.asarray(split_rhat(merged))
    fr = np.asarray(folded_rhat(merged)) if args.folded else None

    header = f"{'parameter':<28} {'R-hat':>8} {'split':>8}" + (f" {'folded':>8}" if args.folded else "")
    print(f"{n_chains} chains x {s} steps\n{header}")
    for i, n in enumerate(names):
        line = f"{n:<28} {r[i]:>8.4f} {sr[i]:>8.4f}"
        if fr is not None:
            line += f" {fr[i]:>8.4f}"
        print(line)
    worst = sr.max()
    print(f"\nworst split-R-hat: {worst:.4f} ({'CONVERGED' if worst < 1.05 else 'NOT CONVERGED'})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
