"""mach3-llhscan-torch — likelihood scans and sigma variations on the toy model
(port of ``mach3_tpu/cli/llhscan.py``; the reference's
``FitterBase::RunLLHScan`` and ``Plotting/PlotLLH``).

Builds the toy (``Toy:NEvents``, ``Toy:Seed``) on ``--device`` (the card by
default), scans every parameter, optionally a 2-D pair and each sample's
±σ spectra, and writes them into one ``.npz``.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("configs", nargs="*", help="YAML configs and Key:Sub:Value overrides")
    parser.add_argument("--output", "-o", default="llhscan.npz")
    parser.add_argument("--points", type=int, default=41)
    parser.add_argument("--sigma", type=float, default=3.0)
    parser.add_argument("--scan-2d", nargs=2, metavar=("PX", "PY"), default=None)
    parser.add_argument("--sigma-var", action="store_true")
    from .common import add_common_args, setup_platform

    add_common_args(parser)
    args = parser.parse_args(argv)
    device = setup_platform(args)

    from ..fitters.factory import manager_from_args
    from ..fitters.scans import llh_scan_1d, llh_scan_2d, sigma_variations
    from ..tutorial.toy import build_toy

    cfg = manager_from_args(args.configs)
    toy = build_toy(n_events=int(cfg.get("Toy.NEvents", 20000)),
                    seed=int(cfg.get("Toy.Seed", 1234)), device=device)

    out = {}
    scan = llh_scan_1d(toy.model, n_points=args.points, n_sigma=args.sigma)
    out.update({f"scan1d_{k}": v for k, v in scan.items()})
    print(f"{'parameter':<28} {'min at':>10} {'curvature ok':>13}")
    for i, name in enumerate(toy.names):
        t = scan["total"][i]
        imin = int(np.argmin(t))
        ok = t[0] > t[imin] and t[-1] > t[imin]
        print(f"{name:<28} {scan['values'][i][imin]:>10.5g} {str(ok):>13}")

    if args.scan_2d:
        ix, iy = (toy.names.index(p) for p in args.scan_2d)
        s2 = llh_scan_2d(toy.model, ix, iy, n_points=max(21, args.points // 2))
        out.update({f"scan2d_{k}": v for k, v in s2.items()})

    if args.sigma_var:
        for si, s in enumerate(toy.samples):
            sv = sigma_variations(toy.model, sample_index=si)
            out.update({f"sigvar_{s.name}_{k}": v for k, v in sv.items()})

    np.savez(args.output, names=np.asarray(toy.names), **out)
    print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
