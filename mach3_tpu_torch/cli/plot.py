"""mach3-plot-torch — render plots from chain / scan / diagnostic outputs
(port of ``mach3_tpu/cli/plot.py``).

CLI equivalent of the reference's plotting executables
(``GetPostfitParamPlots``, ``PlotLLH``, ``PlotMCMCDiag``, ``MatrixPlotter``,
triangle/violin outputs of ``ProcessMCMC``). Host code: numpy and
matplotlib, which it needs (it exits naming matplotlib without it).
"""
from __future__ import annotations

import argparse
import importlib.util
import os
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "chain",
        nargs="+",
        help="Chain .npz file(s); extra chains overlay in a comparison plot "
        "(the reference ProcessMCMC multi-chain mode)",
    )
    parser.add_argument("--outdir", "-o", default="plots")
    parser.add_argument("--burn-in", type=float, default=0.2)
    parser.add_argument("--triangle", nargs="*", default=None,
                        help="Parameter names for a triangle plot")
    parser.add_argument("--scan", default=None, help="LLH-scan npz to overlay")
    parser.add_argument("--diag", default=None, help="mach3-diag npz output")
    parser.add_argument("--sigma-var", default=None,
                        help="mach3-llhscan --sigma-var npz to render")
    parser.add_argument("--style", default=None,
                        help="Style YAML (palette, rcParams, pretty names) — "
                        "the reference StyleManager config")
    args = parser.parse_args(argv)
    if importlib.util.find_spec("matplotlib") is None:
        raise SystemExit("mach3-plot-torch needs matplotlib, which is not installed")

    from ..plotting.style import StyleManager

    StyleManager(args.style).apply()

    from ..diagnostics.chain_io import load_chain
    from ..diagnostics.processor import ChainProcessor
    from ..plotting import (
        plot_diagnostics,
        plot_llh_scans,
        plot_matrix,
        plot_posteriors_1d,
        plot_prefit_postfit,
        plot_sigma_variations,
        plot_triangle,
        plot_violins,
    )

    os.makedirs(args.outdir, exist_ok=True)
    draws, meta, _ = load_chain(args.chain[0])
    proc = ChainProcessor(draws["theta"], names=meta["names"], burn_in=args.burn_in)

    written = []

    def save(fig, name):
        import matplotlib.pyplot as plt

        path = os.path.join(args.outdir, name)
        fig.savefig(path, dpi=120)
        plt.close(fig)
        written.append(path)

    save(plot_posteriors_1d(proc), "posteriors_1d.png")
    save(plot_violins(proc), "violins.png")

    if len(args.chain) > 1:
        from ..plotting import plot_posterior_comparison

        procs = [proc]
        labels = [os.path.basename(args.chain[0])]
        for path in args.chain[1:]:
            d, m, _ = load_chain(path)
            procs.append(
                ChainProcessor(d["theta"], names=m["names"], burn_in=args.burn_in)
            )
            labels.append(os.path.basename(path))
        save(plot_posterior_comparison(procs, labels), "posterior_comparison.png")
    save(plot_matrix(proc.correlation(), proc.names, "posterior correlation"), "correlation.png")

    if "prefit" in meta:
        save(
            plot_prefit_postfit(
                proc.names,
                np.asarray(meta["prefit"], float),
                np.asarray(meta["prefit_err"], float),
                proc.summaries(),
            ),
            "prefit_postfit.png",
        )

    if args.triangle:
        idx = [proc.names.index(n) for n in args.triangle]
        save(plot_triangle(proc, idx), "triangle.png")

    if args.scan:
        with np.load(args.scan, allow_pickle=False) as f:
            scan = {k[7:]: f[k] for k in f.files if k.startswith("scan1d_")}
            names = [str(n) for n in f["names"]]
        save(plot_llh_scans(scan, names, per_sample=True), "llh_scans.png")

    if args.sigma_var:
        with np.load(args.sigma_var, allow_pickle=False) as f:
            sv_names = [str(n) for n in f["names"]]
            # keys look like sigvar_<sample>_{hists,sigmas}
            samples = sorted(
                {k[len("sigvar_"):-len("_hists")] for k in f.files if k.endswith("_hists")}
            )
            for s in samples:
                sv = {
                    "hists": f[f"sigvar_{s}_hists"],
                    "sigmas": f[f"sigvar_{s}_sigmas"],
                }
                edges = f.get(f"sigvar_{s}_edges")
                save(
                    plot_sigma_variations(sv, edges, sv_names),
                    f"sigma_variations_{s}.png",
                )

    if args.diag:
        with np.load(args.diag, allow_pickle=False) as f:
            diag = {k: f[k] for k in f.files}
        save(plot_diagnostics(diag, [str(n) for n in diag["names"]]), "diagnostics.png")

    for p in written:
        print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
