"""A probe of the program's PREM paths against the reference's.

    python3 -m m3bench.fault_prem [--config large] [--seeds 1 2 3] [--chains 16]

For each seed it builds a configuration with atmospheric samples
(``large`` or ``large700``), its Asimov data with the reference, and the
program's model; then at ``--chains`` points near the prefit point it
prints each sample's NLL gap between the program and the reference, and
between the program and the reference fed the program's own layer paths
(the witness: it isolates the paths from the rest of the likelihood).
The geometry is printed beside it: per zenith, the density-weighted path
length ∫ Ye·ρ dl of the program's layers and of the reference's."""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def program_paths(cosz, height_km):
    """The program's layers per zenith as (lengths, Ye·ρ) lists."""
    from mach3_tpu_torch.osc.prem import path_through_earth

    lengths, rho, ye = path_through_earth(np.asarray(cosz), production_height_km=height_km)
    return [([float(x) for x in l if x > 0], [float(r * y) for x, r, y in zip(l, rr, yy) if x > 0])
            for l, rr, yy in zip(lengths, rho, ye)]


def main(argv=None) -> int:
    from . import port
    from .reference import osc as osc_ref
    from .reference.likelihood import F64, Reference, spline_tables
    from .reference.params import read
    from .run import _load
    from .samplers.mr2t2 import initial_thetas

    ap = argparse.ArgumentParser()
    ap.add_argument("--config", default="large")
    ap.add_argument("--seeds", type=int, nargs="+", default=[1, 2, 3])
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    spec = json.loads((HERE / "configs" / f"{args.config}.json").read_text())
    gen = _load(HERE / "configs" / f"{args.config}.py", f"config_{args.config}")
    for seed in args.seeds:
        inputs = gen.build(spec, seed)
        params = read(inputs.trees)
        tables = spline_tables(inputs)
        inputs.data = Reference(inputs, dev, tables).asimov(torch.as_tensor(params.prefit))
        model = port.build_model(inputs, dev)
        theta = torch.as_tensor(initial_thetas(params, args.chains, np.random.default_rng(seed),
                                               0.3), device=dev)
        with torch.no_grad():
            prog = model.total_nll_batch_parts(theta)[2].cpu()
        del model
        torch.cuda.empty_cache() if dev.type == "cuda" else None
        ref = Reference(inputs, dev, tables)
        grids: dict = {}
        right = torch.stack([s.nll(theta, grids, F64) for s in ref.samples], 1).cpu()
        for s in ref.samples:
            if s.osc["kind"] == "atmo":
                s.paths = program_paths(s.osc["cosz_grid"], s.osc["production_height_km"])
        grids = {}
        witness = torch.stack([s.nll(theta, grids, F64) for s in ref.samples], 1).cpu()
        for i, s in enumerate(ref.samples):
            print(f"[fault_prem] {args.config} seed {seed} {s.name} ({s.osc['kind']}): max |NLL "
                  f"program - reference| {float((prog[:, i] - right[:, i]).abs().max()):.6e}, "
                  f"program - reference on the program's paths "
                  f"{float((prog[:, i] - witness[:, i]).abs().max()):.6e}", flush=True)
        atmo = next((s for s in inputs.samples if s.osc["kind"] == "atmo"), None)
        if atmo is not None and seed == args.seeds[0]:
            mine = osc_ref.prem_paths(atmo.osc["cosz_grid"], atmo.osc["production_height_km"])
            theirs = program_paths(atmo.osc["cosz_grid"], atmo.osc["production_height_km"])
            for cz, a, b in zip(atmo.osc["cosz_grid"], mine, theirs):
                ia = sum(l * y for l, y in zip(*a))
                ib = sum(l * y for l, y in zip(*b))
                print(f"[fault_prem] cosZ {cz:+.4f}: layers reference {len(a[0])}, program "
                      f"{len(b[0])}; integral Ye*rho dl reference {ia:.3f}, program {ib:.3f} "
                      f"g/cm2*1e5", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
