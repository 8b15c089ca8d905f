#!/usr/bin/env python3
"""Where the time of the shared and shifted reweight kernels goes, on one
NVIDIA GPU: each sample's kernel call of the reference-scale fixture
(``build_large(low_memory=True)``, 128 chains) and of the toy (100,000 events,
256 chains), timed with parts of its work switched off through its arguments
alone (the kernels are the package's, unchanged):

* ``full``: the call of the sampling path;
* ``no norm``: without the in-kernel norm product (``norm_ext``/``norm_s``
  left out);
* ``one segment``: every chain given chain 0's segments, so that a parameter
  is one work item, not one per segment its chains sit in;
* ``set-up + loop``: every event dropped (garbage bin) and no norm, so
  that a block does its set-up and its response loop but forms no norm
  product and adds nothing to a histogram;
* ``trivial plan``: every parameter listed on every tile.

The results of the variants are not compared with anything: only ``full``
computes the sample's histogram. Run from the repository root, after
``chip_smoke.py`` has shown the kernels right:

    python3 kernel_probe.py        # needs one CUDA GPU and nvcc; ~1 min
"""
from __future__ import annotations

import sys

import chip_smoke as cs


def probe(tag: str, model, thetas, smi: str) -> None:
    import torch

    from mach3_tpu_torch.splines import plan

    with torch.no_grad():
        tables = model._shared_osc_tables(thetas)
        for i, s in enumerate(model.samples):
            name, kern, _, make_args = cs.kernel_of(s)
            args, kw = make_args(thetas, tables[i])
            dev = args[0].device
            n_ev, n_par = args[3].shape[1], args[0].shape[1]
            no_norm = {k: v for k, v in kw.items() if k not in ("norm_ext", "norm_s")}
            one_seg = (args[0][:1].expand_as(args[0]).contiguous(),) + args[1:]
            shared = name == "reweight_shared"
            # the garbage bin of static bins, the invalid mark of a static base
            drop = torch.full((n_ev,), kw["n_bins"] if shared else -1, dtype=torch.int32,
                              device=dev)
            ptr, idx = plan.trivial_active(n_ev, n_par)
            trivial = dict(kw, plan_ptr=torch.as_tensor(ptr, device=dev),
                           plan_idx=torch.as_tensor(idx, device=dev))
            if shared:
                dropped = args[:4] + (drop,)
            else:  # x_nom, static_base, edges follow base_w and shift_vals
                dropped = args[:6] + (drop,) + args[7:]
            variants = {"full": (args, kw), "no norm": (args, no_norm),
                        "one segment": (one_seg, kw), "set-up + loop": (dropped, no_norm),
                        "trivial plan": (args, trivial)}
            times = {}
            for what, (a, k) in variants.items():
                kern(*a, **k)
                times[what] = cs.cuda_ms(lambda a=a, k=k: kern(*a, **k), 30)
            cs.phase(f"[probe:{tag}] {s.name} ({name}, C={thetas.shape[0]}, E={n_ev}, P={n_par}): "
                     + ", ".join(f"{what} {ms:.4f} ms" for what, ms in times.items())
                     + f" | {smi}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: torch.cuda.is_available() is False: needs a CUDA GPU")

    from mach3_tpu_torch.core.precision import disable_tf32
    from mach3_tpu_torch.kernels.build import build_all, kernel_stems
    from mach3_tpu_torch.tutorial.large import build_large
    from mach3_tpu_torch.tutorial.toy import build_toy

    dev = torch.device("cuda")
    disable_tf32()
    smi = cs.smi_line()
    build_all(kernel_stems())
    toy = build_toy(n_events=cs.N_EVENTS, seed=cs.SEED, e_grid_size=cs.E_GRID, device=dev).model
    thetas = torch.as_tensor(cs.jitter_init(toy, cs.N_CHAINS, np.random.default_rng(0)),
                             device=dev)
    probe("toy", toy, thetas, smi)
    large = build_large(seed=cs.LARGE_SEED, low_memory=True, device=dev).model
    thetas = torch.as_tensor(cs.jitter_init(large, cs.LARGE_CHAINS, np.random.default_rng(0)),
                             device=dev)
    probe("large", large, thetas, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
