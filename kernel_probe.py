#!/usr/bin/env python3
"""Where the time of the forward reweight kernels goes, on one NVIDIA GPU:
each sample's kernel call of the reference-scale fixture
(``build_large(low_memory=True)``, 128 chains), of the toy (100,000 events,
256 chains) and of the YAML experiment (``tutorial/experiment_files.py`` at
100,000 events, 256 chains: its two generic-route samples on the per-chain
kernel, its shared-route one), timed with parts of its work switched off
through its arguments alone (the kernels are the package's, unchanged):

* ``full``: the call of the sampling path;
* ``no norm``: without the in-kernel norm product (``norm_ext``/``norm_s``
  left out);
* ``one segment``: every chain given chain 0's segments, so that a parameter
  is one work item, not one per segment its chains sit in;
* ``set-up + loop``: every event dropped (garbage bin) and no norm, so
  that a block does its set-up and its response loop but forms no norm
  product and adds nothing to a histogram;
* ``trivial plan``: every parameter listed on every tile;
* ``bins given`` (generic route): the bins [C, E] of
  ``SampleModel._perchain_bins`` as input instead of the bin map.

And the backward kernel (``csrc/reweight_backward.cu``) of each sample of
the toy and of the fixture at the gradient path's 64 chains:

* ``full``: the call of the gradient path;
* ``phase 1``: ``need_t=False``, ḡ_base alone;
* ``one segment`` and ``trivial plan``: as above.

The results of the variants are not compared with anything: only ``full``
computes the sample's histogram (``chip_smoke.py`` holds the backward to its
plain passes). Run from the repository root, after
``chip_smoke.py`` has shown the kernels right:

    python3 kernel_probe.py        # needs one CUDA GPU and nvcc; ~1.5 min
"""
from __future__ import annotations

import dataclasses
import sys
import tempfile

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
            elif name == "reweight_perchain":  # the bin map's static base
                dropped = args[:4] + (dataclasses.replace(args[4], static_base=drop),)
            else:  # x_nom, static_base, edges follow base_w and shift_vals
                dropped = args[:6] + (drop,) + args[7:]
            variants = {"full": (args, kw), "no norm": (args, no_norm),
                        "one segment": (one_seg, kw), "set-up + loop": (dropped, no_norm),
                        "trivial plan": (args, trivial)}
            if name == "reweight_perchain":
                given = s._perchain_bins(thetas).to(torch.int32).contiguous()
                variants["bins given"] = (args[:4] + (given,), kw)
            times = {}
            for what, (a, k) in variants.items():
                kern(*a, **k)
                times[what] = cs.cuda_ms(lambda a=a, k=k: kern(*a, **k), 30)
            cs.phase(f"[probe:{tag}] {s.name} ({name}, C={thetas.shape[0]}, E={n_ev}, P={n_par}): "
                     + ", ".join(f"{what} {ms:.4f} ms" for what, ms in times.items())
                     + f" | {smi}")


def probe_backward(tag: str, model, thetas, smi: str) -> None:
    import torch

    from mach3_tpu_torch.splines import grad, plan

    with torch.no_grad():
        tables = model._shared_osc_tables(thetas)
    for i, s in enumerate(model.samples):
        b_in, kw = cs.backward_args(s, thetas, tables[i])
        kw = dict(kw, n_bins=s.n_bins)
        seg = b_in[0]
        one_seg = (seg[:1].expand_as(seg).contiguous(),) + b_in[1:]
        ptr, idx = plan.trivial_active(s.n_events, seg.shape[1])
        trivial = dict(kw, plan_ptr=torch.as_tensor(ptr, device=seg.device),
                       plan_idx=torch.as_tensor(idx, device=seg.device))
        variants = {"full": (b_in, kw), "phase 1": (b_in, dict(kw, need_t=False)),
                    "one segment": (one_seg, kw), "trivial plan": (b_in, trivial)}
        times = {}
        for what, (a, k) in variants.items():
            grad.reweight_backward(*a, **k)
            times[what] = cs.cuda_ms(lambda a=a, k=k: grad.reweight_backward(*a, **k), 30)
        cs.phase(f"[probe:{tag}:backward] {s.name} (reweight_backward, C={thetas.shape[0]}, "
                 f"E={s.n_events}): "
                 + ", ".join(f"{what} {ms:.4f} ms" for what, ms in times.items()) + f" | {smi}")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: torch.cuda.is_available() is False: needs a CUDA GPU")

    from mach3_tpu_torch.core.config import Config
    from mach3_tpu_torch.core.precision import disable_tf32
    from mach3_tpu_torch.kernels.build import build_all, kernel_stems
    from mach3_tpu_torch.samples.experiment import build_experiment
    from mach3_tpu_torch.tutorial.experiment_files import write_experiment
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
    probe_backward("toy", toy, thetas, smi)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config.from_file(str(write_experiment(tmp, n_events=cs.EXP_EVENTS,
                                                    seed=cs.EXP_SEED)))
        exp = build_experiment(cfg, device=dev).model
    thetas = torch.as_tensor(cs.jitter_init(exp, cs.N_CHAINS, np.random.default_rng(0)),
                             device=dev)
    probe("exp", exp, thetas, smi)
    large = build_large(seed=cs.LARGE_SEED, low_memory=True, device=dev).model
    thetas = torch.as_tensor(cs.jitter_init(large, cs.LARGE_CHAINS, np.random.default_rng(0)),
                             device=dev)
    probe("large", large, thetas, smi)
    thetas = torch.as_tensor(cs.jitter_init(large, cs.GRAD_CHAINS, np.random.default_rng(0)),
                             device=dev)
    probe_backward("large", large, thetas, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
