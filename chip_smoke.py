#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mach3_tpu_torch``) on one NVIDIA GPU.

Drives the port's two paths through its hand-written CUDA kernels
(``splines/reweight.py``) and checks each kernel against its plain PyTorch
version. Run from the repository root:

    python3 chip_smoke.py        # needs one CUDA GPU and nvcc

* The toy path: the toy MR2T2 fit at the bench's full width, 100,000 events
  x 256 chains, energy grid 200; both samples on the shifted kernel (K1).
* The large path: the reference-scale fixture ``build_large(low_memory=True)``
  (101 parameters, 3 samples, 2,182 bins, bf16 tables, f32 statistic) at 128
  chains; numu_beam and atmo on the shared kernel (K2), nue_beam on the
  shifted kernel with P = 43 (K3), atmo through layered-PREM oscillation.

Phases: device, kernel build (every source, in parallel), then per path:
build, kernel vs plain, Asimov check, NLL vs plain, MR2T2, a profile of 10
steps, kernel timing. Any failed phase raises and the exit code is not 0.
The last line of standard output is ``{"ok": true, "device": {...}}``; the
line before it is the card's name and power limit, and the one before that
lists each kernel with its launches on its path, its largest error against
the plain version and both times.

Imports nothing of JAX. Exits non-zero when no CUDA device is visible.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

N_EVENTS = 100_000
N_CHAINS = 256
E_GRID = 200
SEED = 42
CHUNK = 250
TIMED_CHUNKS = 4
LARGE_CHAINS = 128
LARGE_SEED = 2026
LARGE_WARM = 20
LARGE_STEPS = 60  # the JAX bench's large_scale shape (bench.py:499-511)
# Kernel vs plain version: f32 sums of a few hundred to a few thousand
# events per (chain, bin) taken in another order (atomics, run sums), and
# FMA-contracted Horner steps.
K_RTOL = 2e-5
K_ATOL_FRAC = 1e-6  # of max |reference|
# Per-chain NLL (f64 sum of a per-bin statistic) through the kernels vs the
# plain route: the histogram tolerance above propagated through each bin's
# statistic (nll_tolerance), plus this floor.
NLL_ATOL = 1e-4
# Asimov data at prefit: the large fixture's data are the plain route's
# histogram on the host, so the kernels' NLL there is 0 up to f32 summation
# order, evaluated by the f32 per-bin statistic (a 1e-5 relative jitter of
# every bin moves it by ~2e-6 on this fixture).
ASIMOV_ATOL = 1e-3
# The fixed proposal throws at prior scale, while 100k Asimov events pin the
# posterior far tighter: ~0.1-0.2% of proposals are accepted on the toy, in
# the JAX package as well (mean acceptance probability 0.0023 over 32 chains
# x 20 steps of its CPU run). The band only proves that the chains move. The
# large path has no band: 101 prior-scale throws against ~450k Asimov events
# are all but never accepted, and its run checks the NLLs and the launches.
ACC_MIN = 1e-4

TPU_KERNELS = {
    "K1": "mach3_tpu/splines/pallas_reweight.py:339",
    "K3": "mach3_tpu/splines/pallas_reweight.py:414",
    "K2": "mach3_tpu/splines/pallas_reweight.py:912",
}


def phase(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def jitter_init(model, n_chains: int, rng, frac: float = 0.05):
    """Prefit + frac x prior-sigma jitter, clipped inside the bounds."""
    import numpy as np

    flat = model.flat
    chol = flat.chol.cpu().numpy()
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = flat.low_bound.cpu().numpy(), flat.up_bound.cpu().numpy()
    theta0 = flat.prefit.cpu().numpy()
    init = theta0 + frac * sig * rng.normal(size=(n_chains, len(theta0)))
    eps = 1e-6 * (hi - lo)
    return np.clip(init, lo + eps, hi - eps)


def compare(got, ref, rtol: float, atol_frac: float, what: str) -> tuple[float, float, float]:
    """(max |got - ref|, max relative error over bins above the absolute
    floor, max |got - ref| / tolerance); raises above tolerance."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite values")
    err = (got - ref).abs()
    floor = atol_frac * float(ref.abs().max())
    tol = rtol * ref.abs() + floor
    worst = float((err / tol).max())
    if worst > 1.0:
        raise AssertionError(f"{what}: error {float(err.max()):.3e} is {worst:.2f}x the tolerance")
    rel = float((err / ref.abs())[ref.abs() > floor].max())
    return float(err.max()), rel, worst


def nll_tolerance(sample, mc, w2):
    """[C] NLL tolerance: each bin's statistic moved by the histogram
    tolerance of mc and of w2 (either sign), summed over bins."""
    import torch

    from mach3_tpu_torch.samples.teststats import get_test_stat_fn

    stat = get_test_stat_fn(sample.test_statistic)
    mc, w2, data = mc.double(), w2.double(), sample.data

    def tol(x):
        return K_RTOL * x.abs() + K_ATOL_FRAC * x.abs().max()

    base = stat(data, mc, w2)
    moved = [stat(data, mc + sgn * tol(mc), w2) for sgn in (1, -1)]
    moved += [stat(data, mc, w2 + sgn * tol(w2)) for sgn in (1, -1)]
    d = [(m - base).abs() for m in moved]
    return (torch.maximum(d[0], d[1]) + torch.maximum(d[2], d[3])).sum(-1) + NLL_ATOL


def cuda_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def kernel_of(sample):
    """(kernel name, wrapper, plain version, argument maker) of a sample's
    route."""
    from mach3_tpu_torch.splines import reweight

    if sample.kernel_route.variant == "shared":
        return ("reweight_shared", reweight.fused_reweight_histogram_shared,
                reweight.fused_reweight_histogram_shared_ref, sample.shared_kernel_args)
    return ("reweight_shifted", reweight.fused_reweight_histogram_shifted,
            reweight.fused_reweight_histogram_shifted_ref, sample.shifted_kernel_args)


def reset_launches() -> None:
    from mach3_tpu_torch.splines import reweight

    for k in reweight.LAUNCHES:
        reweight.LAUNCHES[k] = 0


def kernels_vs_plain(tag: str, model, thetas, tables, smi: str) -> dict:
    """Each sample's kernel against its plain version on the same arguments;
    returns {sample name: (args, kwargs, max abs error)}."""
    out = {}
    for i, s in enumerate(model.samples):
        name, kern, ref, make_args = kernel_of(s)
        a, kw = make_args(thetas, tables[i])
        mc_k, w2_k = kern(*a, **kw)
        mc_p, w2_p = ref(*a, **kw)
        e1, q1, r1 = compare(mc_k, mc_p, K_RTOL, K_ATOL_FRAC, f"{s.name} mc")
        e2, q2, r2 = compare(w2_k, w2_p, K_RTOL, K_ATOL_FRAC, f"{s.name} w2")
        out[s.name] = (a, kw, max(e1, e2))
        phase(f"[{tag}:kernel-vs-plain] {s.name} ({name}): C={thetas.shape[0]} E={s.n_events} "
              f"B={s.n_bins} P={s.spline_table.n_spline_params} max|dmc|={e1:.3e} "
              f"max|dw2|={e2:.3e} max rel err {max(q1, q2):.3e} "
              f"(worst {max(r1, r2):.3f} of tol) | {smi}")
    return out


def wide_form_vs_plain(sample, checked, smi: str) -> None:
    """The shared kernel with a trivial plan — every parameter in every
    tile, the whole bin axis as the window: the function of the TPU's wide
    shared kernel K4b (P > 16) — on a real sample, against the plain
    version. These launches are comparisons, not the path's."""
    import torch

    from mach3_tpu_torch.splines import plan, reweight

    args, kwargs, _ = checked
    dev = args[0].device
    starts, widths, ptr, idx, nbl = plan.trivial_plan(sample.n_events, args[0].shape[1],
                                                      sample.n_bins)
    kw = dict(kwargs, tile_start=torch.as_tensor(starts, device=dev),
              tile_width=torch.as_tensor(widths, device=dev),
              plan_ptr=torch.as_tensor(ptr, device=dev), plan_idx=torch.as_tensor(idx, device=dev),
              nbl=nbl)
    mc_k, w2_k = reweight.fused_reweight_histogram_shared(*args, **kw)
    mc_p, w2_p = reweight.fused_reweight_histogram_shared_ref(*args, **kw)
    e1, q1, r1 = compare(mc_k, mc_p, K_RTOL, K_ATOL_FRAC, f"{sample.name} wide mc")
    e2, q2, r2 = compare(w2_k, w2_p, K_RTOL, K_ATOL_FRAC, f"{sample.name} wide w2")
    ms = cuda_ms(lambda: reweight.fused_reweight_histogram_shared(*args, **kw), 10)
    phase(f"[large:wide-form-vs-plain] {sample.name} (reweight_shared, trivial plan, window "
          f"{nbl} bins): max|dmc|={e1:.3e} max|dw2|={e2:.3e} max rel err {max(q1, q2):.3e} "
          f"(worst {max(r1, r2):.3f} of tol); kernel {ms:.4f} ms | {smi}")


def nll_vs_plain(tag: str, model, thetas, tables, smi: str) -> None:
    """Per-chain NLL through the kernels against the plain route."""
    import torch

    total, _, sample_parts = model.total_nll_batch_parts(thetas)
    plain, tols = [], []
    for i, s in enumerate(model.samples):
        mc_p, w2_p = s.reweight_batch_plain(thetas, tables[i])
        plain.append(s._stat_sum(mc_p, w2_p))
        tols.append(nll_tolerance(s, mc_p, w2_p))
    plain, tols = torch.stack(plain, dim=1), torch.stack(tols, dim=1)
    if not bool(torch.isfinite(total).all()):
        raise AssertionError(f"{tag}: non-finite total NLL")
    d_nll = (sample_parts - plain).abs()
    worst = float((d_nll / tols).max())
    if worst > 1.0:
        raise AssertionError(f"{tag}: NLL kernel vs plain: max |d| {float(d_nll.max()):.3e} "
                             f"is {worst:.2f}x the tolerance")
    phase(f"[{tag}:nll] total_nll_batch [{total.shape[0]}] finite; per-sample max |kernel - "
          f"plain| = {float(d_nll.max()):.3e} ({worst:.3f} of tol, median tol "
          f"{float(tols.median()):.3e}); median total {float(total.median()):.3f} | {smi}")


def run_mr2t2(tag: str, model, thetas, warm: int, steps: int, chunk: int,
              launches_per_step: dict, smi: str, acc_min: float | None):
    """Fixed-proposal MR2T2: a warm chunk, then ``steps`` timed steps whose
    kernel launches must be ``launches_per_step`` x steps and whose
    acceptance must lie in (acc_min, 0.99) unless acc_min is None. Returns
    (fitter, ms/step, launch counts)."""
    import torch

    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
    from mach3_tpu_torch.splines import reweight

    n_chains = thetas.shape[0]
    fitter = MR2T2(model, MCMCConfig(chunk_size=chunk), thetas.cpu().numpy(), seed=1)
    fitter.run(n_steps=warm, collect=False)
    torch.cuda.synchronize()
    acc0 = fitter.state.n_accepted.clone()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    fitter.run(n_steps=steps, collect=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(reweight.LAUNCHES)
    want = {k: v * steps for k, v in launches_per_step.items()}
    if {k: launches[k] for k in want} != want or sum(launches.values()) != sum(want.values()):
        raise AssertionError(f"{tag}: kernel launches {launches} != {want} for {steps} steps")
    if not bool(torch.isfinite(fitter.state.nll).all()):
        raise AssertionError(f"{tag}: non-finite chain NLL after MR2T2")
    acc = float((fitter.state.n_accepted - acc0).sum()) / (n_chains * steps)
    if acc_min is not None and not acc_min < acc < 0.99:
        raise AssertionError(f"{tag}: acceptance {acc:.5f} outside ({acc_min}, 0.99)")
    step_ms = 1e3 * dt / steps
    phase(f"[{tag}:mr2t2] {steps} steps x {n_chains} chains in {dt:.3f} s: "
          f"{n_chains * steps / dt:.1f} chain-steps/s ({step_ms:.3f} ms/step), acceptance "
          f"{acc:.5f}, kernel launches {launches}, peak mem "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")
    return fitter, step_ms, launches


def profile_steps(tag: str, fitter, step_ms: float, names, smi: str) -> None:
    """Device ops, device busy time and each kernel's share over 10 steps."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fitter.run(n_steps=10, collect=False)
        torch.cuda.synchronize()
    dev_ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ops) / 10e3
    shares = ", ".join(
        f"{n} {sum(e.self_device_time_total for e in dev_ops if n in e.key) / 10e3:.3f}"
        for n in names
    )
    top = sorted(dev_ops, key=lambda e: -e.self_device_time_total)[:5]
    phase(f"[{tag}:profile] {sum(e.count for e in dev_ops) / 10:.0f} device ops/step, device "
          f"busy {busy:.3f} ms/step ({shares} ms/step) against {step_ms:.3f} ms/step "
          f"unprofiled: device idle share {1.0 - busy / step_ms:.3f}; top: "
          + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 10e3:.3f}" for e in top)
          + f" | {smi}")


def time_kernel(tag: str, sample, args, kwargs, smi: str) -> tuple[float, float]:
    """(kernel ms, plain ms) with CUDA events, in turns plain, kernel,
    kernel, plain."""
    _, kern, ref, _ = kernel_of(sample)
    kern(*args, **kwargs), ref(*args, **kwargs)
    t = [cuda_ms(lambda: ref(*args, **kwargs), 5), cuda_ms(lambda: kern(*args, **kwargs), 30),
         cuda_ms(lambda: kern(*args, **kwargs), 30), cuda_ms(lambda: ref(*args, **kwargs), 5)]
    km, pm = 0.5 * (t[1] + t[2]), 0.5 * (t[0] + t[3])
    phase(f"[{tag}:kernel-time] {sample.name}: kernel {km:.4f} ms, plain {pm:.4f} ms "
          f"(C={args[3].shape[0]}, E={sample.n_events}, B={sample.n_bins}) | {smi}")
    return km, pm


def toy_path(dev, smi: str) -> dict:
    import numpy as np
    import torch

    from mach3_tpu_torch.tutorial.toy import build_toy

    t0 = time.perf_counter()
    toy = build_toy(n_events=N_EVENTS, seed=SEED, e_grid_size=E_GRID)
    model = toy.model.to(dev)
    routes = [s.kernel_route.variant for s in model.samples]
    phase(f"[toy] built in {time.perf_counter() - t0:.1f} s; events "
          + ", ".join(f"{s.name}={s.n_events}" for s in model.samples) + f"; routes {routes}"
          + f" | {smi}")
    if routes != ["shifted", "shifted"]:
        raise AssertionError(f"both toy samples must take the shifted route, got {routes}")
    thetas = torch.as_tensor(jitter_init(model, N_CHAINS, np.random.default_rng(0)), device=dev)

    with torch.no_grad():
        tables = model._shared_osc_tables(thetas)
        checked = kernels_vs_plain("toy", model, thetas, tables, smi)
        prefit = model.prefit_vector()[None]
        pre_tables = model._shared_osc_tables(prefit)
        for i, s in enumerate(model.samples):
            mc_a, _ = s.reweight_batch(prefit, pre_tables[i])
            _, q, r = compare(mc_a[0], s.data.float(), K_RTOL, K_ATOL_FRAC, f"{s.name} asimov")
            phase(f"[toy:asimov] {s.name}: max rel err {q:.3e} ({r:.3f} of tol) | {smi}")
        nll_vs_plain("toy", model, thetas, tables, smi)

    fitter, step_ms, launches = run_mr2t2(
        "toy", model, thetas, CHUNK, CHUNK * TIMED_CHUNKS, CHUNK, {"reweight_shifted": 2}, smi,
        ACC_MIN)
    profile_steps("toy", fitter, step_ms, ["reweight_shifted"], smi)
    k_ms = p_ms = 0.0
    with torch.no_grad():
        for s in model.samples:
            a, kw, _ = checked[s.name]
            km, pm = time_kernel("toy", s, a, kw, smi)
            k_ms, p_ms = k_ms + km, p_ms + pm
    return {"K1": dict(launches=launches["reweight_shifted"],
                       max_abs_err=max(v[2] for v in checked.values()), ms=k_ms, plain_ms=p_ms)}


def large_path(dev, smi: str) -> dict:
    import numpy as np
    import torch

    from mach3_tpu_torch.tutorial.large import build_large

    t0 = time.perf_counter()
    large = build_large(seed=LARGE_SEED, low_memory=True)
    build_s = time.perf_counter() - t0
    model = large.model.to(dev)
    routes = [s.kernel_route.variant for s in model.samples]
    parts = []
    for s in model.samples:
        info = (f"{s.name}: E={s.n_events} B={s.n_bins} P={s.spline_table.n_spline_params} "
                f"route={s.kernel_route.variant}")
        if s.hist_plan_ptr is not None:
            n_act = s.hist_plan_ptr.diff().float().mean()
            info += (f" window={s.hist_nbl} tiles={s.hist_tile_start.shape[0]} "
                     f"active params/tile={float(n_act):.2f}")
        parts.append(info)
    phase(f"[large] built in {build_s:.1f} s (host); {model.n_params} params; "
          + "; ".join(parts) + f" | {smi}")
    if routes != ["shared", "shifted", "shared"]:
        raise AssertionError(f"large routes must be shared/shifted/shared, got {routes}")
    thetas = torch.as_tensor(jitter_init(model, LARGE_CHAINS, np.random.default_rng(0)),
                             device=dev)

    with torch.no_grad():
        tables = model._shared_osc_tables(thetas)
        checked = kernels_vs_plain("large", model, thetas, tables, smi)
        wide_form_vs_plain(model.samples[0], checked[model.samples[0].name], smi)
        prefit = model.prefit_vector()[None]
        _, _, asimov = model.total_nll_batch_parts(prefit)
        worst = float(asimov.abs().max())
        phase(f"[large:asimov] per-sample NLL at prefit through the kernels "
              f"{[f'{float(v):.3e}' for v in asimov[0]]} (bound {ASIMOV_ATOL}) | {smi}")
        if not worst < ASIMOV_ATOL:
            raise AssertionError(f"Asimov NLL at prefit {worst:.3e} >= {ASIMOV_ATOL}")
        nll_vs_plain("large", model, thetas, tables, smi)

    fitter, step_ms, launches = run_mr2t2(
        "large", model, thetas, LARGE_WARM, LARGE_STEPS, LARGE_WARM,
        {"reweight_shared": 2, "reweight_shifted": 1}, smi, None)
    profile_steps("large", fitter, step_ms, ["reweight_shared", "reweight_shifted"], smi)
    times = {}
    with torch.no_grad():
        for s in model.samples:
            a, kw, _ = checked[s.name]
            times[s.name] = time_kernel("large", s, a, kw, smi)
    err = {n: v[2] for n, v in checked.items()}
    return {
        "K3": dict(launches=launches["reweight_shifted"], max_abs_err=err["nue_beam"],
                   ms=times["nue_beam"][0], plain_ms=times["nue_beam"][1]),
        "K2": dict(launches=launches["reweight_shared"],
                   max_abs_err=max(err["numu_beam"], err["atmo"]),
                   ms=times["numu_beam"][0] + times["atmo"][0],
                   plain_ms=times["numu_beam"][1] + times["atmo"][1]),
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this needs a CUDA GPU")

    from mach3_tpu_torch.core.precision import disable_tf32
    from mach3_tpu_torch.kernels.build import build_all, kernel_stems

    dev = torch.device("cuda")
    torch.cuda.init()

    flags = disable_tf32()
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    phase(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | {name} | "
          f"nvidia-smi: {smi} | tf32 flags {flags}")

    t0 = time.perf_counter()
    built = build_all(kernel_stems())
    phase(f"[build] {len(built)} sources in {time.perf_counter() - t0:.1f} s (in parallel) | {smi}")
    for stem, (lib, seconds, log) in built.items():
        res = [ln.strip() for ln in log.splitlines() if "registers" in ln or "smem" in ln]
        phase(f"[build] {lib.name} in {seconds:.1f} s ({'built' if seconds else 'cached'}); "
              + " | ".join(res[:4]))

    results = toy_path(dev, smi)
    results.update(large_path(dev, smi))

    sources = {"K1": "reweight_shifted", "K3": "reweight_shifted", "K2": "reweight_shared"}
    print(json.dumps({"kernels": [
        {"name": sources[k], "route": "cuda",
         "source": f"mach3_tpu_torch/csrc/{sources[k]}.cu", "replaces": TPU_KERNELS[k],
         **results[k]}
        for k in ("K1", "K3", "K2")
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
