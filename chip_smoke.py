#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mach3_tpu_torch``) on one NVIDIA GPU.

Drives the port's main path — the toy MR2T2 fit at the bench's full width,
100,000 events x 256 chains, energy grid 200 — through the hand-written CUDA
kernel of ``splines/reweight.py``, and checks it against the kernel's plain
PyTorch version. Run from the repository root:

    python3 chip_smoke.py        # needs one CUDA GPU and nvcc

Phases: device, kernel build, toy, kernel vs plain, NLL vs plain, MR2T2,
a profile of 10 steps, kernel timing. Any failed phase raises and the exit code is not 0. The last
line of standard output is ``{"ok": true, "device": {...}}``; the line before
it lists each kernel with its launches on the main path, its largest error
against the plain version and both times.

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
# Kernel vs plain version: f32 sums of a few thousand events per (chain, bin)
# taken in another order (atomics), and FMA-contracted Horner steps.
K1_RTOL = 2e-5
K1_ATOL_FRAC = 1e-6  # of max |reference|
# Per-chain NLL (f64 statistic) through the kernel vs the plain route: the
# histogram tolerance above propagated to first order through each bin's
# statistic (bins hold ~1e5 weighted events here, so an f32-rounding-level
# histogram difference moves the NLL by up to ~1e-2), plus this floor.
NLL_ATOL = 1e-4
# The fixed proposal throws at prior scale, while 100k Asimov events pin the
# posterior far tighter: ~0.1-0.2% of proposals are accepted, in the JAX
# package as well (mean acceptance probability 0.0023 over 32 chains x 20
# steps of its CPU run). The band only proves that the chains move.
ACC_MIN = 1e-4


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
        return K1_RTOL * x.abs() + K1_ATOL_FRAC * x.abs().max()

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


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — this needs a CUDA GPU")

    from mach3_tpu_torch.core.precision import disable_tf32
    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
    from mach3_tpu_torch.kernels.build import build
    from mach3_tpu_torch.splines import reweight
    from mach3_tpu_torch.tutorial.toy import build_toy

    dev = torch.device("cuda")
    torch.cuda.init()

    # 1. device
    flags = disable_tf32()
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    phase(f"[device] torch {torch.__version__} cuda {torch.version.cuda} | {name} | "
          f"nvidia-smi: {smi} | tf32 flags {flags}")

    # 2. kernel build
    lib, seconds, log = build("reweight_shifted")
    res = [ln.strip() for ln in log.splitlines() if "registers" in ln or "smem" in ln]
    phase(f"[build] {lib.name} in {seconds:.1f} s ({'built' if seconds else 'cached'}); "
          + " | ".join(res[:4]))

    # 3. toy at full width
    t0 = time.perf_counter()
    toy = build_toy(n_events=N_EVENTS, seed=SEED, e_grid_size=E_GRID)
    model = toy.model.to(dev)
    routes = [s.kernel_route.variant for s in model.samples]
    phase(f"[toy] built in {time.perf_counter() - t0:.1f} s; events "
          + ", ".join(f"{s.name}={s.n_events}" for s in model.samples)
          + f"; routes {routes}")
    if routes != ["shifted", "shifted"]:
        raise AssertionError(f"both toy samples must take the shifted route, got {routes}")

    rng = np.random.default_rng(0)
    thetas = torch.as_tensor(jitter_init(model, N_CHAINS, rng), device=dev)

    # 4. kernel vs plain version on both samples, plus the Asimov check
    max_abs = 0.0
    k1_args = []
    with torch.no_grad():
        tables = model._shared_osc_tables(thetas)
        for i, s in enumerate(model.samples):
            a, kw = s.shifted_kernel_args(thetas, tables[i])
            k1_args.append((a, kw))
            mc_k, w2_k = reweight.fused_reweight_histogram_shifted(*a, **kw)
            mc_p, w2_p = reweight.fused_reweight_histogram_shifted_ref(*a, **kw)
            e1, q1, r1 = compare(mc_k, mc_p, K1_RTOL, K1_ATOL_FRAC, f"{s.name} mc")
            e2, q2, r2 = compare(w2_k, w2_p, K1_RTOL, K1_ATOL_FRAC, f"{s.name} w2")
            max_abs = max(max_abs, e1, e2)
            prefit = model.prefit_vector()[None]
            mc_a, _ = s.reweight_batch(prefit, model._shared_osc_tables(prefit)[i])
            e3, q3, r3 = compare(mc_a[0], s.data.float(), K1_RTOL, K1_ATOL_FRAC,
                                 f"{s.name} asimov")
            phase(f"[k1-vs-plain] {s.name}: C={thetas.shape[0]} E={s.n_events} B={s.n_bins} "
                  f"max|dmc|={e1:.3e} max|dw2|={e2:.3e} max rel err {max(q1, q2):.3e} "
                  f"(worst {max(r1, r2):.3f} of tol); asimov max rel err {q3:.3e} "
                  f"({r3:.3f} of tol)")

        # 5. NLL through the kernel vs the plain route
        total, prior_parts, sample_parts = model.total_nll_batch_parts(thetas)
        plain, tols = [], []
        for i, s in enumerate(model.samples):
            mc_p, w2_p = s.reweight_batch_plain(thetas, tables[i])
            plain.append(s._stat_sum(mc_p, w2_p))
            tols.append(nll_tolerance(s, mc_p, w2_p))
        plain, tols = torch.stack(plain, dim=1), torch.stack(tols, dim=1)
        if not bool(torch.isfinite(total).all()):
            raise AssertionError("non-finite total NLL")
        d_nll = (sample_parts - plain).abs()
        worst = float((d_nll / tols).max())
        if worst > 1.0:
            raise AssertionError(f"NLL kernel vs plain: max |d| {float(d_nll.max()):.3e}")
        phase(f"[nll] total_nll_batch [{total.shape[0]}] finite; per-sample max |kernel - plain| "
              f"= {float(d_nll.max()):.3e} ({worst:.3f} of tol, median tol "
              f"{float(tols.median()):.3e}); median total {float(total.median()):.3f}")

    # 6. MR2T2, fixed proposal
    fitter = MR2T2(model, MCMCConfig(chunk_size=CHUNK), thetas.cpu().numpy(), seed=1)
    fitter.run(n_steps=CHUNK, collect=False)  # warm chunk
    torch.cuda.synchronize()
    acc0 = fitter.state.n_accepted.clone()
    n_steps = CHUNK * TIMED_CHUNKS
    reweight.LAUNCHES = 0
    t0 = time.perf_counter()
    fitter.run(n_steps=n_steps, collect=False)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = reweight.LAUNCHES
    if launches != 2 * n_steps:
        raise AssertionError(f"kernel launches {launches} != 2 x {n_steps} steps")
    if not bool(torch.isfinite(fitter.state.nll).all()):
        raise AssertionError("non-finite chain NLL after MR2T2")
    acc = float((fitter.state.n_accepted - acc0).sum()) / (N_CHAINS * n_steps)
    if not ACC_MIN < acc < 0.99:
        raise AssertionError(f"acceptance {acc:.5f} outside ({ACC_MIN}, 0.99)")
    rate = N_CHAINS * n_steps / dt
    phase(f"[mr2t2] {n_steps} steps x {N_CHAINS} chains in {dt:.3f} s: {rate:.1f} chain-steps/s "
          f"({1e3 * dt / n_steps:.3f} ms/step), acceptance {acc:.5f}, kernel launches "
          f"{launches}, peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {smi}")

    # 7. where a step's device time goes: 10 profiled steps
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fitter.run(n_steps=10, collect=False)
        torch.cuda.synchronize()
    dev_ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ops) / 10e3
    k1_busy = sum(e.self_device_time_total for e in dev_ops if "reweight_shifted" in e.key) / 10e3
    step_ms = 1e3 * dt / n_steps
    phase(f"[profile] {sum(e.count for e in dev_ops) / 10:.0f} device ops/step, device busy "
          f"{busy:.3f} ms/step (K1 {k1_busy:.3f}) against {step_ms:.3f} ms/step unprofiled: "
          f"device idle share {1.0 - busy / step_ms:.3f}")

    # 8. the kernel alone vs its plain version, CUDA events, in turns
    k_ms = p_ms = 0.0
    with torch.no_grad():
        for (a, kw), s in zip(k1_args, model.samples):
            def kern():
                reweight.fused_reweight_histogram_shifted(*a, **kw)

            def ref():
                reweight.fused_reweight_histogram_shifted_ref(*a, **kw)

            kern(), ref()
            t = [cuda_ms(ref, 10), cuda_ms(kern, 50), cuda_ms(kern, 50), cuda_ms(ref, 10)]
            km, pm = 0.5 * (t[1] + t[2]), 0.5 * (t[0] + t[3])
            k_ms += km
            p_ms += pm
            phase(f"[k1-time] {s.name}: kernel {km:.4f} ms, plain {pm:.4f} ms "
                  f"(C={N_CHAINS}, E={s.n_events}, B={s.n_bins}) | {smi}")

    print(json.dumps({"kernels": [{
        "name": "reweight_shifted",
        "route": "cuda",
        "source": "mach3_tpu_torch/csrc/reweight_shifted.cu",
        "replaces": "mach3_tpu/splines/pallas_reweight.py:339",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
