#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mach3_tpu_torch``) on one NVIDIA GPU.

Drives the port's paths through its hand-written CUDA kernels
(``splines/reweight.py`` forward, ``splines/grad.py`` backward) and checks
each kernel against its plain PyTorch version. Run from the repository root:

    python3 chip_smoke.py        # needs one CUDA GPU and nvcc

* The toy path: the toy MR2T2 fit at the bench's full width, 100,000 events
  x 256 chains, energy grid 200; both samples on the shifted kernel (K1).
  Its gradient path: the backward kernels (K6a, K6b; per-chain bins) on both
  samples, the gradient of ``log_posterior_batch`` through the kernels vs the
  plain route, and the L-BFGS fit (``run_minimizer``) from a jittered start.
* The large path: the reference-scale fixture ``build_large(low_memory=True)``
  (101 parameters, 3 samples, 2,182 bins, bf16 tables, f32 statistic) at 128
  chains; numu_beam and atmo on the shared kernel (K2; K4b is its trivial
  plan), nue_beam on the shifted kernel with P = 43 under its activity plan
  (K3; also held against the same kernel under a trivial plan), atmo through
  layered-PREM oscillation. Its gradient path at the JAX bench's 64 chains:
  K6a/K6b on shared bins (numu_beam, atmo) and per-chain bins (nue_beam),
  the differentiable NLL vs the sampling NLL, the gradient vs the plain
  route, the gradient budget (``hmc_large_grad_budget``) and ChEES-HMC
  (``chees_hmc_large``).
* The experiment path: the YAML experiment of
  ``tutorial/experiment_files.py`` (the toy's 100,000 events in three
  samples, 19 parameters) written into a temporary directory and built by
  ``build_experiment`` at 256 chains: numu_2d (two shifts) and
  nue_nonuniform (hyper-rectangle bins with a shift, a TF1 response) on the
  per-chain kernel (K5; K5b is its ``hist="blockdiag"`` form), numu_nd (a
  weight function, static bins, P = 4) on the shared kernel, whose trivial
  plan computes K4a. Its gradient at 64 chains through K5, the shared
  kernel, K6a and K6b.

Phases: device, kernel build (every source, in parallel), then per path:
build, kernel vs plain, Asimov check, NLL vs plain, MR2T2, a profile of 10
steps, kernel timing; then the gradient phases. Any failed phase raises and
the exit code is not 0. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit, and the one before that lists each kernel with its launches on
its path (K1 and K3: the toy and large MR2T2 runs; K2: the large MR2T2 run;
K4b, K6a, K6b: the ChEES run; K5, K4a: the experiment's MR2T2 run; K5b: its
run with the deterministic histogram), its largest error against the plain
version, both times and its bound: the least time the card could take for
the same work, from the bytes each call must move (every input read once,
each output written once) at 3.35 TB/s and its f32 operations at 67
TFLOP/s, whichever is larger (H100 SXM peaks). No single PyTorch call
computes a spline product and a histogram, so no kernel has a library time.

``python3 chip_smoke.py --kernel-times`` stops each of the toy and large
paths after its kernel-vs-plain and kernel-timing phases and prints neither
the kernels line nor the last line: a short run for work on a kernel.

Imports nothing of JAX. Exits non-zero when no CUDA device is visible.
"""
from __future__ import annotations

import json
import math
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
# x 20 steps of its CPU run); the experiment's 19 parameters ~0.03% (0.00030
# over 256 chains x 1,000 steps on an H100, 700 W, with the same seeded
# draws). The band only proves that the chains move. The large path has no
# band: 101 prior-scale throws against ~450k Asimov events
# are all but never accepted, and its run checks the NLLs and the launches.
ACC_MIN = 1e-4

# The gradient path at the JAX bench's gradient configurations: 64 chains
# (bench.py:541, :944), 20 timed iterations (bench.py:547), ChEES with 80
# warm-up/adaptation and 60 timed steps (bench.py:947-963).
GRAD_CHAINS = 64
BUDGET_ITERS = 20
CHEES_WARM = 80
CHEES_STEPS = 60
# Backward kernels vs their plain versions on the same inputs: pass A's
# [C, E] fields elementwise (a product of P f32 responses, FMA-contracted
# Horner steps: rtol 1e-5 x P, atol 1e-6 x max), nz exactly; pass B's ḡ_t
# within 1e-5 x P of Σ_e |term| per (chain, param): a reduction over up to
# 200k events in another order, whose terms cancel.
GRAD_RTOL = 1e-5  # x P
# The gradient of log_posterior_batch through the kernels vs autograd of the
# plain route, as a fraction of each chain's largest component. On the CPU
# at test size (the kernels' plain versions: the same f32 terms multiplied
# in another order) the gap is at most 7.6e-5 (tests/test_torch_grad.py).
# The card adds the atomic order of the histograms (rtol 2e-5), which the
# statistic's slope amplifies in bins where mc is close to the data: a first
# card run (H100, 700 W) gave 8.4e-4 on the toy at 256 chains and 6.3e-4 on
# the large fixture at 64 chains against a bound of 1e-3 (13x the CPU gap).
# That order changes from run to run, so the bound is 5e-3: 66x the CPU
# gap, 6x the card's.
GRAD_E2E = 5e-3
# Kernel launches per gradient evaluation (one forward, one backward).
TOY_GRAD_LAUNCHES = {"reweight_shifted": 2, "grad_a": 2, "grad_b": 2}
LARGE_GRAD_LAUNCHES = {"reweight_shared": 2, "reweight_shifted": 1, "grad_a": 3, "grad_b": 3}
# The experiment path (tutorial/experiment_files.py) at the toy's width.
EXP_EVENTS = 100_000
EXP_SEED = 42
EXP_ROUTES = ["generic", "generic", "shared"]
EXP_LAUNCHES = {"reweight_perchain": 2, "reweight_shared": 1}
EXP_DET_STEPS = 50  # the same fit with the deterministic histogram (K5b)
EXP_GRAD_LAUNCHES = {"reweight_perchain": 2, "reweight_shared": 1, "grad_a": 3, "grad_b": 3}
# H100 SXM peaks (NVIDIA's data sheet): device memory and f32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# ChEES gates on the timed steps: mean acceptance inside (0.3, 0.99).
CHEES_ACC = (0.3, 0.99)
# The toy fit ends at the Asimov minimum, χ² = 0 at the prefit point: on an
# H100 (700 W) 13 starts (0.5 and 1 prior widths) ended at χ² 4.7e-8 to
# 5.8e-7 with every free parameter within 5.6e-4 of its error of the truth.
MIN_CHI2 = 1e-4
MIN_PULL = 1e-2

TPU_KERNELS = {
    "K1": "mach3_tpu/splines/pallas_reweight.py:339",
    "K3": "mach3_tpu/splines/pallas_reweight.py:414",
    "K2": "mach3_tpu/splines/pallas_reweight.py:912",
    "K4a": "mach3_tpu/splines/pallas_reweight.py:682",
    "K4b": "mach3_tpu/splines/pallas_reweight.py:723",
    "K5": "mach3_tpu/splines/pallas_reweight.py:279",
    "K5b": "mach3_tpu/splines/pallas_reweight.py:111",
    "K6a": "mach3_tpu/splines/pallas_grad.py:68",
    "K6b": "mach3_tpu/splines/pallas_grad.py:123",
}
SOURCES = {"K1": "reweight_shifted", "K3": "reweight_shifted", "K2": "reweight_shared",
           "K4a": "reweight_shared", "K4b": "reweight_shared", "K5": "reweight_perchain",
           "K5b": "reweight_perchain", "K6a": "reweight_grad", "K6b": "reweight_grad"}
NAMES = {"K4a": "reweight_shared (trivial plan, P <= 16)",
         "K4b": "reweight_shared (trivial plan)", "K5b": "reweight_perchain_det",
         "K6a": "reweight_grad_a", "K6b": "reweight_grad_b"}


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


def _nbytes(*xs) -> int:
    import torch

    return sum(x.numel() * x.element_size() for x in xs if isinstance(x, torch.Tensor))


def coefficient_reads(seg, coeffs) -> tuple[int, int]:
    """(bytes, evaluated (event, parameter) pairs) of a spline table that a
    call needs: each parameter's 4 coefficient rows at the distinct segments
    its chains are in, on the events where it is not the identity (an
    identity response multiplies by exactly 1 and needs no read)."""
    import torch

    n_par, k4, n_ev = coeffs.shape
    c4 = coeffs.reshape(n_par, k4 // 4, 4, n_ev)
    events = ((c4[:, :, 1:] != 0).any(2).any(1) | (c4[:, :, 0] != 1).any(1)).sum(1).cpu()
    nseg = torch.tensor([len(torch.unique(seg[:, p])) for p in range(n_par)])
    return int((nseg * 4 * events).sum()) * coeffs.element_size(), int(events.sum())


def bound(n_bytes: float, n_ops: float) -> dict:
    """The least time for ``n_bytes`` of device memory traffic and ``n_ops``
    f32 operations at the card's peaks, and which of the two sets it."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_FLOPS_PER_S
    return dict(bound_ms=1e3 * max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def forward_bound(args, kwargs) -> dict:
    """Bound of one forward reweight-histogram call from its arguments
    (any of the three kernels): every tensor argument read once, the table
    by ``coefficient_reads``, the two [C, B] outputs written once; 7 f32
    operations per evaluated (chain, event, parameter) (a Horner step and
    the product), 3 per (chain, event) (w² and the two sums) and 2 per
    (chain, matched norm) (one multiply-add). ``responses`` is the number
    of (chain, event, parameter) responses that are not the identity: what
    the call must evaluate, whatever plan it runs under."""
    import torch

    seg, coeffs, base_w = args[0], args[2], args[3]
    c, e = base_w.shape
    coef, pairs = coefficient_reads(seg, coeffs)
    others = [a for i, a in enumerate(args) if i != 2] + list(kwargs.values())
    norm_s = kwargs.get("norm_s")
    matches = 0 if norm_s is None else int(torch.count_nonzero(norm_s))
    return dict(bound(_nbytes(*others) + coef + 2 * c * kwargs["n_bins"] * 4,
                      c * (7 * pairs + 3 * e + 2 * matches)), responses=c * pairs)


def summed(parts: list) -> dict:
    """Bounds of several calls run one after another: the sum, set by
    whichever kind sets the largest part."""
    return dict(bound_ms=sum(b["bound_ms"] for b in parts),
                bound_by=max(parts, key=lambda b: b["bound_ms"])["bound_by"],
                responses=sum(b.get("responses", 0) for b in parts))


def kernel_of(sample):
    """(kernel name, wrapper, plain version, argument maker) of a sample's
    route."""
    from mach3_tpu_torch.splines import reweight

    if sample.kernel_route.variant == "shared":
        return ("reweight_shared", reweight.fused_reweight_histogram_shared,
                reweight.fused_reweight_histogram_shared_ref, sample.shared_kernel_args)
    if sample.kernel_route.variant == "generic":
        return ("reweight_perchain", reweight.fused_reweight_histogram,
                reweight.fused_reweight_histogram_ref, sample.perchain_kernel_args)
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


def wide_form_vs_plain(tag: str, sample, checked, smi: str, shuffle: bool = False) -> dict:
    """The shared kernel with a trivial plan — every parameter in every
    tile, the whole bin axis as the window: the function of the TPU's wide
    shared kernels K4b (P > 16) and K4a (P <= 16) — on a real sample,
    against the plain version; with ``shuffle`` the events are put in a
    random order first (K4a's events are unsorted). These launches are
    comparisons, not the path's. Returns the max abs error, times and
    bound."""
    import torch

    from mach3_tpu_torch.splines import plan, reweight

    args, kwargs, _ = checked
    dev = args[0].device
    if shuffle:
        perm = torch.randperm(sample.n_events, generator=torch.Generator().manual_seed(0))
        perm = perm.to(dev)
        seg, t, coeffs, base_w, bins = args
        args = (seg, t, coeffs.index_select(2, perm).contiguous(),
                base_w.index_select(1, perm).contiguous(), bins.index_select(0, perm).contiguous())
        if kwargs.get("norm_s") is not None:
            kwargs = dict(kwargs, norm_s=kwargs["norm_s"].index_select(1, perm).contiguous())
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
    km, pm = time_pair(lambda: reweight.fused_reweight_histogram_shared(*args, **kw),
                       lambda: reweight.fused_reweight_histogram_shared_ref(*args, **kw))
    bnd = forward_bound(args, kw)
    phase(f"[{tag}:wide-form-vs-plain] {sample.name} (reweight_shared, trivial plan, window "
          f"{nbl} bins, P={args[0].shape[1]}{', events shuffled' if shuffle else ''}): "
          f"max|dmc|={e1:.3e} max|dw2|={e2:.3e} max rel err {max(q1, q2):.3e} "
          f"(worst {max(r1, r2):.3f} of tol); kernel {km:.4f} ms, plain {pm:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}) | {smi}")
    return dict(max_abs_err=max(e1, e2), ms=km, plain_ms=pm, **bnd)


def plan_vs_trivial(tag: str, sample, checked, smi: str) -> None:
    """The shifted kernel under the sample's activity plan against the same
    kernel under a trivial plan (every parameter on every tile) and against
    the plain version, on the same arguments: all three within the kernels'
    tolerance of each other, and both kernel times. These launches are
    comparisons, not the path's."""
    import torch

    from mach3_tpu_torch.splines import plan, reweight

    args, kwargs, _ = checked
    dev = args[0].device
    if kwargs.get("plan_ptr") is None:
        raise AssertionError(f"{sample.name}: a shifted-route sample without an activity plan")
    ptr, idx = plan.trivial_active(sample.n_events, args[0].shape[1])
    kw_t = dict(kwargs, plan_ptr=torch.as_tensor(ptr, device=dev),
                plan_idx=torch.as_tensor(idx, device=dev))
    kern, ref = (reweight.fused_reweight_histogram_shifted,
                 reweight.fused_reweight_histogram_shifted_ref)
    real, triv, plain = kern(*args, **kwargs), kern(*args, **kw_t), ref(*args, **kwargs)
    worst = 0.0
    for a, b, what in ((real, plain, "plan vs plain"), (triv, plain, "trivial vs plain"),
                       (real, triv, "plan vs trivial")):
        for x, y, h in zip(a, b, ("mc", "w2")):
            worst = max(worst, compare(x, y, K_RTOL, K_ATOL_FRAC, f"{sample.name} {what} {h}")[2])
    t = [cuda_ms(lambda: kern(*args, **kw_t), 10), cuda_ms(lambda: kern(*args, **kwargs), 30),
         cuda_ms(lambda: kern(*args, **kwargs), 30), cuda_ms(lambda: kern(*args, **kw_t), 10)]
    bnd = forward_bound(args, kwargs)
    phase(f"[{tag}:shifted-plan-vs-trivial] {sample.name} (reweight_shifted): the plan lists "
          f"{int(kwargs['plan_idx'].numel())} (tile, parameter) pairs, the trivial plan "
          f"{len(idx)}; plan vs plain, trivial vs plain and plan vs trivial all within "
          f"{worst:.3f} of tol; kernel under the plan {0.5 * (t[1] + t[2]):.4f} ms, under the "
          f"trivial plan {0.5 * (t[0] + t[3]):.4f} ms, bound {bnd['bound_ms']:.4f} ms | {smi}")


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
    phase(f"[{tag}:nll-vs-plain] total_nll_batch [{total.shape[0]}] finite; per-sample max |kernel - "
          f"plain| = {float(d_nll.max()):.3e} ({worst:.3f} of tol, median tol "
          f"{float(tols.median()):.3e}); median total {float(total.median()):.3f} | {smi}")


def check_launches(tag: str, got: dict, want: dict) -> None:
    """Every kernel's launches equal ``want`` (0 for a kernel not named)."""
    full = {k: want.get(k, 0) for k in got}
    if got != full:
        raise AssertionError(f"{tag}: kernel launches {got} != {full}")


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
    check_launches(f"{tag} ({steps} steps)", launches,
                   {k: v * steps for k, v in launches_per_step.items()})
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


def time_pair(kern, ref, reps: int = 30, ref_reps: int = 5) -> tuple[float, float]:
    """(kernel ms, plain ms) per call with CUDA events, in turns plain,
    kernel, kernel, plain."""
    kern(), ref()
    t = [cuda_ms(ref, ref_reps), cuda_ms(kern, reps), cuda_ms(kern, reps), cuda_ms(ref, ref_reps)]
    return 0.5 * (t[1] + t[2]), 0.5 * (t[0] + t[3])


def response_rate(bnd: dict, ms: float) -> str:
    """The non-identity responses of a call per second of kernel time."""
    return (f"{bnd['responses'] / (1e-3 * ms):.3e} responses/s "
            f"({bnd['responses']:.3e} non-identity responses)")


def layout_info(sample) -> str:
    """A laid-out sample's tiles, distinct active-parameter lists (at least
    its activity groups), pad share and mean active parameters per tile."""
    ptr, idx = sample.hist_plan_ptr.tolist(), sample.hist_plan_idx.tolist()
    lists = {tuple(idx[a:b]) for a, b in zip(ptr[:-1], ptr[1:])}
    window = "" if sample.hist_nbl is None else f" window={sample.hist_nbl}"
    return (f"{window} tiles={len(ptr) - 1} distinct active lists={len(lists)} pad share="
            f"{float(sample.event_pad.float().mean()):.4f} active params/tile="
            f"{(ptr[-1] - ptr[0]) / max(len(ptr) - 1, 1):.2f} of "
            f"{sample.spline_table.n_spline_params}")


def time_kernel(tag: str, sample, args, kwargs, smi: str) -> tuple[float, float, dict]:
    """(kernel ms, plain ms, bound) of a sample's forward kernel."""
    _, kern, ref, _ = kernel_of(sample)
    km, pm = time_pair(lambda: kern(*args, **kwargs), lambda: ref(*args, **kwargs))
    bnd = forward_bound(args, kwargs)
    phase(f"[{tag}:kernel-time] {sample.name}: kernel {km:.4f} ms, plain {pm:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; kernel at "
          f"{bnd['bound_ms'] / km:.3f} of it), {response_rate(bnd, km)} "
          f"(C={args[3].shape[0]}, E={sample.n_events}, B={sample.n_bins}) | {smi}")
    return km, pm, bnd


def backward_vs_plain(tag: str, model, thetas, tables, smi: str) -> dict:
    """K6a and K6b against their plain versions on each sample's inputs at
    these chains: the forward's arguments of the differentiable route and
    the cotangents of the sample's statistic. Pass B is fed pass A's kernel
    outputs on both sides. Returns {sample name: (A err, B err, A ms, A
    plain ms, B ms, B plain ms, A bound, B bound)}: pass A reads (seg, t),
    the table's rows, base_w, the bins and the cotangents and writes four
    [C, E] fields (7 operations per evaluated (chain, event, parameter), 6
    per (chain, event)); pass B reads the rows and three [C, E] fields and
    writes [C, P] (15 operations per evaluated triple: response, slope,
    product)."""
    import torch

    from mach3_tpu_torch.splines import grad

    out = {}
    for i, s in enumerate(model.samples):
        route = s._diff_route()
        args, kw = s.diff_kernel_args(thetas, tables[i])
        t, base_w, seg, coeffs = args[:4]
        fwd = {"shared": grad.fused_reweight_diff, "shifted": grad.fused_reweight_diff_shifted,
               "generic": grad.fused_reweight_diff_perchain}[route]
        plan = {}
        if route == "shared":
            bins, plan = args[4], dict(plan_ptr=kw["plan_ptr"], plan_idx=kw["plan_idx"])
        else:
            bins = args[-1]
        mc, w2 = (v.detach().requires_grad_(True) for v in fwd(*args, **kw))
        gmc, gw2 = (g.float().contiguous() for g in
                    torch.autograd.grad(s._stat_sum(mc, w2).sum(), (mc, w2)))
        a_in = (seg, t, coeffs, base_w, bins, gmc, gw2)
        got_a = grad.grad_pass_a(*a_in, n_bins=s.n_bins, **plan)
        ref_a = grad.grad_pass_a_ref(*a_in, n_bins=s.n_bins, **plan)
        n_par = coeffs.shape[0]
        err_a, worst_a = 0.0, 0.0
        for got, ref, name in zip(got_a[:3], ref_a[:3], ("g_base", "sev", "pnz")):
            e, _, r = compare(got, ref, GRAD_RTOL * n_par, K_ATOL_FRAC, f"{s.name} pass A {name}")
            err_a, worst_a = max(err_a, e), max(worst_a, r)
        if not torch.equal(got_a[3], ref_a[3]):
            raise AssertionError(f"{s.name} pass A: zero counts differ from the plain version")
        b_in = (seg, t, coeffs) + got_a[1:]
        got_b = grad.grad_pass_b(*b_in, **plan)
        ref_b = grad.grad_pass_b_ref(*b_in, **plan)
        if not bool(torch.isfinite(got_b).all()):
            raise AssertionError(f"{s.name} pass B: non-finite values")
        err_b = (got_b - ref_b).abs().double()
        worst_b = float((err_b / (GRAD_RTOL * n_par * grad.pass_b_term_scale(*b_in) + 1e-30))
                        .max())
        if worst_b > 1.0:
            raise AssertionError(f"{s.name} pass B: error {float(err_b.max()):.3e} is "
                                 f"{worst_b:.2f}x the tolerance")
        a_ms = time_pair(lambda: grad.grad_pass_a(*a_in, n_bins=s.n_bins, **plan),
                         lambda: grad.grad_pass_a_ref(*a_in, n_bins=s.n_bins, **plan))
        b_ms = time_pair(lambda: grad.grad_pass_b(*b_in, **plan),
                         lambda: grad.grad_pass_b_ref(*b_in, **plan))
        c, e = base_w.shape
        coef, pairs = coefficient_reads(seg, coeffs)
        plan_bytes = _nbytes(*plan.values())
        a_bnd = bound(_nbytes(*a_in[:2], *a_in[3:]) + plan_bytes + coef + 16 * c * e,
                      c * (7 * pairs + 6 * e))
        b_bnd = bound(_nbytes(seg, t, *got_a[1:]) + plan_bytes + coef + 4 * c * n_par,
                      15 * c * pairs)
        out[s.name] = (err_a, float(err_b.max())) + a_ms + b_ms + (a_bnd, b_bnd)
        form = "shared bins, plan" if route == "shared" else "per-chain bins"
        phase(f"[{tag}:grad-kernels] {s.name} ({form}): C={thetas.shape[0]} E={s.n_events} "
              f"P={n_par}; pass A max abs err {err_a:.3e} (worst {worst_a:.3f} of tol), nz "
              f"equal; pass B max abs err {float(err_b.max()):.3e} (worst {worst_b:.3f} of "
              f"tol); grad_a {a_ms[0]:.4f} ms vs plain {a_ms[1]:.4f} ms (bound "
              f"{a_bnd['bound_ms']:.4f}), grad_b {b_ms[0]:.4f} ms vs plain {b_ms[1]:.4f} ms "
              f"(bound {b_bnd['bound_ms']:.4f}) | {smi}")
    return out


def diff_nll_vs_sampling(tag: str, model, thetas, tables, smi: str) -> None:
    """Each sample's differentiable NLL (norm in the base weight) against its
    sampling NLL (norm in the kernel): each within its NLL tolerance of the
    plain route, so within twice that of each other."""
    import torch

    worst, d_max = 0.0, 0.0
    for i, s in enumerate(model.samples):
        diff = s.log_likelihood_batch_diff(thetas, tables[i])
        samp = s.log_likelihood_batch(thetas, tables[i])
        tol = 2.0 * nll_tolerance(s, *s.reweight_batch_plain(thetas, tables[i]))
        if not bool(torch.isfinite(diff).all()):
            raise AssertionError(f"{tag}: {s.name} non-finite differentiable NLL")
        d = (diff - samp).abs()
        worst, d_max = max(worst, float((d / tol).max())), max(d_max, float(d.max()))
    if worst > 1.0:
        raise AssertionError(f"{tag}: differentiable vs sampling NLL {d_max:.3e} is "
                             f"{worst:.2f}x the tolerance")
    phase(f"[{tag}:diff-nll] log_likelihood_batch_diff vs log_likelihood_batch: max |d| "
          f"{d_max:.3e} ({worst:.3f} of tol) | {smi}")


def posterior_grad_vs_plain(tag: str, model, thetas, per_eval: dict, smi: str) -> float:
    """The gradient of log_posterior_batch through the kernels (one forward,
    one backward: ``per_eval`` launches) against autograd of the plain
    route; returns the gap as a fraction of each chain's largest
    component."""
    import torch

    from mach3_tpu_torch.splines import reweight

    t = thetas.detach().clone().requires_grad_(True)
    reset_launches()
    lp = model.log_posterior_batch(t)
    (g,) = torch.autograd.grad(lp.sum(), t)
    torch.cuda.synchronize()
    check_launches(f"{tag} gradient", dict(reweight.LAUNCHES), per_eval)
    lp_p = model.log_posterior_batch(t, plain=True)
    (g_p,) = torch.autograd.grad(lp_p.sum(), t)
    if not bool(torch.isfinite(g).all() and torch.isfinite(lp).all()):
        raise AssertionError(f"{tag}: non-finite log-density or gradient through the kernels")
    rel = (g - g_p).abs() / g_p.abs().amax(1, keepdim=True)
    gap, worst_param = float(rel.max()), int(rel.amax(0).argmax())
    if gap > GRAD_E2E:
        raise AssertionError(f"{tag}: gradient through the kernels vs the plain route {gap:.3e} "
                             f"of the largest component > {GRAD_E2E}")
    phase(f"[{tag}:grad] d log_posterior_batch / dθ [{t.shape[0]}, {t.shape[1]}] through the "
          f"kernels vs the plain route: {gap:.3e} of each chain's largest component (bound "
          f"{GRAD_E2E}; worst at parameter {worst_param}); max |Δ logp| {float((lp - lp_p).detach().abs().max()):.3e}; launches per "
          f"evaluation {per_eval} | {smi}")
    return gap


def toy_minimize(model, smi: str) -> None:
    """L-BFGS-B (``run_minimizer``) on the toy from a 0.5 prior-sigma jitter:
    converged, χ² not above the start, at the Asimov minimum (MIN_CHI2,
    MIN_PULL), a positive-definite Hessian and finite errors; every
    evaluation one forward and one backward. The energy scale is held at its
    prefit value: it moves events across bin edges only, so the χ² is a
    staircase in it whose gradient is zero, and with it free L-BFGS-B stalls
    on a step of that staircase (χ² 0.1-40 on this 100k-event Asimov toy, by
    start point)."""
    import numpy as np
    import torch

    from mach3_tpu_torch.fitters.minimize import run_minimizer, shift_params
    from mach3_tpu_torch.splines import reweight

    dev = model.flat.prefit.device
    x0 = jitter_init(model, 1, np.random.default_rng(3), frac=0.5)[0]
    fixed = np.zeros(len(x0), bool)
    fixed[shift_params(model)] = True
    x0[fixed] = model.prefit_vector().cpu().numpy()[fixed]
    with torch.no_grad():
        chi2_0 = -2.0 * float(model.log_posterior(torch.as_tensor(x0, device=dev)))
    reset_launches()
    t0 = time.perf_counter()
    res = run_minimizer(model, x0=x0, fixed=fixed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = res.n_evaluations
    check_launches("toy:minimize", dict(reweight.LAUNCHES),
                   {k: v * n for k, v in TOY_GRAD_LAUNCHES.items()})
    if not res.success or not res.chi2 <= chi2_0:
        raise AssertionError(f"toy:minimize: {res.message}; chi2 {res.chi2:.6g} from {chi2_0:.6g}")
    if res.covariance is None or not np.isfinite(res.errors).all():
        raise AssertionError("toy:minimize: no finite Hesse errors")
    free = np.any(res.covariance != 0, axis=0)
    eig = np.linalg.eigvalsh(res.covariance[np.ix_(free, free)])
    if not (eig > 0).all():
        raise AssertionError(f"toy:minimize: Hessian not positive definite (eig min {eig.min()})")
    pull = np.abs(res.x - model.prefit_vector().cpu().numpy())[free] / res.errors[free]
    if not (res.chi2 <= MIN_CHI2 and pull.max() <= MIN_PULL):
        raise AssertionError(f"toy:minimize: chi2 {res.chi2:.3e} and largest |x - prefit| / "
                             f"error {pull.max():.3e}: not the Asimov minimum")
    phase(f"[toy:minimize] L-BFGS-B: chi2 {chi2_0:.4f} -> {res.chi2:.6g} in {n} evaluations, "
          f"{dt:.3f} s ({1e3 * dt / n:.3f} ms/evaluation incl. Hesse); {int(free.sum())} free "
          f"params, covariance eigenvalues in [{eig.min():.3e}, {eig.max():.3e}], largest "
          f"|x - prefit| / error {pull.max():.3e} (bound {MIN_PULL}); launches "
          f"{dict(reweight.LAUNCHES)} | {smi}")


def timed_ms(fn, iters: int) -> float:
    """Host ms per call of ``fn`` over ``iters`` calls ending in a
    synchronize, after one untimed call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def grad_budget(model, thetas, smi: str) -> None:
    """The bench's ``hmc_large_grad_budget``: the sampling forward
    (``total_nll_batch``), the differentiable forward, forward + backward,
    their ratios, and a profile of one gradient evaluation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t = thetas.detach().clone().requires_grad_(True)

    def grad_eval():
        return torch.autograd.grad(model.log_posterior_batch(t).sum(), t)

    with torch.no_grad():
        fused = timed_ms(lambda: model.total_nll_batch(thetas), BUDGET_ITERS)
        fwd = timed_ms(lambda: model.log_posterior_batch(thetas), BUDGET_ITERS)
    grad_ms = timed_ms(grad_eval, BUDGET_ITERS)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        grad_eval()
        torch.cuda.synchronize()
    dev_ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ops) / 1e3

    def share(name):
        return sum(e.self_device_time_total for e in dev_ops if name in e.key) / 1e3

    top = sorted(dev_ops, key=lambda e: -e.self_device_time_total)[:5]
    phase(f"[large:grad-budget] {thetas.shape[0]} chains, {BUDGET_ITERS} iterations: sampling "
          f"forward {fused:.3f} ms, differentiable forward {fwd:.3f} ms, forward + backward "
          f"{grad_ms:.3f} ms; diff forward / sampling forward {fwd / fused:.3f}, gradient / "
          f"sampling forward {grad_ms / fused:.3f} | {smi}")
    phase(f"[large:grad-profile] one gradient evaluation: {sum(e.count for e in dev_ops)} "
          f"device ops, device busy {busy:.3f} ms (grad_a {share('grad_a_kernel'):.3f}, grad_b "
          f"{share('grad_b_kernel'):.3f}, reweight_shared {share('reweight_shared'):.3f}, "
          f"reweight_shifted {share('reweight_shifted'):.3f} ms) against {grad_ms:.3f} ms "
          f"unprofiled: device idle share {1.0 - busy / grad_ms:.3f}; top: "
          + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f}" for e in top)
          + f" | {smi}")


def run_chees(model, thetas, smi: str) -> dict:
    """ChEES-HMC with the bench's configuration (``bench.py:947-957``):
    warm-up and adaptation, then timed steps whose kernel launches must be
    what the fitter's own evaluation counts imply. Returns the launches."""
    import torch

    from mach3_tpu_torch.fitters.hmc import HMC, HMCConfig
    from mach3_tpu_torch.splines import reweight

    cfg = HMCConfig(step_size=0.02, adapt_steps=60, adapt_trajectory=True, max_leapfrog=12,
                    chunk_size=10)
    n_chains = thetas.shape[0]
    fit = HMC(model, cfg, thetas.cpu().numpy(), seed=8)
    t0 = time.perf_counter()
    fit.run(n_steps=CHEES_WARM, collect=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    acc0 = fit.state.n_accepted.clone()
    n_grad0, n_logp0 = fit.n_grad_evals, fit.n_logp_evals
    reset_launches()
    t0 = time.perf_counter()
    out = fit.run(n_steps=CHEES_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(reweight.LAUNCHES)
    n_grad, n_logp = fit.n_grad_evals - n_grad0, fit.n_logp_evals - n_logp0
    fwd = {"reweight_shared": 2, "reweight_shifted": 1}
    want = {k: v * (n_grad + n_logp) for k, v in fwd.items()}
    want.update(grad_a=3 * n_grad, grad_b=3 * n_grad)
    check_launches("large:chees", launches, want)
    st = fit.state
    if not bool(torch.isfinite(st.logp).all()):
        raise AssertionError("large:chees: non-finite logp")
    acc = float((st.n_accepted - acc0).sum()) / (n_chains * CHEES_STEPS)
    if not CHEES_ACC[0] < acc < CHEES_ACC[1]:
        raise AssertionError(f"large:chees: acceptance {acc:.4f} outside {CHEES_ACC}")
    eps, traj = float(torch.exp(st.log_eps)), float(torch.exp(st.log_traj))
    if not (math.isfinite(eps) and math.isfinite(traj)
            and eps * (1 - 1e-9) <= traj <= cfg.max_leapfrog * eps * (1 + 1e-9)):
        raise AssertionError(f"large:chees: step size {eps} / trajectory time {traj} outside "
                             f"[eps, {cfg.max_leapfrog} eps]")
    phase(f"[large:chees] {n_chains} chains: {CHEES_WARM} warm-up/adaptation steps in "
          f"{warm_s:.1f} s, then {CHEES_STEPS} timed steps in {dt:.3f} s: "
          f"{n_chains * CHEES_STEPS / dt:.1f} chain-steps/s, mean {out['n_leapfrog'].mean():.2f} "
          f"leapfrog steps, {n_grad} gradient evaluations ({1e3 * dt / n_grad:.3f} ms each), "
          f"acceptance {acc:.4f}, step size {eps:.5g}, trajectory time {traj:.5g}; launches "
          f"{launches} | {smi}")
    return launches


def toy_path(dev, smi: str, quick: bool = False) -> dict:
    import numpy as np
    import torch

    from mach3_tpu_torch.tutorial.toy import build_toy

    t0 = time.perf_counter()
    model = build_toy(n_events=N_EVENTS, seed=SEED, e_grid_size=E_GRID, device=dev).model
    routes = [s.kernel_route.variant for s in model.samples]
    phase(f"[toy] built in {time.perf_counter() - t0:.1f} s; "
          + "; ".join(f"{s.name}: E={s.n_events}{layout_info(s)}" for s in model.samples)
          + f"; routes {routes} | {smi}")
    if routes != ["shifted", "shifted"]:
        raise AssertionError(f"both toy samples must take the shifted route, got {routes}")
    thetas = torch.as_tensor(jitter_init(model, N_CHAINS, np.random.default_rng(0)), device=dev)

    with torch.no_grad():
        tables = model._shared_osc_tables(thetas)
        checked = kernels_vs_plain("toy", model, thetas, tables, smi)
        if quick:
            for s in model.samples:
                time_kernel("toy", s, *checked[s.name][:2], smi)
            return {}
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
    with torch.no_grad():
        times = [time_kernel("toy", s, *checked[s.name][:2], smi) for s in model.samples]

    grads = backward_vs_plain("toy", model, thetas, tables, smi)
    with torch.no_grad():
        diff_nll_vs_sampling("toy", model, thetas, tables, smi)
    posterior_grad_vs_plain("toy", model, thetas, TOY_GRAD_LAUNCHES, smi)
    toy_minimize(model, smi)
    return {"K1": dict(launches=launches["reweight_shifted"],
                       max_abs_err=max(v[2] for v in checked.values()),
                       ms=sum(v[0] for v in times), plain_ms=sum(v[1] for v in times),
                       **summed([v[2] for v in times])),
            "grad": grads}


def large_path(dev, smi: str, quick: bool = False) -> tuple[dict, object]:
    import numpy as np
    import torch

    from mach3_tpu_torch.tutorial.large import build_large

    t0 = time.perf_counter()
    model = build_large(seed=LARGE_SEED, low_memory=True, device=dev).model
    build_s = time.perf_counter() - t0
    routes = [s.kernel_route.variant for s in model.samples]
    parts = []
    for s in model.samples:
        info = (f"{s.name}: E={s.n_events} B={s.n_bins} P={s.spline_table.n_spline_params} "
                f"route={s.kernel_route.variant}")
        if s.hist_plan_ptr is not None:
            info += layout_info(s)
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
        wide = wide_form_vs_plain("large", model.samples[0], checked[model.samples[0].name], smi)
        plan_vs_trivial("large", model.samples[1], checked[model.samples[1].name], smi)
        if quick:
            for s in model.samples:
                time_kernel("large", s, *checked[s.name][:2], smi)
            return {}, model
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
    shared = [times["numu_beam"], times["atmo"]]
    results = {
        "K3": dict(launches=launches["reweight_shifted"], max_abs_err=err["nue_beam"],
                   ms=times["nue_beam"][0], plain_ms=times["nue_beam"][1],
                   **times["nue_beam"][2]),
        "K2": dict(launches=launches["reweight_shared"],
                   max_abs_err=max(err["numu_beam"], err["atmo"]),
                   ms=sum(v[0] for v in shared), plain_ms=sum(v[1] for v in shared),
                   **summed([v[2] for v in shared])),
        "K4b": wide,
    }
    del fitter, checked
    return results, model


def large_grad_path(model, dev, smi: str) -> tuple[dict, dict]:
    """The gradient path on the large fixture at the bench's 64 chains;
    returns (per-sample backward-kernel results, the ChEES run's launches)."""
    import numpy as np
    import torch

    thetas = torch.as_tensor(jitter_init(model, GRAD_CHAINS, np.random.default_rng(0)),
                             device=dev)
    with torch.no_grad():
        tables = model._shared_osc_tables(thetas)
    grads = backward_vs_plain("large", model, thetas, tables, smi)
    with torch.no_grad():
        diff_nll_vs_sampling("large", model, thetas, tables, smi)
    posterior_grad_vs_plain("large", model, thetas, LARGE_GRAD_LAUNCHES, smi)
    grad_budget(model, thetas, smi)
    launches = run_chees(model, thetas, smi)
    return grads, launches


def blockdiag_vs_plain(model, checked, smi: str) -> dict:
    """K5b (``hist="blockdiag"``) against the plain version on each
    per-chain sample's arguments, within the kernels' tolerance, and twice:
    bit for bit the same (no float atomics). Returns its max abs error,
    times and bound."""
    import torch

    from mach3_tpu_torch.splines import reweight

    errs, times, bounds = [], [], []
    for s in model.samples:
        if s.kernel_route.variant != "generic":
            continue
        args, kwargs, _ = checked[s.name]
        kw = dict(kwargs, hist="blockdiag")
        got = reweight.fused_reweight_histogram(*args, **kw)
        again = reweight.fused_reweight_histogram(*args, **kw)
        if not all(torch.equal(x, y) for x, y in zip(got, again)):
            raise AssertionError(f"{s.name}: the deterministic histogram differs between runs")
        ref = reweight.fused_reweight_histogram_ref(*args, **kw)
        e1, q1, r1 = compare(got[0], ref[0], K_RTOL, K_ATOL_FRAC, f"{s.name} blockdiag mc")
        e2, q2, r2 = compare(got[1], ref[1], K_RTOL, K_ATOL_FRAC, f"{s.name} blockdiag w2")
        km, pm = time_pair(lambda: reweight.fused_reweight_histogram(*args, **kw),
                           lambda: reweight.fused_reweight_histogram_ref(*args, **kw))
        errs.append(max(e1, e2))
        times.append((km, pm))
        bounds.append(forward_bound(args, kw))
        phase(f"[exp:blockdiag-vs-plain] {s.name} (reweight_perchain_det): max|dmc|={e1:.3e} "
              f"max|dw2|={e2:.3e} max rel err {max(q1, q2):.3e} (worst {max(r1, r2):.3f} of "
              f"tol); bit-identical over two runs; kernel {km:.4f} ms, plain {pm:.4f} ms, bound "
              f"{bounds[-1]['bound_ms']:.4f} ms | {smi}")
    return dict(max_abs_err=max(errs), ms=sum(t[0] for t in times),
                plain_ms=sum(t[1] for t in times), **summed(bounds))


def exp_path(dev, smi: str) -> dict:
    """The YAML experiment path: files written into a temporary directory,
    ``build_experiment`` on the card, then the phases of the other paths,
    the deterministic histogram's run and the gradient at 64 chains."""
    import tempfile

    import numpy as np
    import torch

    from mach3_tpu_torch.core.config import Config
    from mach3_tpu_torch.samples.experiment import build_experiment
    from mach3_tpu_torch.splines import reweight
    from mach3_tpu_torch.tutorial.experiment_files import write_experiment

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = Config.from_file(str(write_experiment(tmp, n_events=EXP_EVENTS, seed=EXP_SEED)))
        written_s = time.perf_counter() - t0
        model = build_experiment(cfg, device=dev).model
    routes = [s.kernel_route.variant for s in model.samples]
    phase(f"[exp] files written in {written_s:.1f} s, built in "
          f"{time.perf_counter() - t0 - written_s:.1f} s; {model.n_params} params; "
          + "; ".join(f"{s.name}: E={s.n_events} B={s.n_bins} P={s.spline_table.n_spline_params} "
                      f"TF1={0 if s.tf1_table is None else s.tf1_table.n_tf1_params} "
                      f"weight fns={len(s.weight_fns)} route={s.kernel_route.variant}"
                      for s in model.samples) + f" | {smi}")
    if routes != EXP_ROUTES:
        raise AssertionError(f"experiment routes must be {EXP_ROUTES}, got {routes}")
    thetas = torch.as_tensor(jitter_init(model, N_CHAINS, np.random.default_rng(0)), device=dev)

    with torch.no_grad():
        tables = model._shared_osc_tables(thetas)
        checked = kernels_vs_plain("exp", model, thetas, tables, smi)
        k5b = blockdiag_vs_plain(model, checked, smi)
        nd = model.samples[2]
        k4a = wide_form_vs_plain("exp", nd, checked[nd.name], smi, shuffle=True)
        _, _, asimov = model.total_nll_batch_parts(model.prefit_vector()[None])
        phase(f"[exp:asimov] per-sample NLL at prefit through the kernels "
              f"{[f'{float(v):.3e}' for v in asimov[0]]} (bound {ASIMOV_ATOL}) | {smi}")
        if not float(asimov.abs().max()) < ASIMOV_ATOL:
            raise AssertionError(f"experiment Asimov NLL at prefit {asimov.tolist()}")
        nll_vs_plain("exp", model, thetas, tables, smi)

    fitter, step_ms, launches = run_mr2t2(
        "exp", model, thetas, CHUNK, CHUNK * TIMED_CHUNKS, CHUNK, EXP_LAUNCHES, smi, ACC_MIN)
    profile_steps("exp", fitter, step_ms, ["reweight_perchain", "reweight_shared"], smi)
    generic = [s for s in model.samples if s.kernel_route.variant == "generic"]
    for s in generic:
        s.perchain_hist = "blockdiag"
    reset_launches()
    t0 = time.perf_counter()
    fitter.run(n_steps=EXP_DET_STEPS, collect=False)
    torch.cuda.synchronize()
    det_s = time.perf_counter() - t0
    det_launches = dict(reweight.LAUNCHES)
    check_launches("exp:mr2t2-blockdiag", det_launches,
                   {"reweight_perchain_blockdiag": 2 * EXP_DET_STEPS,
                    "reweight_shared": EXP_DET_STEPS})
    if not bool(torch.isfinite(fitter.state.nll).all()):
        raise AssertionError("exp: non-finite chain NLL with the deterministic histogram")
    for s in generic:
        s.perchain_hist = "maskreduce"
    phase(f"[exp:mr2t2-blockdiag] {EXP_DET_STEPS} more steps with hist='blockdiag': "
          f"{1e3 * det_s / EXP_DET_STEPS:.3f} ms/step, launches {det_launches} | {smi}")
    with torch.no_grad():
        times = {s.name: time_kernel("exp", s, *checked[s.name][:2], smi) for s in model.samples}
    del fitter

    thetas = torch.as_tensor(jitter_init(model, GRAD_CHAINS, np.random.default_rng(0)),
                             device=dev)
    with torch.no_grad():
        tables = model._shared_osc_tables(thetas)
    grads = backward_vs_plain("exp", model, thetas, tables, smi)
    with torch.no_grad():
        diff_nll_vs_sampling("exp", model, thetas, tables, smi)
    posterior_grad_vs_plain("exp", model, thetas, EXP_GRAD_LAUNCHES, smi)

    perchain = [times[s.name] for s in generic]
    k4a["launches"] = launches["reweight_shared"]
    k5b["launches"] = det_launches["reweight_perchain_blockdiag"]
    return {
        "K5": dict(launches=launches["reweight_perchain"],
                   max_abs_err=max(checked[s.name][2] for s in generic),
                   ms=sum(v[0] for v in perchain), plain_ms=sum(v[1] for v in perchain),
                   **summed([v[2] for v in perchain])),
        "K5b": k5b,
        "K4a": k4a,
        "grad": grads,
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

    if sys.argv[1:] == ["--kernel-times"]:
        toy_path(dev, smi, quick=True)
        large_path(dev, smi, quick=True)
        print(smi)
        return 0
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]} (only --kernel-times)")

    results = toy_path(dev, smi)
    toy_grads = results.pop("grad")
    results.update(exp_path(dev, smi))
    exp_grads = results.pop("grad")
    large_results, model = large_path(dev, smi)
    results.update(large_results)
    grads, chees = large_grad_path(model, dev, smi)
    results["K4b"]["launches"] = chees["reweight_shared"]
    every = {**toy_grads, **exp_grads, **grads}
    for k, j in (("K6a", 0), ("K6b", 1)):
        results[k] = dict(launches=chees[f"grad_{k[-1]}"],
                          max_abs_err=max(v[j] for v in every.values()),
                          ms=sum(v[2 + 2 * j] for v in grads.values()),
                          plain_ms=sum(v[3 + 2 * j] for v in grads.values()),
                          **summed([v[6 + j] for v in grads.values()]))

    print(json.dumps({"kernels": [
        {"name": NAMES.get(k, SOURCES[k]), "route": "cuda",
         "source": f"mach3_tpu_torch/csrc/{SOURCES[k]}.cu", "replaces": TPU_KERNELS[k],
         "library_ms": None, **{f: v for f, v in results[k].items() if f != "responses"}}
        for k in TPU_KERNELS
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
