#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mach3_tpu_torch``) on one NVIDIA GPU.

Drives the port's paths through its hand-written CUDA kernels
(``splines/reweight.py`` forward, ``splines/grad.py`` backward) and checks
each kernel against its plain PyTorch version. Run from the repository root:

    python3 chip_smoke.py        # needs one CUDA GPU and nvcc

* The toy path: the toy MR2T2 fit at the bench's full width, 100,000 events
  x 256 chains, energy grid 200; both samples on the shifted kernel (K1).
  Its gradient path: the backward kernel (K6a and K6b fused; the shifted
  axis binned in-kernel, under the activity plan) on both samples, the
  gradient of ``log_posterior_batch`` through the kernels vs the plain route,
  the L-BFGS fit (``run_minimizer``) from a jittered start, the bench's
  ChEES-HMC run on the toy as replayed CUDA graphs with its ESS/hour
  (``[toy:chees]``) and ``mach3-mcmc-torch`` running jittered HMC with a
  resume (``[toy:hmc-cli]``).
* The large path: the reference-scale fixture ``build_large(low_memory=True)``
  (101 parameters, 3 samples, 2,182 bins, bf16 tables, f32 statistic) at 128
  chains; numu_beam and atmo on the shared kernel (K2; K4b is its trivial
  plan), nue_beam on the shifted kernel with P = 43 under its activity plan
  (K3; also held against the same kernel under a trivial plan), atmo through
  layered-PREM oscillation. Its gradient path at the JAX bench's 64 chains:
  the backward kernel on shared bins (numu_beam, atmo) and on the shifted
  axis (nue_beam, also held under a trivial plan against its activity plan),
  the differentiable NLL vs the sampling NLL, the gradient vs the plain
  route, the gradient budget (``hmc_large_grad_budget``; one evaluation
  eagerly and as a captured graph's replay) and ChEES-HMC
  (``chees_hmc_large``) as replayed CUDA graphs beside the eager loop, with
  graph steps shadowed by eager ones (``[large:chees:graph-vs-eager]``).
* The experiment path: the YAML experiment of
  ``tutorial/experiment_files.py`` (the toy's 100,000 events in three
  samples, 19 parameters) written into a temporary directory and built by
  ``build_experiment`` at 256 chains: numu_2d (two shifts) and
  nue_nonuniform (hyper-rectangle bins with a shift, a TF1 response) on the
  per-chain kernel under their activity plans, binning in-kernel from their
  bin maps (K5; K5b is its ``hist="blockdiag"`` form; the same kernel with
  the bins given as input, the form of a shift that is torch code, is held
  against both), numu_nd (a weight function, static bins, P = 4) on the
  shared kernel, whose trivial plan computes K4a. Its gradient at 64 chains
  through K5, the shared kernel and the backward kernel (the bin map
  in-kernel on the generic route). Beside it: the same MC as ``.m3evt`` and
  ``.csv`` files, read by the native IO library (``core/nativeio.py``,
  built from ``native/m3io.cpp``) into builds bit-identical to the ``.npz``
  one (``[exp:io]``); polygon bins on two of its samples, static through the
  shared kernel and shifted through K5's bins-given form (``[exp:polygon]``);
  and the toy with sparse spline tables on the plain route against the
  dense toy through K1 (``[exp:sparse]``).
* The 700-parameter envelope: ``build_large700()`` at its defaults (seed
  2077; 2 x 180k numu, 2 x 60k nue, 3 x 180k atmo events; 655 splines, 700
  parameters, 5,364 bins; bf16 tables) at 128 chains: five samples on the
  shared kernel (K2) and the two nue samples on the shifted kernel with P =
  94 (K3), each against its plain version; ``total_nll_batch`` at 32 and 128
  chains; pooled adaptive MR2T2 with the JAX bench's reference-scale
  adaption settings as a graph (200 warm-up, 500 timed steps) and as the
  eager loop; each kernel's time and bound; one gradient evaluation at 16
  chains through the backward kernel, its budget eager and captured and a
  short ChEES run as graphs; the fixture cache's round trip
  (``[large700:*]``).

* The samplers (``fitters/mcmc.py``, ``fitters/delayed.py``): every MR2T2
  run's chunks are replayed CUDA graphs (the default on the card), each
  beside the same sampler as the eager loop (``[toy:graph]`` /
  ``[toy:eager]``, ``[exp:*]``, ``[large:*]``: chain-steps/s, and from a
  profile of 10 steps host launches, device ops, device busy and idle
  share). On the toy the production sampler, pooled adaptive MR2T2
  (``[toy:adaptive:*]``: launch, NLL and last-chunk acceptance gates),
  graph against eager from one saved state, pooled and per chain, with
  Robbins-Monro held over 100 steps, each divergence a near-tie and compared
  up to the pooled refresh that follows it (``[toy:graph-vs-eager]``,
  ``[toy:graph-vs-eager:per-chain]``) and on, each graph step shadowed by
  an eager one (``[toy:graph-vs-eager:rm]``, ``...:rm:per-chain``), per
  chain (``[toy:per-chain:*]``) and with delayed rejection
  (``[toy:delayed:*]``, each kernel twice a step); ``mach3-mcmc-torch`` on
  the YAML experiment at 256 chains with a resume (``[exp:cli]``). Every
  sampler run ends with its state's NLLs held against its θ's NLL
  evaluated anew.

* The remaining fitters (``fitters/tempering.py``, ``ensemble.py``,
  ``pso.py``, ``scans.py``), on the kernels of the paths above: on the toy
  parallel tempering at the JAX bench's 6 levels x 64 walkers
  (``[toy:pt]``, graph and eager, profiled, graph held against eager from
  one state), the stretch-move ensemble at 256 walkers
  (``[toy:ensemble]``), PSO at 64 particles x 500 iterations from the
  prefit (``[toy:pso]``), a 31 x 31 LLH scan on (sin²θ23, Δm²31)
  (``[toy:scan2d]``) and ``mach3-llhscan-torch`` (``[toy:llhscan-cli]``);
  the octant toy at 50,000 events, NH and IH (``[octant]``: the Asimov
  data equal, the sin²θ23 profile's bimodality, adaptive MR2T2 against PT
  from walkers started per octant; ``[octant:evidence]``: log Z(NH) −
  log Z(IH) > 0 from β = 0 ladders; ``[octant:4k]``: MR2T2 against PT at the
  JAX test's 4,000 events); on the large fixture ``llh_scan_1d`` of all
  101 parameters x 41 points on the chain axis, held against the plain
  route, ``sigma_variations`` through K2 and K3 and ``drag_race``
  (``[large:scan]``, ``[large:sigma-var]``, ``[large:drag-race]``);
  ``mach3-mcmc-torch`` running PT with a β = 0 ladder on the YAML
  experiment with a resume (``[exp:cli-pt]``). Every run's kernel launches
  are counted from 0 and gated.

* The analysis path (``diagnostics/predictive.py``, ``autocorr.py``,
  ``processor.py``, the post-processing CLIs): the posterior predictive with
  2,000 toys on the chain axis, drawn from the production sampler's run on
  the toy (K1; by-mode spectra from the interaction modes; spectra against
  the plain route, each toy's data NLL against ``total_nll_batch_parts``,
  the JAX test's p-value calibration: ``[toy:predictive]``) and from
  large700's adaptive run (K2 and K3 at the largest chunk the byte bound
  allows, against their plain versions: ``[large700:predictive]``); ESS,
  Geweke and batched means of large700's chain on the card against numpy
  and of an AR(1) chain of 10,000 x 128 x 700 f64 against its known τ
  (``[large700:ess]``); ``mach3-diag-torch``, ``-process-torch
  --jarlskog``, ``-rhat-``, ``-combine-`` and ``-predictive-torch`` on the
  toy's chain files (``[toy:post-cli]``), diag and process on
  ``[exp:cli]``'s.

* The sharded fit (``distributed/``): ``[toy:dist-1x1]`` one NCCL rank
  (a world of 1), a 1 x 1 (chains x events) mesh, the toy at full width:
  the sharded NLL against ``total_nll_batch``, the sharded pooled adaptive
  MR2T2 as graphs with its all-reduces captured against the unsharded one
  from one state and seed (Robbins-Monro held), then both timed as the
  production sampler, profiled (the eager step's collective calls, NCCL
  kernels in the graph, idle share) and held against their roofline;
  ``[large:dist-2proc]`` two spawned ranks sharing the card on gloo
  (NCCL refuses two ranks on one device), the large fixture at full size
  written once by this process: a 1 x 2 mesh (K2 and K3 on each rank's half
  of the events; NLLs against the unsharded ones, eager steps with their
  launches), then a 2 x 1 mesh writing one chain file per row, merged, and
  R-hat on the merged file. Beside the toy's, the large fixture's and
  large700's graphed steps a ``:roofline`` line: the step's
  ``fraction_of_memory_floor`` against the H100 SXM's peaks
  (``diagnostics/roofline.py``), gated in (0, 1.05].

Phases: device, kernel build (every source, in parallel), then per path:
build, kernel vs plain, Asimov check, NLL vs plain, MR2T2 as graphs and
eager with their profiles, the samplers, kernel timing; then the gradient
phases. Any failed phase raises and
the exit code is not 0. The last line of standard output is
``{"ok": true, "device": {...}}``; the line before it is the card's name and
power limit, and the one before that lists each kernel with its launches on
its path (K1 and K3: the toy and large MR2T2 runs; K2: the large MR2T2 run;
K1 also ``[toy:dist-1x1]``'s timed runs, K2 and K3 ``[large:dist-2proc]``'s;
K1, K2 and K3 also the predictive's runs on the toy and large700;
the large700 path's kernel figures are on its ``[large700:*]`` lines;
K4b and the backward kernel, which K6a and K6b share: the large ChEES run's
graph replays; K5, K4a:
the experiment's MR2T2 run; K5b: its run with the deterministic histogram),
its largest error against the plain
version, both times and its bound: the least time the card could take for
the same work, from the bytes each call must move (every input read once,
each output written once; a bin map's kinematic rows, not the [C, E] bins it
forms) at 3.35 TB/s and its f32 operations at 67 TFLOP/s, whichever is
larger (H100 SXM peaks). No single PyTorch call
computes a spline product and a histogram, so no kernel has a library time.

``python3 chip_smoke.py --kernel-times`` stops each of the toy and large
paths after its kernel-vs-plain, kernel-timing and grad-kernel phases (the
large ones at 64 chains, with the backward's plan-vs-trivial check) and
prints neither the kernels line nor the last line: a short run for work on a
kernel.

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
LARGE_CHEES = dict(step_size=0.02, adapt_steps=60, adapt_trajectory=True, max_leapfrog=12,
                   chunk_size=10)
# HMC runs as replayed CUDA graphs (the default on the card), each beside
# the eager loop: [large:chees] CHEES_EAGER eager steps from the graph run's
# state after its warm-up; [large:chees:graph-vs-eager] HMC_GVE_STEPS graph
# steps from the warm-up's state at step CHEES_GVE_AT (inside the 60-step
# adaptation window), each shadowed by one eager step from the graph's
# state. The two start each step alike, so they draw alike and integrate
# alike up to the atomics of K1/K2/K3 and of the gathers' backward: a
# decision may differ only where the two log α differ by at most GVE_NLL,
# θ of the other chains within HMC_GVE_THETA prior widths, log ε, log T and
# their averages within HMC_GVE_ADAPT (the atomics move the log-density by
# ~1e-5, the mean acceptance probability that dual averaging reads by less,
# and log ε by √t / 0.05 x that / (t + 10)).
CHEES_EAGER = 10
CHEES_GVE_AT = 30
HMC_GVE_STEPS = 6
HMC_GVE_THETA = 1e-4  # x each parameter's prior width
HMC_GVE_ADAPT = 1e-4
# A gradient evaluation runs ~5,900 device ops on the toy and ~17,000 on the
# large fixture (as many host launches eagerly), whose profile takes tens of
# seconds to read back per step: HMC profiles cover one step, and give
# their figures per gradient evaluation.
HMC_PROFILE_STEPS = 1
# [toy:chees]: the JAX bench's ChEES run on the toy (bench.py:872-900): 64
# chains, 200 warm-up/adaptation steps, 150 timed steps whose draws give
# ESS/hour as bench.py:245-273's ess_report computes it.
TOY_CHEES = dict(step_size=0.05, adapt_steps=150, adapt_trajectory=True, max_leapfrog=64,
                 chunk_size=50)
TOY_CHEES_CHAINS = 64
TOY_CHEES_WARM = 200
TOY_CHEES_STEPS = 150
# [large700:chees]: LARGE_CHEES at L7_GRAD_CHAINS chains, a short run.
L7_CHEES_WARM = 10
L7_CHEES_STEPS = 10
# [toy:hmc-cli]: mach3-mcmc-torch with jittered HMC on the toy, then a resume.
HMC_CLI = dict(events=20_000, chains=16, leapfrog=8, step_size=0.02, chunk=50, steps=100,
               resumed=150)
# The backward kernel vs its plain passes on the same inputs: ḡ_base
# elementwise (a product of P f32 responses, FMA-contracted Horner steps:
# rtol 1e-5 x P, atol 1e-6 x max); ḡ_t within 1e-5 x P of Σ_e |term| per
# (chain, param): a reduction over up to 200k events in another order, whose
# terms cancel.
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
# Kernel launches per gradient evaluation (one forward, one backward;
# ``with_gathers`` adds the gathers' backwards).
TOY_GRAD_LAUNCHES = {"reweight_shifted": 2, "reweight_backward": 2}
LARGE_GRAD_LAUNCHES = {"reweight_shared": 2, "reweight_shifted": 1, "reweight_backward": 3}
# The experiment path (tutorial/experiment_files.py) at the toy's width.
EXP_EVENTS = 100_000
EXP_SEED = 42
EXP_ROUTES = ["generic", "generic", "shared"]
EXP_LAUNCHES = {"reweight_perchain": 2, "reweight_shared": 1}
EXP_DET_STEPS = 50  # the same fit with the deterministic histogram (K5b)
EXP_GRAD_LAUNCHES = {"reweight_perchain": 2, "reweight_shared": 1, "reweight_backward": 3}
# The production sampler: pooled Haario + Robbins-Monro MR2T2 with the JAX
# bench's adaption settings but throws from step 100 (bench.py:433-438),
# 250 warm-up steps then 1,000 timed, every chunk a replayed CUDA graph.
ADAPTIVE = dict(adaptive=True, adaption_mode="pooled", adaption_start_update=50,
                adaption_start_throw=100, adaption_update_step=100)
ADAPTIVE_WARM = 250
ADAPTIVE_STEPS = 1000
# Acceptance of the adaptive run's last chunk (steps 1,001-1,250). The JAX
# package's MR2T2 with this configuration on the CPU (XLA route, the toy at
# 100k events, 32 chains, the same jittered start) accepted 0.1944, 0.2146,
# 0.2214 and 0.2219 in its four chunks after the warm-up; Robbins-Monro
# steers towards 0.234. The band is the last of those ± 0.1, far above the
# fixed proposal's 1e-4 floor.
ACC_BAND = (0.12, 0.32)
# Eager runs beside each graph run: the same sampler, fewer steps.
EAGER_STEPS = 250
LARGE_EAGER_STEPS = 20
VARIANT_STEPS = 250  # [toy:per-chain], [toy:delayed]
VARIANT_EAGER = 50
# [toy:graph-vs-eager]: 100 steps from one saved state (step 250; the
# refresh at step 300 falls inside) as a graph and as the eager loop, with
# Robbins-Monro held (its scale reads the mean acceptance probability, which
# carries K1's atomic order into every later proposal's last bits). A chain
# may decide differently where its acceptance probabilities in the two runs
# straddle its uniform: each such chain first where the two log α differ by
# no more than GVE_NLL (K1's atomic order moves an NLL of the toy by
# ~1e-5), however many; a pooled refresh after a divergence moves every
# later throw, so the comparison ends there (graph_vs_eager). Elsewhere
# (the shadowed and the sharded comparisons) at most GVE_MAX_FLIPPED of the
# chains (or chain-steps) may decide differently.
GVE_STEPS = 100
GVE_MAX_FLIPPED = 0.01
GVE_NLL = 1e-3
# [toy:graph-vs-eager:rm]: the production configuration, Robbins-Monro on,
# GVE_STEPS steps of a graph, each shadowed by one eager step from the
# graph's state before it. The two start each step alike, so their
# log-scales differ by γ_t times the difference of the acceptance
# probabilities they averaged (pooled) or read (per chain), and by
# rounding: at most GVE_RM_ROUND beyond that. A γ read from a stale step
# under capture would miss by ~1e-5 a step.
GVE_RM_ROUND = 1e-14
# Every sampler run ends with its state's NLLs held against the model's
# NLL of its θ evaluated anew, eagerly: within GVE_NLL (the atomics' order).
# [exp:cli]: mach3-mcmc-torch on the YAML experiment, 2 chunks then a resume
# for a third.
EXP_CLI_CHAINS = 256
EXP_CLI_CHUNK = 250
# Host-side calls that put work on the device, counted as launches.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
# H100 SXM peaks (NVIDIA's data sheet): device memory and f32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# ChEES gates on the timed steps: mean acceptance inside (0.3, 0.99) (the
# large fixture's and the toy's runs).
CHEES_ACC = (0.3, 0.99)
# The toy fit ends at the Asimov minimum, χ² = 0 at the prefit point: on an
# H100 (700 W) 13 starts (0.5 and 1 prior widths) ended at χ² 4.7e-8 to
# 5.8e-7 with every free parameter within 5.6e-4 of its error of the truth.
MIN_CHI2 = 1e-4
MIN_PULL = 1e-2

# The 700-parameter envelope (tutorial/large.py build_large700) at its
# defaults: seed 2077, 2 x numu at 180k, 2 x nue at 60k, 3 x atmo at 180k
# events, 655 splines, 700 parameters, bf16 tables; 128 chains. Its
# total_nll_batch is the JAX bench's large700 measure (bench.py:700-716: 32
# chains), here at 32 and 128. The adaptive run takes the settings of the
# JAX bench's reference-scale adaptive run (bench.py:725-733).
L7_CHAINS = 128
L7_NLL_CHAINS = (32, 128)
L7_NLL_ITERS = 10
L7_ROUTES = ["shared", "shifted", "shared", "shifted", "shared", "shared", "shared"]
L7_LAUNCHES = {"reweight_shared": 5, "reweight_shifted": 2, "osc_layered": 1}
L7_ADAPTIVE = dict(adaptive=True, adaption_mode="pooled", adaption_start_update=30,
                   adaption_start_throw=150, adaption_update_step=50)
L7_CHUNK = 100
L7_WARM = 200
L7_STEPS = 500
L7_EAGER_STEPS = 30
# One gradient evaluation at 16 chains: 5 shared and 2 shifted forward
# launches, one backward launch per sample.
L7_GRAD_CHAINS = 16
L7_GRAD_LAUNCHES = {"reweight_shared": 5, "reweight_shifted": 2, "reweight_backward": 7}
L7_ROUND_TRIP_CHAINS = 4


# The remaining fitters. The octant toy at the README's width
# (build_octant_toy's defaults: seed 77, energy grid 56, 1,300 km, 2.85
# g/cm³), run as the JAX package's octant tests run it
# (tests/test_tempering.py:190-221): 64 walkers, 3,000 steps in chunks of
# 500, burn-in 1,000, half the walkers started per octant; adaptive MR2T2
# against PT with 6 levels up to T = 32, then a β = 0 ladder of 8 levels up
# to T = 64 over 2,500 steps for the NH-vs-IH evidence.
OCT_EVENTS = 50_000
OCT_WALKERS = 64
OCT_STEPS = 3000
OCT_CHUNK = 500
OCT_BURN = 1000
OCT_MR2T2 = dict(adaptive=True, adaption_mode="pooled", adaption_start_update=50,
                 adaption_start_throw=300, adaption_update_step=100)
OCT_PT = dict(n_temps=6, max_temp=32.0)
OCT_EVIDENCE = dict(n_temps=8, max_temp=64.0, beta_zero=True)
OCT_EVIDENCE_STEPS = 2500
# The gates. At 50,000 events the mirror octant holds almost no posterior
# mass: profiled over the other parameters (run_minimizer with sin²θ23 and
# the energy scale held, the plain route on the CPU) its -logL lies 8.5
# above the truth's at sin²θ23 = 0.57 and 11.0 at 0.555, against 1.1 and
# 1.7 at the JAX test's 4,000 events; a CPU run of 16 walkers x 1,500 steps
# there gave PT 4 crossings and an upper-octant occupancy of 0.00025,
# MR2T2 1 and 0.47. So at 50,000 events the gate is that PT's cold level
# leaves the mirror octant where MR2T2's walkers stay: upper-octant
# occupancy below OCT_LEFT for PT and above it for MR2T2. The JAX test's
# gates (PT crossings > 4 x max(MR2T2's, 1), occupancy in (0.1, 0.6)) are
# held at its own width, 4,000 events (seed 7, energy grid 48), where the
# mirror octant holds real mass.
OCT_LEFT = 0.25
# The hot levels wander to NLLs of thousands (the wrong-ordering model at β
# near 0), where the atomics' order moves an NLL by more than GVE_NLL: the
# octant runs' state NLLs are held within GVE_NLL + PT_NLL_RTOL x |NLL|
# (the kernels' histogram tolerance, K_RTOL).
PT_NLL_RTOL = K_RTOL
OCT_JAX_EVENTS = 4000
OCT_JAX_OCCUPANCY = (0.1, 0.6)
# The JAX bench's parallel_tempering section (bench.py:839-869) on the toy:
# 6 levels x 64 walkers up to T = 32, chunks of 50, 100 warm-up steps and
# 300 timed; the eager loop beside it for 50. Graph against eager: at most
# PT_GVE_WALKERS walker columns deciding differently (K1's atomic order);
# PT_GVE_SHADOW graph steps shadowed by eager ones with Robbins-Monro on.
TOY_PT = dict(n_temps=6, max_temp=32.0, chunk_size=50)
TOY_PT_WALKERS = 64
TOY_PT_WARM = 100
TOY_PT_STEPS = 300
TOY_PT_EAGER = 50
PT_GVE_WALKERS = 2
PT_GVE_SHADOW = 50
# The stretch-move ensemble on the toy: 256 walkers (halves of 128), chunks
# of 100, 300 timed steps after a warm chunk, 50 eager; ENS_SHADOW graph
# steps shadowed by eager ones, at most ENS_FLIPS walkers a step deciding
# differently.
ENS_WALKERS = 256
ENS_CHUNK = 100
ENS_STEPS = 300
ENS_EAGER = 50
ENS_SHADOW = 50
ENS_FLIPS = 2
# PSO on the toy (the JAX package's defaults, fitters/pso.py).
PSO_CFG = dict(n_particles=64, n_iterations=500, chunk_size=100)
# Scans: the JAX package's 41 points per parameter (fitters/scans.py), a
# 31 x 31 grid on (sin²θ23, Δm²31), SCAN_PLAIN scan points of the large
# fixture held against the plain route.
SCAN_POINTS = 41
SCAN2D_POINTS = 31
SCAN_PLAIN = 256
# [exp:cli-pt]: mach3-mcmc-torch, PT with a β = 0 ladder, 8 levels x 32
# walkers (256 chains, the experiment's MR2T2 width), 2 chunks of 100 then
# a resume for a third.
EXP_PT_TEMPS = 8
EXP_PT_WALKERS = 32
EXP_PT_CHUNK = 100
# The analysis path: the posterior predictive with PRED_TOYS toys drawn
# (burn-in PRED_BURN) from [toy:adaptive]'s and [large700:adaptive]'s
# graph runs. Calibration as the JAX tests hold it (tests/test_aux.py:
# 212-305): on the Asimov data every per-bin p-value inside PRED_BIN_BAND;
# with the data x PRED_BAD_SCALE the p-value below PRED_P_BAD and every
# per-bin p-value below PRED_BIN_BAND[0]. The toy's p-value on its Asimov
# data is not gated near 0.5: its Barlow-Beeston statistic is dominated by
# the MC's own statistical error (Σw² ≫ Σw a bin), so a draw's Poisson
# fluctuation moves the -logL by ~1 while the posterior's spread moves the
# data's by ~3 (p = 0.058-0.062 from 64 chains x 1,000 adaptive steps on
# the CPU; the JAX package's function gives the same on the same draws).
PRED_TOYS = 2000
PRED_BURN = 0.2
PRED_SEED = 11
PRED_BIN_BAND = (0.15, 0.85)
PRED_BAD_SCALE = 1.5
PRED_P_BAD = 0.1
L7_PRED_CHECK = 128
# [large700:ess]: the adaptive run's ESS, Geweke and batched means on the
# card against numpy f64 (ESS_RTOL); an AR(1) chain at the envelope's size
# (AR1_STEPS x L7_CHAINS x 700, f64) whose mean τ over its series must lie
# within AR1_TAU_RTOL of (1 + φ) / (1 − φ) (the Sokal window's bias at φ =
# 0.9 and 10,000 steps: -0.2%, CPU).
ESS_RTOL = 1e-9
AR1_STEPS = 10_000
AR1_PHI = 0.9
AR1_TAU_RTOL = 0.01
# [toy:post-cli]: the second chain file's run, and the predictive CLI's toys.
CLI_SECOND_STEPS = 500
CLI_PRED_TOYS = 500
#: The npz keys the JAX package's CLIs write (mach3_tpu/cli/diag.py,
#: process.py with the default --credible, predictive.py and its per-sample
#: prefixes).
DIAG_KEYS = {"names", "ess", "geweke", "split_rhat", "folded_rhat", "batched_means_ratio",
             "autocorrelation"}
PROCESS_KEYS = {"summary", "names", "covariance", "correlation", "ci_6827", "ci_9545"}
PRED_KEYS = {"llh_data", "llh_draw", "llh_fluctpred_vs_draw", "llh_data_vs_fluctdraw",
             "llh_fluctdata_vs_draw", "llh_fluctdraw_vs_pred", "p_value", "p_value_per_sample",
             "p_value_fluct_pred", "p_value_fluct_data", "p_value_rate"}
PRED_SAMPLE_KEYS = ("spectra_", "band_", "violin_", "p_per_bin_", "data_", "by_mode_")

# The sharded fit (mach3_tpu_torch/distributed). [toy:dist-1x1]: one NCCL
# rank, a 1 x 1 mesh, the toy at full width (N_EVENTS x N_CHAINS): the
# sharded NLL against total_nll_batch under nll_vs_plain's tolerance; the
# sharded pooled adaptive MR2T2 as graphs with its all-reduces captured
# against the unsharded one from one state and seed over DIST_GVE_STEPS
# steps, Robbins-Monro held (GVE_MAX_FLIPPED of the chains may decide
# differently); then both timed as the
# production sampler (ADAPTIVE, ADAPTIVE_WARM + ADAPTIVE_STEPS) and profiled.
DIST_SEED = 9
DIST_GVE_STEPS = 300  # refreshes at steps 100, 200 and 300
# [large:dist-2proc]: two processes share the card on gloo (NCCL refuses two
# ranks on one device), the large fixture at full size and LARGE_CHAINS:
# a 1 x 2 mesh (each rank K2 and K3 on half of every sample's events),
# DIST_LARGE_STEPS eager steps, throwing from the prior covariance at the
# Haario scale (DIST_LARGE_ADAPTIVE: no moment update within the run), whose
# acceptance must reach DIST_ACC_MIN so that the state-vs-anew check sees
# accepted moves (the default throw accepts ~0.001 here); then a 2 x 1 mesh,
# pooled adaptive over DIST_FILE_STEPS steps, one chain file per row, merged,
# R-hat.
DIST_LARGE_STEPS = 20
DIST_LARGE_ADAPTIVE = dict(adaptive=True, adaption_mode="pooled")
DIST_ACC_MIN = 0.05
DIST_FILE_STEPS = 30
DIST_FILE_ADAPTIVE = dict(adaptive=True, adaption_mode="pooled", adaption_start_update=1,
                          adaption_start_throw=10, adaption_update_step=10)
DIST_TIMEOUT = 600  # seconds for the two ranks together
# A graphed step's roofline (diagnostics/roofline.py at the H100 SXM's
# peaks): the memory floor over the measured step must lie in (0,
# ROOFLINE_MAX]; above 1 the count is wrong, not the card fast.
ROOFLINE_MAX = 1.05

#: Polygon bins over (e_reco, cos_theta): six e_reco columns, each cut in two
#: by a slanted edge the next column's polygons share at its ends.
POLY_COLUMNS = (0.0, 0.4, 0.8, 1.2, 1.8, 2.4, 3.0)
POLY_CUTS = (0.2, -0.3, 0.4, -0.1, 0.3, -0.2, 0.1)


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
           "K4a": "reweight_shared", "K4b": "reweight_shared", "K5": "reweight_shifted",
           "K5b": "reweight_shifted", "K6a": "reweight_backward", "K6b": "reweight_backward"}
NAMES = {"K4a": "reweight_shared (trivial plan, P <= 16)",
         "K4b": "reweight_shared (trivial plan)", "K5": "reweight_perchain (bin map)",
         "K5b": "reweight_perchain_det (bin map)",
         "K6a": "reweight_backward (K6a and K6b fused: both rows share its launches and time)",
         "K6b": "reweight_backward (K6a and K6b fused: both rows share its launches and time)"}


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


def peak_rss_gib() -> float:
    """The process's peak resident host memory so far, GiB (Linux)."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


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


def bin_source_bytes(bins) -> int:
    """Bytes a kernel must read of its per-chain bin source: a bin map's
    tensors, of its kinematics only the rows of its shifted axes (it forms
    the [C, E] bins itself); or the bins given."""
    from mach3_tpu_torch.splines.reweight import PerchainBins

    if not isinstance(bins, PerchainBins):
        return _nbytes(bins)
    rows = len(bins.axes) * bins.kin.shape[1] * bins.kin.element_size()
    return rows + _nbytes(*(v for k, v in bins.tensors().items() if k != "kin"))


def forward_bound(args, kwargs) -> dict:
    """Bound of one forward reweight-histogram call from its arguments
    (any of the three kernels): every tensor argument read once (a bin map
    by ``bin_source_bytes``), the table by ``coefficient_reads``, the two
    [C, B] outputs written once; 7 f32 operations per evaluated (chain,
    event, parameter) (a Horner step and the product), 3 per (chain, event)
    (w² and the two sums) and 2 per (chain, matched norm) (one multiply-add).
    ``responses`` is the number of (chain, event, parameter) responses that
    are not the identity: what the call must evaluate, whatever plan it runs
    under."""
    import torch

    from mach3_tpu_torch.splines.reweight import PerchainBins

    seg, coeffs, base_w = args[0], args[2], args[3]
    c, e = base_w.shape
    coef, pairs = coefficient_reads(seg, coeffs)
    others = [a for i, a in enumerate(args) if i != 2] + list(kwargs.values())
    maps = sum(bin_source_bytes(a) for a in others if isinstance(a, PerchainBins))
    norm_s = kwargs.get("norm_s")
    matches = 0 if norm_s is None else int(torch.count_nonzero(norm_s))
    return dict(bound(_nbytes(*others) + maps + coef + 2 * c * kwargs["n_bins"] * 4,
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
    from mach3_tpu_torch.kernels.launch import LAUNCHES

    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


#: Kernels that run once a gradient evaluation's backward, and the layered
#: grids that a gradient evaluation's forward takes by the plain path.
BACKWARD_KERNELS = ("reweight_backward", "gather_backward", "gather_backward_fallback",
                    "osc_layered_fallback")


def layered_grids_of(model) -> int:
    """The distinct layered (atmospheric) grids one evaluation of ``model``
    computes (``FitModel._shared_osc_tables``): one launch of the layered
    kernel each on a forward-only evaluation, one ``osc_layered_fallback``
    each on a gradient evaluation."""
    from mach3_tpu_torch.samples.sample import AtmoOscConfig

    return len({g for g, s in zip(model.osc_groups, model.samples)
                if g >= 0 and isinstance(s.osc, AtmoOscConfig)})


def with_gathers(model, per_eval: dict) -> dict:
    """``per_eval`` with the gathers' backwards of one gradient evaluation of
    ``model`` (``samples/gather.py``): a sample's norm product and, with
    oscillation, its flat gather, each the kernel or, for a table too wide
    for its blocks (an atmospheric one), ``index_add``; and its layered
    grids, each by the plain path (``osc_layered_fallback``)."""
    from mach3_tpu_torch.samples.gather import kernel_blocking
    from mach3_tpu_torch.samples.sample import AtmoOscConfig

    out = dict(per_eval, gather_backward=0, gather_backward_fallback=0,
               osc_layered_fallback=layered_grids_of(model))
    for s in model.samples:
        n_norm = (model.n_params if s.norm_applied is None else s.norm_applied.numel()) + 1
        takes = [kernel_blocking(n_norm, True)]
        if s.osc is not None:
            n_osc = s.osc.chan_alpha.numel() * s.osc.e_grid.numel()
            if isinstance(s.osc, AtmoOscConfig):
                n_osc *= s.osc.layer_lengths.shape[-2]  # zeniths
            takes.append(kernel_blocking(n_osc, False))
        for kernel in takes:
            out["gather_backward" if kernel else "gather_backward_fallback"] += 1
    return out


def run_sampler(tag: str, mode: str, fitter, warm: int, steps: int, launches_per_step: dict,
                smi: str, acc_band: tuple | None = None, collect: bool = False) -> dict:
    """``warm`` untimed steps (they build the kernels and, for a graph,
    capture the step), then ``steps`` timed ones whose kernel launches must
    be ``launches_per_step`` x steps, whose NLLs must be finite and whose
    last chunk's acceptance must lie inside ``acc_band`` when given.
    Returns dict(step_ms, launches, acc, acc_last, peak_gib) and, with
    ``collect``, the timed steps' draws (host arrays, copied once a chunk)."""
    import numpy as np
    import torch

    from mach3_tpu_torch.kernels.launch import LAUNCHES

    n_chains, chunk = fitter.state.theta.shape[0], fitter.config.chunk_size
    if warm:
        fitter.run(n_steps=warm, collect=False)
    torch.cuda.synchronize()
    acc0 = fitter.state.n_accepted.clone()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    head = max(steps - chunk, 0)
    parts = []
    t0 = time.perf_counter()
    if head:
        parts.append(fitter.run(n_steps=head, collect=collect))
    acc_mid = fitter.state.n_accepted.clone()
    parts.append(fitter.run(n_steps=steps - head, collect=collect))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    check_launches(f"{tag} {mode} ({steps} steps)", launches,
                   {k: v * steps for k, v in launches_per_step.items()})
    d_nll = nll_recheck(f"{tag} {mode}", fitter)
    acc = float((fitter.state.n_accepted - acc0).sum()) / (n_chains * steps)
    acc_last = float((fitter.state.n_accepted - acc_mid).sum()) / (n_chains * (steps - head))
    if acc_band is not None and not acc_band[0] < acc_last < acc_band[1]:
        raise AssertionError(f"{tag} {mode}: last-chunk acceptance {acc_last:.5f} outside "
                             f"{acc_band}")
    step_ms = 1e3 * dt / steps
    peak = torch.cuda.max_memory_allocated() / 2**30
    phase(f"[{tag}:{mode}] {steps} steps x {n_chains} chains in {dt:.3f} s: "
          f"{n_chains * steps / dt:.1f} chain-steps/s ({step_ms:.3f} ms/step), acceptance "
          f"{acc:.5f} (last chunk {acc_last:.5f}), kernel launches {launches}, state NLL vs "
          f"its θ anew within {d_nll:.3e}, peak mem {peak:.2f} GiB | {smi}")
    out = dict(step_ms=step_ms, launches=launches, acc=acc, acc_last=acc_last, peak_gib=peak)
    if collect:
        out["draws"] = {k: np.concatenate([p[k] for p in parts]) for k in parts[-1]}
    return out


def nll_recheck(tag: str, fitter, rtol: float = 0.0) -> float:
    """The sampler state's NLLs (parallel tempering's prior + sample parts),
    finite and within GVE_NLL (+ ``rtol`` x the NLL) of its model's NLL of
    the state's θ evaluated anew, eagerly: a graph that wrote a stale or
    wrong NLL fails here. Returns the largest difference."""
    import torch

    from mach3_tpu_torch.kernels.launch import LAUNCHES

    st = fitter.state
    nll = st.nll if hasattr(st, "nll") else st.prior_nll + st.sample_nll  # parallel tempering
    if not bool(torch.isfinite(nll).all()):
        raise AssertionError(f"{tag}: non-finite chain NLL")
    counted = dict(LAUNCHES)
    with torch.no_grad():
        anew = fitter.model.total_nll_batch(fitter.state.theta)
    LAUNCHES.clear()  # a check's launches are not the path's
    LAUNCHES.update(counted)
    gap = (nll - anew).abs()
    d = float(gap.max())
    if not bool((gap <= GVE_NLL + rtol * anew.abs()).all()):
        raise AssertionError(f"{tag}: the state's NLL is {d:.3e} from its θ's NLL evaluated "
                             f"anew (> {GVE_NLL} + {rtol} x |NLL|, |NLL| up to "
                             f"{float(anew.abs().max()):.3e})")
    return d


def run_mr2t2(tag: str, model, thetas, warm: int, steps: int, chunk: int,
              launches_per_step: dict, smi: str, acc_min: float | None, eager_steps: int,
              names: list, op_table: bool = False):
    """Fixed-proposal MR2T2 as replayed CUDA graphs (the default on the
    card): a warm chunk, then ``steps`` timed steps (``run_sampler``; the
    acceptance inside (acc_min, 0.99) unless acc_min is None) and their
    profile; then the same sampler as the eager loop for ``eager_steps``
    and its profile (with ``op_table`` the ten largest device ops). Returns
    (the graph fitter, its ms/step, its launch counts)."""
    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig

    init = thetas.cpu().numpy()
    band = None if acc_min is None else (acc_min, 0.99)
    fitter = MR2T2(model, MCMCConfig(chunk_size=chunk), init, seed=1)
    g = run_sampler(tag, "graph", fitter, warm, steps, launches_per_step, smi, band)
    profile_steps(tag, "graph", fitter, g["step_ms"], names, smi)
    eager = MR2T2(model, MCMCConfig(chunk_size=chunk), init, seed=1, graph=False)
    e = run_sampler(tag, "eager", eager, min(warm, 10), eager_steps, launches_per_step, smi)
    profile_steps(tag, "eager", eager, e["step_ms"], names, smi, op_table=op_table)
    phase(f"[{tag}:graph-speedup] {e['step_ms'] / g['step_ms']:.2f}x: eager {e['step_ms']:.3f} "
          f"-> graph {g['step_ms']:.3f} ms/step | {smi}")
    del eager
    return fitter, g["step_ms"], g["launches"]


def profile_steps(tag: str, mode: str, fitter, step_ms: float, names, smi: str,
                  op_table: bool = False, steps: int = 10, per_eval: bool = False) -> dict:
    """Host launches (kernel, graph, copy and fill calls), reads to the host
    (``aten::_local_scalar_dense``: a run reads its step counter once),
    device ops, device busy time and each kernel's share over ``steps``
    steps, per step, or with ``per_eval`` per gradient evaluation of an HMC
    fitter (``step_ms`` then ms per evaluation); with ``op_table`` first the
    ten largest device ops by total time. Returns dict(launches, reads, ops,
    busy) per unit, ``per`` (the units profiled), ``steps`` and ``by_name``
    {name: (device ops, ms) per unit} of the device ops whose name holds
    each of ``names`` (lower case)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    evals0 = fitter.n_grad_evals if per_eval else 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fitter.run(n_steps=steps, collect=False)
        torch.cuda.synchronize()
    per = fitter.n_grad_evals - evals0 if per_eval else steps
    unit = "evaluation" if per_eval else "step"
    events = prof.key_averages()
    dev_ops = [e for e in events if e.device_type == DeviceType.CUDA]
    launches = sum(e.count for e in events if e.key in LAUNCH_CALLS) / per
    reads = sum(e.count for e in events if e.key == "aten::_local_scalar_dense") / per
    busy = sum(e.self_device_time_total for e in dev_ops) / per / 1e3
    ops = sum(e.count for e in dev_ops) / per
    if op_table:
        for rank, e in enumerate(sorted(dev_ops, key=lambda e: -e.self_device_time_total)[:10]):
            phase(f"[{tag}:profile-op] {rank + 1:2d} {e.count / per:7.1f}/{unit} "
                  f"{e.self_device_time_total / per / 1e3:8.4f} ms/{unit} {e.key[:110]}")
    by_name = {n: (sum(e.count for e in dev_ops if n in e.key.lower()) / per,
                   sum(e.self_device_time_total for e in dev_ops if n in e.key.lower())
                   / per / 1e3)
               for n in names}
    shares = ", ".join(f"{n} {ms:.3f}" for n, (_, ms) in by_name.items())
    top = sorted(dev_ops, key=lambda e: -e.self_device_time_total)[:5]
    window = f" ({steps} steps, {per} gradient evaluations)" if per_eval else ""
    phase(f"[{tag}:profile-{mode}]{window} {launches:.1f} host launches/{unit}, {reads:.2f} "
          f"reads to the host/{unit}, {ops:.0f} device ops/{unit}, device busy {busy:.3f} "
          f"ms/{unit} ({shares} ms/{unit}) against {step_ms:.3f} ms/{unit} unprofiled: device "
          f"idle share {1.0 - busy / step_ms:.3f}; top: "
          + "; ".join(f"{e.key[:40]} {e.self_device_time_total / per / 1e3:.3f}" for e in top)
          + f" | {smi}")
    return dict(launches=launches, reads=reads, ops=ops, busy=busy, per=per, steps=steps,
                by_name=by_name)


def snapshot(state):
    """A copy of a sampler's state that no run touches: every tensor cloned,
    the generator's state copied into a new generator, a nested state (the
    adaptive moments) copied alike."""
    import dataclasses

    import torch

    def copy(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, torch.Generator):
            gen = torch.Generator(device=v.device)
            gen.set_state(v.get_state())
            return gen
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{f.name: copy(getattr(v, f.name))
                                             for f in dataclasses.fields(v)})
        return v

    return copy(state)


def steps_compared(flips, refreshes: list, step0: int, pooled: bool) -> int:
    """Rows of a graph-vs-eager run's decisions ``flips`` [S, C] (row j:
    step step0 + j + 1) that are compared: all of them, or in pooled mode,
    once a chain has decided differently, those up to and including the
    first refresh step at or after that row (the refresh pools the diverged
    θ into every chain's later throws)."""
    import numpy as np

    if pooled and flips.any():
        first = int(np.flatnonzero(flips.any(1))[0])
        later = [r for r in refreshes if r - step0 - 1 >= first]
        if later:
            return later[0] - step0
    return flips.shape[0]


def graph_vs_eager(tag: str, model, cfg, saved, smi: str) -> None:
    """``GVE_STEPS`` steps from the state ``saved`` as a graph and as the
    eager loop, Robbins-Monro held: the generators end in the same state (a
    replay draws what the eager step draws); every chain that decides
    differently does so first where its two log α differ by at most GVE_NLL
    (a near-tie that K1's atomic order can turn), whatever their number;
    θ of every other chain is bit-identical. A divergence stays in its chain
    until the next refresh of the throw matrix, which in pooled mode reads
    every chain's moments and so moves every later throw: there the
    comparison stops at the first refresh at or after the first divergence
    (per chain it runs to the end). Where no chain decided differently, the
    moments and the throw matrix are bit-identical."""
    import dataclasses

    import numpy as np
    import torch

    from mach3_tpu_torch.fitters.mcmc import MR2T2, refresh_due

    held = dataclasses.replace(cfg, robbins_monro=False)
    step0 = int(saved.step)
    refreshes = [s for s in range(step0 + 1, step0 + GVE_STEPS + 1) if refresh_due(held, s)]
    if not refreshes:
        raise AssertionError(f"{tag}: no refresh step inside the window")
    runs = {}
    for graph in (True, False):
        fit = MR2T2(model, held, saved.theta.cpu().numpy(), seed=0, graph=graph)
        fit.state = snapshot(saved)
        t0 = time.perf_counter()
        out = fit.run(n_steps=GVE_STEPS)
        torch.cuda.synchronize()
        runs[graph] = (fit, out, time.perf_counter() - t0)
    (fg, g, tg), (fe, e, te) = runs[True], runs[False]
    same_draws = torch.equal(fg.state.generator.get_state(), fe.state.generator.get_state())
    if not same_draws:
        raise AssertionError(f"{tag}: the generators' states differ after the runs")
    flips = g["accepted"] != e["accepted"]
    compared = steps_compared(flips, refreshes, step0, pooled=not saved.adaptive.per_chain)
    diverged = flips[:compared].any(0)
    n_chains = diverged.shape[0]
    gaps = []
    for c in np.flatnonzero(diverged):
        s = np.flatnonzero(flips[:compared, c])[0]
        gaps.append(abs(np.log(g["acc_prob"][s, c]) - np.log(e["acc_prob"][s, c])))
    if gaps and max(gaps) > GVE_NLL:
        raise AssertionError(f"{tag}: a decision differs where the log α differ by "
                             f"{max(gaps):.3e} > {GVE_NLL} (not a near-tie)")
    if not np.array_equal(g["theta"][:compared, ~diverged], e["theta"][:compared, ~diverged]):
        raise AssertionError(f"{tag}: θ of chains that decided alike differ")
    moments = "not compared (a chain decided differently)"
    if not flips.any():
        for f in ("mean", "cov", "chol", "log_scale"):
            if not torch.equal(getattr(fg.state.adaptive, f), getattr(fe.state.adaptive, f)):
                raise AssertionError(f"{tag}: the adaptive {f} differs, every decision alike")
        moments = "bit-identical"
    d_nll = np.abs(g["nll"][:compared, ~diverged] - e["nll"][:compared, ~diverged]).max()
    phase(f"[{tag}] {GVE_STEPS} steps x {n_chains} chains from step {step0} "
          f"(refresh at {refreshes}): generators equal after both runs; {int(diverged.sum())} "
          f"chains decided differently over the {compared} steps compared, each first at a "
          f"near-tie (log α gaps {[f'{x:.2e}' for x in gaps]}, bound {GVE_NLL}); θ of the "
          f"other {int((~diverged).sum())} bit-identical over those steps, their NLLs "
          f"within {d_nll:.3e}; moments and throw matrix {moments}; acceptance graph "
          f"{g['accepted'].mean():.4f}, eager {e['accepted'].mean():.4f}; wall, capture "
          f"included: graph {tg:.3f} s, eager {te:.3f} s | {smi}")


def graph_step_vs_eager(tag: str, model, cfg, saved, smi: str) -> None:
    """The configuration ``cfg`` as it runs (Robbins-Monro on) from the
    state ``saved``: ``GVE_STEPS`` steps of a graph, each shadowed by one
    eager step from the graph's state before it. Each step: the generators
    end alike; at most GVE_MAX_FLIPPED of the chain-steps decide
    differently, each where the two log α differ by at most GVE_NLL; θ of
    the others is bit-identical; the log-scales differ by no more than γ_t
    times the difference of the acceptance probabilities they read, plus
    GVE_RM_ROUND; where every chain decided alike the moments and the throw
    matrix (refreshed at the window's refresh step) are bit-identical."""
    import numpy as np
    import torch

    from mach3_tpu_torch.fitters.mcmc import MR2T2, refresh_due

    if not cfg.robbins_monro:
        raise AssertionError(f"{tag}: the configuration must run Robbins-Monro")
    step0 = int(saved.step)
    refreshes = [s for s in range(step0 + 1, step0 + GVE_STEPS + 1) if refresh_due(cfg, s)]
    if not refreshes:
        raise AssertionError(f"{tag}: no refresh step inside the window")
    init = saved.theta.cpu().numpy()
    fg = MR2T2(model, cfg, init, seed=0)
    fe = MR2T2(model, cfg, init, seed=0, graph=False)
    fg.state = snapshot(saved)
    per_chain = saved.adaptive.per_chain
    n_chains = init.shape[0]
    flipped, worst_gap, worst_scale, alike_steps = 0, 0.0, 0.0, 0
    refresh_checked = False
    for _ in range(GVE_STEPS):
        fe.state = snapshot(fg.state)
        g, e = fg.run(n_steps=1), fe.run(n_steps=1)
        t = int(fg.state.step)
        if int(fe.state.step) != t:
            raise AssertionError(f"{tag}: the step counters differ at step {t}")
        if not torch.equal(fg.state.generator.get_state(), fe.state.generator.get_state()):
            raise AssertionError(f"{tag}: the generators' states differ at step {t}")
        flips = g["accepted"][0] != e["accepted"][0]
        flipped += int(flips.sum())
        if flips.any():
            gap = np.abs(np.log(g["acc_prob"][0, flips]) - np.log(e["acc_prob"][0, flips])).max()
            worst_gap = max(worst_gap, float(gap))
            if gap > GVE_NLL:
                raise AssertionError(f"{tag}: a decision differs at step {t} where the log α "
                                     f"differ by {gap:.3e} > {GVE_NLL}")
        if not np.array_equal(g["theta"][0, ~flips], e["theta"][0, ~flips]):
            raise AssertionError(f"{tag}: θ of chains that decided alike differ at step {t}")
        d_acc = np.abs(g["acc_prob"][0] - e["acc_prob"][0]) if per_chain else abs(
            g["acc_prob"][0].mean() - e["acc_prob"][0].mean())
        gamma = 2.0 / max(t, 1) ** 0.66
        d_scale = (fg.state.adaptive.log_scale - fe.state.adaptive.log_scale).abs().cpu().numpy()
        excess = float(np.max(d_scale - gamma * d_acc))
        worst_scale = max(worst_scale, float(np.max(d_scale)))
        if excess > GVE_RM_ROUND:
            raise AssertionError(f"{tag}: the log-scales differ at step {t} by "
                                 f"{float(np.max(d_scale)):.3e}, {excess:.3e} beyond γ_t x "
                                 f"the acceptance probabilities' difference")
        if not flips.any():
            alike_steps += 1
            for f in ("mean", "cov", "chol"):
                if not torch.equal(getattr(fg.state.adaptive, f), getattr(fe.state.adaptive, f)):
                    raise AssertionError(f"{tag}: the adaptive {f} differs at step {t}, every "
                                         f"decision alike")
            refresh_checked |= t in refreshes
    if flipped > GVE_MAX_FLIPPED * n_chains * GVE_STEPS:
        raise AssertionError(f"{tag}: {flipped} chain-steps decided differently")
    phase(f"[{tag}] {GVE_STEPS} graph steps x {n_chains} chains from step {step0}, Robbins-"
          f"Monro on, each shadowed by an eager step from its state (refresh at {refreshes}, "
          f"held bit for bit: {refresh_checked}): generators equal every step; {flipped} "
          f"chain-steps decided differently (largest log α gap {worst_gap:.2e}); θ of the rest "
          f"bit-identical; log-scales within {worst_scale:.3e} (γ_t x the acceptance "
          f"probabilities' difference + {GVE_RM_ROUND}); moments and throw matrix "
          f"bit-identical on {alike_steps} steps where every decision agreed | {smi}")


def toy_samplers(model, thetas, smi: str) -> dict:
    """The production sampler on the toy: ``[toy:adaptive]`` (pooled
    adaptive MR2T2 as a graph, launch, NLL and acceptance-band gates; its
    eager counterpart's figures come from ``[toy:adaptive:eager]``), then
    from its state after the warm-up ``[toy:graph-vs-eager]`` (Robbins-Monro
    held) and ``[toy:graph-vs-eager:rm]`` (on, each graph step shadowed by an
    eager one), both again per chain from a per-chain run's state after its
    warm-up, then ``[toy:per-chain]`` and ``[toy:delayed]`` (one retry: each
    kernel twice a step) as graphs beside short eager runs. Returns the
    draws of ``[toy:adaptive]``'s timed graph run."""
    import dataclasses

    from mach3_tpu_torch.fitters.delayed import DelayedConfig, DelayedMR2T2
    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig

    init = thetas.cpu().numpy()
    names = ["reweight_perchain_kernel"]
    cfg = MCMCConfig(chunk_size=CHUNK, **ADAPTIVE)
    fit = MR2T2(model, cfg, init, seed=2)
    fit.run(n_steps=ADAPTIVE_WARM, collect=False)
    saved = snapshot(fit.state)
    r = run_sampler("toy:adaptive", "graph", fit, 0, ADAPTIVE_STEPS, {"reweight_shifted": 2},
                    smi, ACC_BAND, collect=True)
    profile_steps("toy:adaptive", "graph", fit, r["step_ms"], names, smi)
    del fit
    eager = MR2T2(model, cfg, init, seed=2, graph=False)
    eager.state = snapshot(saved)
    e = run_sampler("toy:adaptive", "eager", eager, 0, EAGER_STEPS, {"reweight_shifted": 2}, smi)
    profile_steps("toy:adaptive", "eager", eager, e["step_ms"], names, smi)
    del eager
    graph_vs_eager("toy:graph-vs-eager", model, cfg, saved, smi)
    graph_step_vs_eager("toy:graph-vs-eager:rm", model, cfg, saved, smi)
    pc_cfg = dataclasses.replace(cfg, adaption_mode="per_chain")
    fit = MR2T2(model, pc_cfg, init, seed=2)
    fit.run(n_steps=ADAPTIVE_WARM, collect=False)
    pc_saved = snapshot(fit.state)
    del fit
    graph_vs_eager("toy:graph-vs-eager:per-chain", model, pc_cfg, pc_saved, smi)
    graph_step_vs_eager("toy:graph-vs-eager:rm:per-chain", model, pc_cfg, pc_saved, smi)
    variants = (
        ("toy:per-chain", MR2T2, MCMCConfig(chunk_size=CHUNK, **dict(
            ADAPTIVE, adaption_mode="per_chain")), {"reweight_shifted": 2}),
        ("toy:delayed", DelayedMR2T2, DelayedConfig(chunk_size=CHUNK, max_rejections=1,
                                                    **ADAPTIVE), {"reweight_shifted": 4}),
    )
    for tag, make, vcfg, per_step in variants:
        for graph, steps in ((True, VARIANT_STEPS), (False, VARIANT_EAGER)):
            fit = make(model, vcfg, init, seed=3, graph=graph)
            mode = "graph" if graph else "eager"
            res = run_sampler(tag, mode, fit, 10, steps, per_step, smi)
            profile_steps(tag, mode, fit, res["step_ms"], names, smi)
            del fit
    return r["draws"]


def exp_cli(dev, smi: str) -> None:
    """``mach3-mcmc-torch`` (``cli/mcmc.main``) on the YAML experiment at
    EXP_CLI_CHAINS chains x EXP_EVENTS events with pooled adaptation: two
    chunks into a temporary directory, then a resume from its checkpoint
    for a third. The chain file then holds 3 chunks, the first two as the
    first run wrote them; the resumed run's first step starts from the
    checkpoint's state (a chain that rejected it still holds the
    checkpoint's θ and NLL); the final checkpoint is at the last step."""
    import os
    import tempfile

    import numpy as np

    from mach3_tpu_torch.cli import mcmc as cli
    from mach3_tpu_torch.diagnostics.chain_io import load_chain
    from mach3_tpu_torch.tutorial.experiment_files import write_experiment

    with tempfile.TemporaryDirectory() as tmp:
        exp_yaml = str(write_experiment(tmp, n_events=EXP_EVENTS, seed=EXP_SEED))
        out = os.path.join(tmp, "chain.npz")
        overrides = [f"General:MCMC:NChains:{EXP_CLI_CHAINS}",
                     f"General:MCMC:AutoSave:{EXP_CLI_CHUNK}",
                     f"AdaptionOptions:Settings:StartUpdate:{ADAPTIVE['adaption_start_update']}",
                     f"AdaptionOptions:Settings:StartThrow:{ADAPTIVE['adaption_start_throw']}",
                     f"AdaptionOptions:Settings:UpdateStep:{ADAPTIVE['adaption_update_step']}"]
        opts = ["--device", dev.type, "--seed", "3", "--stream", "off", "-o", out]
        first, total = 2 * EXP_CLI_CHUNK, 3 * EXP_CLI_CHUNK
        t0 = time.perf_counter()
        if cli.main([exp_yaml, *overrides, f"General:MCMC:NSteps:{first}", *opts]) != 0:
            raise AssertionError("exp:cli: the first run failed")
        t1 = time.perf_counter()
        d1, meta, _ = load_chain(out)
        _, _, ck = load_chain(out + ".ckpt")
        if d1["theta"].shape != (first, EXP_CLI_CHAINS, len(meta["names"])):
            raise AssertionError(f"exp:cli: chain shape {d1['theta'].shape}")
        if int(ck["st.step"]) != first or not np.array_equal(ck["st.theta"], d1["theta"][-1]):
            raise AssertionError("exp:cli: the checkpoint is not the chain's last state")
        if cli.main([exp_yaml, *overrides, f"General:MCMC:NSteps:{total}", *opts,
                     "--checkpoint", out + ".ckpt"]) != 0:
            raise AssertionError("exp:cli: the resumed run failed")
        t2 = time.perf_counter()
        d2, _, _ = load_chain(out)
        _, _, ck2 = load_chain(out + ".ckpt")
        post_cli_files("exp:cli", out, tmp, dev, smi, jarlskog=False)
    if d2["theta"].shape[0] != total or int(ck2["st.step"]) != total:
        raise AssertionError(f"exp:cli: {d2['theta'].shape[0]} steps, checkpoint at "
                             f"{int(ck2['st.step'])}, not {total}")
    for k in ("theta", "nll", "accepted"):
        if not np.array_equal(d2[k][:first], d1[k]):
            raise AssertionError(f"exp:cli: the resumed chain file changed the first run's {k}")
    kept = ~d2["accepted"][first]
    if not (np.array_equal(d2["theta"][first][kept], ck["st.theta"][kept])
            and np.array_equal(d2["nll"][first][kept], ck["st.nll"][kept])):
        raise AssertionError("exp:cli: step 501 does not continue from the checkpoint")
    if not np.isfinite(d2["nll"]).all():
        raise AssertionError("exp:cli: non-finite NLLs in the chain")
    acc = d2["accepted"][-EXP_CLI_CHUNK:].mean()
    phase(f"[exp:cli] mach3-mcmc-torch, {EXP_CLI_CHAINS} chains x {EXP_EVENTS} events, pooled "
          f"adaptive: {first} steps in {t1 - t0:.1f} s (files, build and capture included), "
          f"resumed for {total - first} more in {t2 - t1:.1f} s; chain file {total} steps, "
          f"checkpoint at step {int(ck2['st.step'])}; step {first + 1} continues from the "
          f"checkpoint ({int(kept.sum())} chains kept its θ and NLL bit for bit); last-chunk "
          f"acceptance {acc:.4f}; mean step time of the resumed chunk "
          f"{1e3 * d2['step_time'][-1]:.3f} ms | {smi}")


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


def time_kernel(tag: str, sample, args, kwargs, smi: str,
                form: str = "") -> tuple[float, float, dict]:
    """(kernel ms, plain ms, bound) of a sample's forward kernel on these
    arguments (``form`` names them when they are not the path's)."""
    _, kern, ref, _ = kernel_of(sample)
    km, pm = time_pair(lambda: kern(*args, **kwargs), lambda: ref(*args, **kwargs))
    bnd = forward_bound(args, kwargs)
    phase(f"[{tag}:kernel-time] {sample.name}{form}: kernel {km:.4f} ms, plain {pm:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; kernel at "
          f"{bnd['bound_ms'] / km:.3f} of it), {response_rate(bnd, km)} "
          f"(C={args[3].shape[0]}, E={sample.n_events}, B={sample.n_bins}) | {smi}")
    return km, pm, bnd


def backward_args(sample, thetas, tables_i) -> tuple:
    """(the backward's arguments but the cotangents, its plan kwargs) of a
    sample's differentiable route at these chains, and the cotangents of the
    sample's statistic from its forward."""
    import torch

    from mach3_tpu_torch.splines import grad

    route = sample._diff_route()
    args, kw = sample.diff_kernel_args(thetas, tables_i)
    t, base_w, seg, coeffs = args[:4]
    fwd = {"shared": grad.fused_reweight_diff, "shifted": grad.fused_reweight_diff_shifted,
           "generic": grad.fused_reweight_diff_perchain}[route]
    if route == "shifted":
        bins = grad.ShiftedBins(args[4].contiguous(), *args[5:8], kw["shift_kind"],
                                kw["stride_j"], kw["n_axis_j"])
    else:
        bins = args[4]
    plan = dict(plan_ptr=kw["plan_ptr"], plan_idx=kw["plan_idx"])
    mc, w2 = (v.detach().requires_grad_(True) for v in fwd(*args, **kw))
    gmc, gw2 = (g.float().contiguous() for g in
                torch.autograd.grad(sample._stat_sum(mc, w2).sum(), (mc, w2)))
    return (seg, t, coeffs, base_w.detach(), bins, gmc, gw2), plan


def check_backward(what: str, b_in, n_bins: int, plan: dict) -> tuple[float, float, float]:
    """The backward kernel against its plain passes on ``b_in``: ḡ_base to
    GRAD_RTOL·P elementwise, ḡ_t to GRAD_RTOL·P of Σ_e |term|; finite.
    Returns (ḡ_base max abs error, ḡ_t max abs error, worst share of a
    tolerance)."""
    import torch

    from mach3_tpu_torch.splines import grad

    seg, t, coeffs, base_w, bins, gmc, gw2 = b_in
    n_par = coeffs.shape[0]
    got_t, got_base = grad.reweight_backward(*b_in, n_bins=n_bins, **plan)
    plain_bins = bins if isinstance(bins, torch.Tensor) else bins.bins(n_bins)
    ref_a = grad.grad_pass_a_ref(seg, t, coeffs, base_w, plain_bins, gmc, gw2, n_bins=n_bins)
    ref_t = grad.grad_pass_b_ref(seg, t, coeffs, *ref_a[1:])
    err_base, _, worst_base = compare(got_base, ref_a[0], GRAD_RTOL * n_par, K_ATOL_FRAC,
                                      f"{what} g_base")
    if not bool(got_t.isfinite().all()):
        raise AssertionError(f"{what} g_t: non-finite values")
    err_t = (got_t - ref_t).abs().double()
    scale = grad.pass_b_term_scale(seg, t, coeffs, *ref_a[1:])
    worst_t = float((err_t / (GRAD_RTOL * n_par * scale + 1e-30)).max())
    if worst_t > 1.0:
        raise AssertionError(f"{what} g_t: error {float(err_t.max()):.3e} is {worst_t:.2f}x the "
                             f"tolerance")
    return err_base, float(err_t.max()), max(worst_base, worst_t)


def backward_bound(b_in, plan: dict) -> dict:
    """The bound of one backward call: every input read once (the table by
    ``coefficient_reads``; a bin map's bins are formed, not read),
    ḡ_base [C, E] and ḡ_t [C, P] written once; the f32 operations the
    function needs, each response once: 14 per evaluated (chain, event,
    parameter) (response 6, product 1, slope 4, quotient 1, multiply-add
    into the sum 2) and 6 per (chain, event) (the cotangent gather)."""
    from mach3_tpu_torch.splines import grad

    seg, t, coeffs, base_w, bins, gmc, gw2 = b_in
    c, e = base_w.shape
    coef, pairs = coefficient_reads(seg, coeffs)
    source = bin_source_bytes(bins.bin_map() if isinstance(bins, grad.ShiftedBins) else bins)
    inputs = _nbytes(seg, t, base_w, gmc, gw2, *plan.values()) + source
    return bound(inputs + coef + 4 * c * (e + coeffs.shape[0]), c * (14 * pairs + 6 * e))


def backward_vs_plain(tag: str, model, thetas, tables, smi: str) -> dict:
    """The backward kernel (K6a and K6b fused) against its plain passes on
    each sample's inputs at these chains: the forward's arguments of the
    differentiable route and the cotangents of the sample's statistic; its
    ḡ_t and ḡ_base bit-identical over two launches. Returns {sample name:
    (ḡ_base err, ḡ_t err, ms, plain ms, bound)}."""
    import torch

    from mach3_tpu_torch.splines import grad

    out = {}
    for i, s in enumerate(model.samples):
        b_in, plan = backward_args(s, thetas, tables[i])
        err_base, err_t, worst = check_backward(f"{s.name} backward", b_in, s.n_bins, plan)
        first = grad.reweight_backward(*b_in, n_bins=s.n_bins, **plan)
        again = grad.reweight_backward(*b_in, n_bins=s.n_bins, **plan)
        if not all(torch.equal(x, y) for x, y in zip(first, again)):
            raise AssertionError(f"{s.name} backward: two launches differ")
        ms = time_pair(lambda: grad.reweight_backward(*b_in, n_bins=s.n_bins, **plan),
                       lambda: grad.reweight_backward_ref(*b_in, n_bins=s.n_bins, **plan))
        bnd = backward_bound(b_in, plan)
        out[s.name] = (err_base, err_t) + ms + (bnd,)
        form = {"shared": "shared bins, plan", "shifted": "shifted axis in-kernel, plan",
                "generic": ("bins given, plan" if isinstance(b_in[4], torch.Tensor)
                            else "bin map in-kernel, plan")}[s._diff_route()]
        phase(f"[{tag}:grad-kernels] {s.name} (reweight_backward, {form}): C={thetas.shape[0]} "
              f"E={s.n_events} P={b_in[2].shape[0]}; max abs err g_base {err_base:.3e}, g_t "
              f"{err_t:.3e} (worst {worst:.3f} of tol); bit-identical over two launches; "
              f"kernel {ms[0]:.4f} ms vs plain {ms[1]:.4f} ms, bound {bnd['bound_ms']:.4f} ms "
              f"({bnd['bound_by']}; kernel at {bnd['bound_ms'] / ms[0]:.3f} of it) | {smi}")
    return out


def grad_plan_vs_trivial(tag: str, sample, thetas, tables_i, smi: str) -> None:
    """The backward of a shifted-route sample under its activity plan and
    under a trivial plan (every parameter on every tile), each against the
    plain passes, and both kernel times. Comparisons, not the path's
    launches."""
    import torch

    from mach3_tpu_torch.splines import grad, plan

    b_in, real = backward_args(sample, thetas, tables_i)
    if real.get("plan_ptr") is None:
        raise AssertionError(f"{sample.name}: a shifted-route sample without an activity plan")
    dev = b_in[0].device
    ptr, idx = plan.trivial_active(sample.n_events, b_in[2].shape[0])
    trivial = dict(plan_ptr=torch.as_tensor(ptr, device=dev),
                   plan_idx=torch.as_tensor(idx, device=dev))
    worst = max(check_backward(f"{sample.name} backward {what}", b_in, sample.n_bins, kw)[2]
                for what, kw in (("plan", real), ("trivial plan", trivial)))

    def run(kw):
        return lambda: grad.reweight_backward(*b_in, n_bins=sample.n_bins, **kw)

    t = [cuda_ms(run(trivial), 10), cuda_ms(run(real), 30), cuda_ms(run(real), 30),
         cuda_ms(run(trivial), 10)]
    phase(f"[{tag}:grad-plan-vs-trivial] {sample.name} (reweight_backward): the plan lists "
          f"{int(real['plan_idx'].numel())} (tile, parameter) pairs, the trivial plan {len(idx)};"
          f" both within {worst:.3f} of tol of the plain passes; kernel under the plan "
          f"{0.5 * (t[1] + t[2]):.4f} ms, under the trivial plan {0.5 * (t[0] + t[3]):.4f} ms "
          f"| {smi}")


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

    from mach3_tpu_torch.kernels.launch import LAUNCHES

    t = thetas.detach().clone().requires_grad_(True)
    reset_launches()
    lp = model.log_posterior_batch(t)
    (g,) = torch.autograd.grad(lp.sum(), t)
    torch.cuda.synchronize()
    check_launches(f"{tag} gradient", dict(LAUNCHES), with_gathers(model, per_eval))
    lp_p = model.log_posterior_batch(t, plain=True)
    (g_p,) = torch.autograd.grad(lp_p.sum(), t)
    if not bool(torch.isfinite(g).all() and torch.isfinite(lp).all()):
        raise AssertionError(f"{tag}: non-finite log-density or gradient through the kernels")
    if not bool((g != 0).any(1).all()):
        raise AssertionError(f"{tag}: a chain's gradient through the kernels is all zero")
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


def toy_minimize(model, smi: str) -> dict:
    """L-BFGS-B (``run_minimizer``) on the toy from a 0.5 prior-sigma jitter
    (returns its χ², evaluations and wall seconds):
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
    from mach3_tpu_torch.kernels.launch import LAUNCHES

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
    # Hesse's Hessian of the plain route (which runs no reweight kernel): its
    # first backward builds a graph, so each gather takes the plain version
    # there, counted as a fallback; then a backward a parameter through that
    # graph, each through the gathers' kernel.
    per = with_gathers(model, TOY_GRAD_LAUNCHES)
    want = {k: v * n for k, v in per.items()}
    want["gather_backward"] += per["gather_backward"] * model.n_params
    want["gather_backward_fallback"] += per["gather_backward"] + per["gather_backward_fallback"]
    check_launches("toy:minimize", dict(LAUNCHES), want)
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
          f"{dict(LAUNCHES)} | {smi}")
    return dict(chi2=res.chi2, n=n, dt=dt)


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


def captured_grad(model, thetas):
    """(replay, gradient): one ``log_posterior_batch`` forward plus
    ``autograd.grad`` at ``thetas`` captured as a CUDA graph (warmed up on a
    side stream first: the lazily built kernels, their shared-memory
    attributes, autograd's stream bookkeeping), and the tensor each replay
    writes its gradient into."""
    import torch

    def grad_of(t):
        with torch.enable_grad():
            th = t.detach().requires_grad_(True)
            return torch.autograd.grad(model.log_posterior_batch(th).sum(), th)[0]

    static = thetas.detach().clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        grad_of(static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        g = grad_of(static)
    return graph.replay, g


def grad_budget(tag: str, model, thetas, smi: str) -> None:
    """The bench's ``hmc_large_grad_budget``: the sampling forward
    (``total_nll_batch``), the differentiable forward, forward + backward
    eagerly and as one captured graph's replay (held against the eager
    gradient within GRAD_E2E: the atomics' order), their ratios, and a
    profile of one eager gradient evaluation."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mach3_tpu_torch.kernels.launch import LAUNCHES

    t = thetas.detach().clone().requires_grad_(True)

    def grad_eval():
        return torch.autograd.grad(model.log_posterior_batch(t).sum(), t)

    with torch.no_grad():
        fused = timed_ms(lambda: model.total_nll_batch(thetas), BUDGET_ITERS)
        fwd = timed_ms(lambda: model.log_posterior_batch(thetas), BUDGET_ITERS)
    grad_ms = timed_ms(grad_eval, BUDGET_ITERS)
    counted = dict(LAUNCHES)
    replay, g_graph = captured_grad(model, thetas)
    captured_ms = timed_ms(replay, BUDGET_ITERS)
    LAUNCHES.update(counted)  # a timing's launches are no path's
    (g_eager,) = grad_eval()
    gap = float(((g_graph - g_eager).abs() / g_eager.abs().amax(1, keepdim=True)).max())
    if not (bool(torch.isfinite(g_graph).all()) and gap <= GRAD_E2E):
        raise AssertionError(f"{tag}:grad-budget: the captured gradient is {gap:.3e} of each "
                             f"chain's largest component from the eager one (> {GRAD_E2E})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        grad_eval()
        torch.cuda.synchronize()
    dev_ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev_ops) / 1e3

    def share(name):
        return sum(e.self_device_time_total for e in dev_ops if name in e.key) / 1e3

    top = sorted(dev_ops, key=lambda e: -e.self_device_time_total)[:5]
    phase(f"[{tag}:grad-budget] {thetas.shape[0]} chains, {BUDGET_ITERS} iterations: sampling "
          f"forward {fused:.3f} ms, differentiable forward {fwd:.3f} ms, forward + backward "
          f"{grad_ms:.3f} ms eager, {captured_ms:.3f} ms as a captured graph's replay "
          f"({grad_ms / captured_ms:.2f}x; its gradient within {gap:.3e} of the eager one's "
          f"largest component); diff forward / sampling forward {fwd / fused:.3f}, gradient / "
          f"sampling forward {grad_ms / fused:.3f} (captured {captured_ms / fused:.3f}) | {smi}")
    phase(f"[{tag}:grad-profile] one gradient evaluation: {sum(e.count for e in dev_ops)} "
          f"device ops, device busy {busy:.3f} ms (reweight_backward "
          f"{share('reweight_backward'):.3f}, reweight_shared {share('reweight_shared'):.3f}, "
          f"reweight_perchain_kernel {share('reweight_perchain_kernel'):.3f} ms) against "
          f"{grad_ms:.3f} ms eager and {captured_ms:.3f} ms captured: device idle share "
          f"{1.0 - busy / grad_ms:.3f} eager, {1.0 - busy / captured_ms:.3f} captured; top: "
          + "; ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.3f}" for e in top)
          + f" | {smi}")


def hmc_timed(tag: str, mode: str, fit, steps: int, per_eval: dict, smi: str) -> dict:
    """``steps`` timed HMC steps (draws collected, as the bench's run
    collects them): their kernel launches must be ``per_eval`` x the
    evaluations the fitter counts (forward kernels: gradient and
    forward-only evaluations; the backward kernel: gradient evaluations),
    their logp finite. Returns dict(step_ms, dt, acc, n_grad, launches,
    peak_gib, out)."""
    import numpy as np
    import torch

    from mach3_tpu_torch.kernels.launch import LAUNCHES

    n_chains = fit.state.theta.shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acc0 = fit.state.n_accepted.clone()
    n_grad0, n_logp0 = fit.n_grad_evals, fit.n_logp_evals
    reset_launches()
    t0 = time.perf_counter()
    out = fit.run(n_steps=steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    n_grad = fit.n_grad_evals - n_grad0
    n_evals = n_grad + fit.n_logp_evals - n_logp0
    want = {k: v * (n_grad if k in BACKWARD_KERNELS else n_evals)
            for k, v in with_gathers(fit.model, per_eval).items()}
    want["osc_layered"] = layered_grids_of(fit.model) * (n_evals - n_grad)  # forward-only
    check_launches(f"{tag} {mode}", launches, want)
    if not (np.isfinite(out["logp"]).all() and bool(torch.isfinite(fit.state.logp).all())):
        raise AssertionError(f"{tag} {mode}: non-finite logp")
    acc = float((fit.state.n_accepted - acc0).sum()) / (n_chains * steps)
    peak = torch.cuda.max_memory_allocated() / 2**30
    step_ms = 1e3 * dt / steps
    phase(f"[{tag}:{mode}] {steps} steps x {n_chains} chains in {dt:.3f} s: "
          f"{n_chains * steps / dt:.1f} chain-steps/s ({step_ms:.3f} ms/step), mean "
          f"{out['n_leapfrog'].mean():.2f} leapfrog steps, {n_grad} gradient evaluations "
          f"({1e3 * dt / n_grad:.3f} ms each), acceptance {acc:.4f}, kernel launches "
          f"{launches}, peak mem {peak:.2f} GiB | {smi}")
    return dict(step_ms=step_ms, dt=dt, acc=acc, n_grad=n_grad, launches=launches,
                peak_gib=peak, out=out)


def hmc_profile(tag: str, mode: str, fit, timed: dict, names, smi: str) -> dict:
    """``profile_steps`` over HMC_PROFILE_STEPS steps of an HMC fitter, per
    gradient evaluation against the timed run ``timed``'s ms per
    evaluation; adds that (``ms``), the idle share and the host launches
    and reads a step."""
    ms = 1e3 * timed["dt"] / timed["n_grad"]
    p = profile_steps(tag, mode, fit, ms, names, smi, steps=HMC_PROFILE_STEPS, per_eval=True)
    per_step = p["per"] / p["steps"]
    return dict(p, ms=ms, idle=1.0 - p["busy"] / ms, step_launches=p["launches"] * per_step,
                step_reads=p["reads"] * per_step)


def chees_gates(tag: str, fit, acc: float | None) -> tuple[float, float]:
    """The step size and trajectory time finite; with ``acc`` (the timed
    steps' acceptance) given, that inside CHEES_ACC and, the adaptation
    being over, T in [ε, max_leapfrog ε] (within the window T is clipped to
    the range of the ε before each step's update). Returns (ε, T)."""
    import torch

    st, cfg = fit.state, fit.config
    eps, traj = float(torch.exp(st.log_eps)), float(torch.exp(st.log_traj))
    if not (math.isfinite(eps) and math.isfinite(traj)):
        raise AssertionError(f"{tag}: step size {eps} / trajectory time {traj}")
    if acc is None:
        return eps, traj
    if not CHEES_ACC[0] < acc < CHEES_ACC[1]:
        raise AssertionError(f"{tag}: acceptance {acc:.4f} outside {CHEES_ACC}")
    if not (int(st.step) > cfg.adapt_steps
            and eps * (1 - 1e-9) <= traj <= cfg.max_leapfrog * eps * (1 + 1e-9)):
        raise AssertionError(f"{tag}: step size {eps} / trajectory time {traj} outside "
                             f"[eps, {cfg.max_leapfrog} eps] at step {int(st.step)}")
    return eps, traj


def hmc_step_vs_eager(tag: str, model, cfg, saved, smi: str) -> None:
    """``HMC_GVE_STEPS`` graph steps from the HMC state ``saved``, each
    shadowed by one eager step from the graph's state before it: the
    generators alike after every step, the same lengths, decisions alike
    except at near-ties (the two log α within GVE_NLL), θ of the other
    chains within HMC_GVE_THETA prior widths, log ε, log T and their
    averages within HMC_GVE_ADAPT."""
    import numpy as np
    import torch

    from mach3_tpu_torch.fitters.hmc import HMC

    init = saved.theta.cpu().numpy()
    flat = model.flat
    sig = torch.sqrt(torch.diag(flat.chol @ flat.chol.T)).cpu().numpy()
    fg = HMC(model, cfg, init, seed=0)
    fe = HMC(model, cfg, init, seed=0, graph=False)
    fg.state = snapshot(saved)
    flipped, gaps, worst_theta, worst_adapt = 0, [], 0.0, 0.0
    for _ in range(HMC_GVE_STEPS):
        fe.state = snapshot(fg.state)
        g, e = fg.run(n_steps=1), fe.run(n_steps=1)
        t = int(fg.state.step)
        if int(fe.state.step) != t:
            raise AssertionError(f"{tag}: the step counters differ at step {t}")
        if not torch.equal(fg.state.generator.get_state(), fe.state.generator.get_state()):
            raise AssertionError(f"{tag}: the generators' states differ at step {t}")
        if not np.array_equal(g["n_leapfrog"], e["n_leapfrog"]):
            raise AssertionError(f"{tag}: the trajectory lengths differ at step {t}")
        flips = g["accepted"][0] != e["accepted"][0]
        flipped += int(flips.sum())
        if flips.any():
            gap = np.abs(np.log(g["accept_prob"][0, flips])
                         - np.log(e["accept_prob"][0, flips])).max()
            gaps.append(float(gap))
            if gap > GVE_NLL:
                raise AssertionError(f"{tag}: a decision differs at step {t} where the log α "
                                     f"differ by {gap:.3e} > {GVE_NLL} (not a near-tie)")
        d_theta = float((np.abs(g["theta"][0, ~flips] - e["theta"][0, ~flips]) / sig).max(
            initial=0.0))
        worst_theta = max(worst_theta, d_theta)
        if d_theta > HMC_GVE_THETA:
            raise AssertionError(f"{tag}: θ of chains that decided alike differ by {d_theta:.3e} "
                                 f"prior widths at step {t} (> {HMC_GVE_THETA})")
        for f in ("log_eps", "log_eps_bar", "log_traj", "log_traj_bar"):
            d = abs(float(getattr(fg.state, f)) - float(getattr(fe.state, f)))
            worst_adapt = max(worst_adapt, d)
            if d > HMC_GVE_ADAPT:
                raise AssertionError(f"{tag}: {f} differs by {d:.3e} at step {t} "
                                     f"(> {HMC_GVE_ADAPT})")
    phase(f"[{tag}] {HMC_GVE_STEPS} graph steps x {init.shape[0]} chains from step "
          f"{int(saved.step)} (adaptation until {cfg.adapt_steps}), each shadowed by an eager "
          f"step from its state: generators and lengths equal every step; {flipped} "
          f"chain-steps decided differently, each at a near-tie (log α gaps "
          f"{[f'{x:.2e}' for x in gaps]}, bound {GVE_NLL}); θ of the rest within "
          f"{worst_theta:.3e} prior widths (bound {HMC_GVE_THETA}); log ε, log T and their "
          f"averages within {worst_adapt:.3e} (bound {HMC_GVE_ADAPT}) | {smi}")


def run_chees(model, thetas, smi: str) -> dict:
    """``[large:chees]``: ChEES-HMC with the bench's configuration
    (``bench.py:940-957``) as replayed CUDA graphs: warm-up and adaptation,
    timed steps (launch and acceptance gates) and their profile; the eager
    loop from the same state for CHEES_EAGER steps and its profile; then
    the shadowed graph-vs-eager check. Returns the graph run's launches."""
    import torch

    from mach3_tpu_torch.fitters.hmc import HMC, HMCConfig

    cfg = HMCConfig(**LARGE_CHEES)
    init = thetas.cpu().numpy()
    names = ["reweight_backward", "reweight_shared"]
    fit = HMC(model, cfg, init, seed=8)
    t0 = time.perf_counter()
    fit.run(n_steps=CHEES_GVE_AT, collect=False)
    gve_saved = snapshot(fit.state)
    fit.run(n_steps=CHEES_WARM - CHEES_GVE_AT, collect=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    saved = snapshot(fit.state)
    g = hmc_timed("large:chees", "graph", fit, CHEES_STEPS, LARGE_GRAD_LAUNCHES, smi)
    eps, traj = chees_gates("large:chees", fit, g["acc"])
    pg = hmc_profile("large:chees", "graph", fit, g, names, smi)
    del fit
    eager = HMC(model, cfg, init, seed=8, graph=False)
    eager.state = snapshot(saved)
    e = hmc_timed("large:chees", "eager", eager, CHEES_EAGER, LARGE_GRAD_LAUNCHES, smi)
    pe = hmc_profile("large:chees", "eager", eager, e, names, smi)
    del eager
    phase(f"[large:chees] {thetas.shape[0]} chains: {CHEES_WARM} warm-up/adaptation steps as "
          f"graphs in {warm_s:.1f} s (capture included); step size {eps:.5g}, trajectory time "
          f"{traj:.5g}; graph {g['step_ms']:.3f} ms/step, {pg['ms']:.3f} ms an evaluation "
          f"({pg['step_launches']:.1f} host launches and {pg['step_reads']:.2f} reads a step, "
          f"device busy {pg['busy']:.3f} ms an evaluation, idle share {pg['idle']:.3f}) against "
          f"eager {e['step_ms']:.3f} ms/step, {pe['ms']:.3f} ms an evaluation "
          f"({pe['step_launches']:.1f} host launches a step, busy {pe['busy']:.3f}, idle "
          f"{pe['idle']:.3f}): {pe['ms'] / pg['ms']:.2f}x an evaluation; peak "
          f"{g['peak_gib']:.2f} / {e['peak_gib']:.2f} GiB | {smi}")
    hmc_step_vs_eager("large:chees:graph-vs-eager", model, cfg, gve_saved, smi)
    return g["launches"]


def ess_report(draws, wall_s: float, dev) -> dict:
    """ESS/hour and τ_int from draws [S, C, P] as ``bench.py:245-273``
    computes them (each chain's ESS per parameter, pooled over chains;
    min and median over parameters), with the port's
    ``diagnostics/autocorr.effective_sample_size`` on the card. Where τ_int
    exceeds a fifth of the window (``window_capped``) the minimum is a
    lower bound."""
    import numpy as np

    from mach3_tpu_torch.diagnostics.autocorr import effective_sample_size

    s = draws.shape[0]
    ess = effective_sample_size(draws, device=dev).cpu().numpy()  # [C, P]
    tau = s / np.maximum(ess, 1e-9)
    tot = ess.sum(axis=0)
    hours = wall_s / 3600.0
    return {"min": float(tot.min() / hours), "median": float(np.median(tot) / hours),
            "steps_measured": int(s),
            "tau_int": {"median": float(np.median(tau)), "max": float(tau.max())},
            "window_capped": bool(tau.max() > s / 5.0)}


def toy_chees(model, dev, smi: str) -> None:
    """``[toy:chees]``: the bench's ChEES run on the toy (``bench.py:872-900``)
    as replayed CUDA graphs: TOY_CHEES_WARM warm-up/adaptation steps, then
    TOY_CHEES_STEPS timed ones (launch and acceptance gates) whose draws
    give ESS/hour; their profile."""
    import numpy as np

    import torch

    from mach3_tpu_torch.fitters.hmc import HMC, HMCConfig

    init = jitter_init(model, TOY_CHEES_CHAINS, np.random.default_rng(7))
    fit = HMC(model, HMCConfig(**TOY_CHEES), init, seed=7)
    t0 = time.perf_counter()
    fit.run(n_steps=TOY_CHEES_WARM, collect=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    r = hmc_timed("toy:chees", "graph", fit, TOY_CHEES_STEPS, TOY_GRAD_LAUNCHES, smi)
    eps, traj = chees_gates("toy:chees", fit, r["acc"])
    ess = ess_report(r["out"]["theta"], r["dt"], dev)
    if not (ess["min"] > 0 and math.isfinite(ess["median"])):
        raise AssertionError(f"toy:chees: ESS/hour {ess}")
    p = hmc_profile("toy:chees", "graph", fit, r, ["reweight_backward"], smi)
    phase(f"[toy:chees] {TOY_CHEES_CHAINS} chains x {N_EVENTS} events: {TOY_CHEES_WARM} "
          f"warm-up/adaptation steps in {warm_s:.1f} s (capture included), then "
          f"{TOY_CHEES_STEPS} as graphs: {TOY_CHEES_CHAINS * TOY_CHEES_STEPS / r['dt']:.1f} "
          f"chain-steps/s, acceptance {r['acc']:.4f} (whole run "
          f"{float(fit.acceptance_rate.mean()):.4f}), step size {eps:.6g}, trajectory time "
          f"{traj:.6g}, {p['ms']:.3f} ms a gradient evaluation (device busy {p['busy']:.3f}, "
          f"idle share {p['idle']:.3f}), {p['step_launches']:.1f} host launches and "
          f"{p['step_reads']:.2f} reads a step; "
          f"ESS/hour min {ess['min']} median {ess['median']} over {ess['steps_measured']} "
          f"steps, τ_int median {ess['tau_int']['median']} max {ess['tau_int']['max']}, "
          f"window_capped {ess['window_capped']} | {smi}")


def toy_hmc_cli(dev, smi: str) -> None:
    """``[toy:hmc-cli]``: ``mach3-mcmc-torch`` with jittered HMC on the toy
    (``General:FittingAlgorithm:HMC``), then a resume from its checkpoint:
    the chain file and the checkpoint read back, the first run's draws
    kept, the checkpoint at the last step."""
    import os
    import tempfile

    import numpy as np
    import torch

    from mach3_tpu_torch.cli import mcmc as cli
    from mach3_tpu_torch.diagnostics.chain_io import load_chain
    from mach3_tpu_torch.kernels.launch import LAUNCHES

    c = HMC_CLI
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "chain.npz")
        args = [f"Toy:NEvents:{c['events']}", "General:FittingAlgorithm:HMC",
                f"General:MCMC:NChains:{c['chains']}", f"General:MCMC:NLeapfrog:{c['leapfrog']}",
                f"General:MCMC:StepSize:{c['step_size']}", f"General:MCMC:AutoSave:{c['chunk']}"]
        opts = ["--device", dev.type, "--seed", "3", "--stream", "off", "-o", out]
        reset_launches()
        t0 = time.perf_counter()
        if cli.main([*args, f"General:MCMC:NSteps:{c['steps']}", *opts]) != 0:
            raise AssertionError("toy:hmc-cli: the first run failed")
        t1 = time.perf_counter()
        d1, meta, _ = load_chain(out)
        if cli.main([*args, f"General:MCMC:NSteps:{c['resumed']}", *opts,
                     "--checkpoint", out + ".ckpt"]) != 0:
            raise AssertionError("toy:hmc-cli: the resumed run failed")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        d2, _, _ = load_chain(out)
        _, _, ck = load_chain(out + ".ckpt")
    launches = dict(LAUNCHES)
    n_par = len(meta["names"])
    if d1["theta"].shape != (c["steps"], c["chains"], n_par) or d2["theta"].shape[0] != c[
            "resumed"] or int(ck["st.step"]) != c["resumed"]:
        raise AssertionError(f"toy:hmc-cli: chains {d1['theta'].shape} then "
                             f"{d2['theta'].shape}, checkpoint at {int(ck['st.step'])}")
    if not all(np.array_equal(d2[k][:c["steps"]], d1[k]) for k in ("theta", "logp", "accepted")):
        raise AssertionError("toy:hmc-cli: the resumed chain file changed the first run's draws")
    if not (np.isfinite(d2["logp"]).all() and np.array_equal(ck["st.theta"], d2["theta"][-1])):
        raise AssertionError("toy:hmc-cli: non-finite logp or a checkpoint off the last step")
    if not launches.get("reweight_backward") or not d2["accepted"].any():
        raise AssertionError(f"toy:hmc-cli: launches {launches}, no step accepted")
    phase(f"[toy:hmc-cli] mach3-mcmc-torch, HMC (jittered, {c['leapfrog']} leapfrog steps) "
          f"{c['chains']} chains x {c['events']} events: {c['steps']} steps in {t1 - t0:.1f} s "
          f"(build and capture included), resumed to {c['resumed']} in {t2 - t1:.1f} s; chain "
          f"file {list(d2)} read back, {d2['theta'].shape}, the first run's draws kept, the "
          f"checkpoint at step {int(ck['st.step'])}; acceptance {d2['accepted'].mean():.4f}; "
          f"kernel launches {launches} | {smi}")


def large700_grad_chees(model, thetas, smi: str) -> None:
    """``[large700:grad-budget]`` at ``thetas``' chains, then
    ``[large700:chees]``: LARGE_CHEES as replayed CUDA graphs, a short run
    (L7_CHEES_WARM then L7_CHEES_STEPS timed, launch gate; the adaptation is
    still young, so no acceptance band) with its peak memory."""
    import torch

    from mach3_tpu_torch.fitters.hmc import HMC, HMCConfig

    grad_budget("large700", model, thetas, smi)
    fit = HMC(model, HMCConfig(**LARGE_CHEES), thetas.cpu().numpy(), seed=8)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit.run(n_steps=L7_CHEES_WARM, collect=False)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    warm_peak = torch.cuda.max_memory_allocated() / 2**30
    r = hmc_timed("large700:chees", "graph", fit, L7_CHEES_STEPS, L7_GRAD_LAUNCHES, smi)
    eps, traj = chees_gates("large700:chees", fit, None)
    phase(f"[large700:chees] {thetas.shape[0]} chains: {L7_CHEES_WARM} warm-up steps in "
          f"{warm_s:.1f} s (capture included; peak {warm_peak:.2f} GiB), then "
          f"{L7_CHEES_STEPS} as graphs {r['step_ms']:.3f} ms/step, "
          f"{1e3 * r['dt'] / r['n_grad']:.3f} ms a gradient evaluation, acceptance "
          f"{r['acc']:.4f}, step size {eps:.5g}, trajectory time {traj:.5g}; peak "
          f"{r['peak_gib']:.2f} GiB | {smi}")


def toy_path(dev, smi: str, quick: bool = False) -> dict:
    import numpy as np
    import torch

    from mach3_tpu_torch.tutorial.toy import build_toy

    t0 = time.perf_counter()
    toy = build_toy(n_events=N_EVENTS, seed=SEED, e_grid_size=E_GRID, device=dev)
    model = toy.model
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
    if quick:
        backward_vs_plain("toy", model, thetas, tables, smi)
        return {}
    with torch.no_grad():
        prefit = model.prefit_vector()[None]
        pre_tables = model._shared_osc_tables(prefit)
        for i, s in enumerate(model.samples):
            mc_a, _ = s.reweight_batch(prefit, pre_tables[i])
            _, q, r = compare(mc_a[0], s.data.float(), K_RTOL, K_ATOL_FRAC, f"{s.name} asimov")
            phase(f"[toy:asimov] {s.name}: max rel err {q:.3e} ({r:.3f} of tol) | {smi}")
        nll_vs_plain("toy", model, thetas, tables, smi)

    fitter, step_ms, launches = run_mr2t2(
        "toy", model, thetas, CHUNK, CHUNK * TIMED_CHUNKS, CHUNK, {"reweight_shifted": 2}, smi,
        ACC_MIN, EAGER_STEPS, ["reweight_perchain_kernel"])
    del fitter
    roofline_line("toy:graph", model, N_CHAINS, step_ms, smi)
    dist_launches = toy_dist(model, thetas, dev, smi)
    draws = toy_samplers(model, thetas, smi)
    with torch.no_grad():
        times = [time_kernel("toy", s, *checked[s.name][:2], smi) for s in model.samples]

    grads = backward_vs_plain("toy", model, thetas, tables, smi)
    with torch.no_grad():
        diff_nll_vs_sampling("toy", model, thetas, tables, smi)
    posterior_grad_vs_plain("toy", model, thetas, TOY_GRAD_LAUNCHES, smi)
    fit_result = toy_minimize(model, smi)
    toy_chees(model, dev, smi)
    toy_hmc_cli(dev, smi)
    toy_pt(model, smi)
    toy_ensemble(model, smi)
    toy_pso(model, smi, fit_result)
    toy_scan2d(toy, smi)
    toy_llhscan_cli(dev, smi)
    pred = toy_predictive(toy, draws, smi)
    toy_post_cli(toy, draws, smi)
    return {"K1": dict(launches=launches["reweight_shifted"] + pred["reweight_shifted"]
                       + dist_launches,
                       max_abs_err=max(v[2] for v in checked.values()),
                       ms=sum(v[0] for v in times), plain_ms=sum(v[1] for v in times),
                       **summed([v[2] for v in times])),
            "grad": grads}


def large_path(dev, smi: str, quick: bool = False) -> tuple[dict, object]:
    import numpy as np
    import torch

    from mach3_tpu_torch.tutorial.large import build_large

    t0 = time.perf_counter()
    exp = build_large(seed=LARGE_SEED, low_memory=True, device=dev)
    model = exp.model
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
        {"reweight_shared": 2, "reweight_shifted": 1, "osc_layered": 1}, smi, None,
        LARGE_EAGER_STEPS,
        ["reweight_shared", "reweight_perchain_kernel"])
    roofline_line("large:graph", model, LARGE_CHAINS, step_ms, smi)
    dist_launches = large_dist(model, thetas, exp.names, dev, smi)
    times = {}
    with torch.no_grad():
        for s in model.samples:
            a, kw, _ = checked[s.name]
            times[s.name] = time_kernel("large", s, a, kw, smi)
    err = {n: v[2] for n, v in checked.items()}
    shared = [times["numu_beam"], times["atmo"]]
    results = {
        "K3": dict(launches=launches["reweight_shifted"] + dist_launches["reweight_shifted"],
                   max_abs_err=err["nue_beam"],
                   ms=times["nue_beam"][0], plain_ms=times["nue_beam"][1],
                   **times["nue_beam"][2]),
        "K2": dict(launches=launches["reweight_shared"] + dist_launches["reweight_shared"],
                   max_abs_err=max(err["numu_beam"], err["atmo"]),
                   ms=sum(v[0] for v in shared), plain_ms=sum(v[1] for v in shared),
                   **summed([v[2] for v in shared])),
        "K4b": wide,
        "osc_layered": launches["osc_layered"] + dist_launches["osc_layered"],
    }
    del fitter, checked
    large_scan(model, smi)
    return results, model


def large_grad_kernels(model, dev, smi: str) -> tuple[dict, object, tuple]:
    """The backward kernel on the large fixture at the bench's 64 chains
    against its plain passes, and nue_beam's under its plan against a
    trivial plan; returns (per-sample results, the chains, their
    oscillation tables)."""
    import numpy as np
    import torch

    thetas = torch.as_tensor(jitter_init(model, GRAD_CHAINS, np.random.default_rng(0)),
                             device=dev)
    with torch.no_grad():
        tables = model._shared_osc_tables(thetas)
    grads = backward_vs_plain("large", model, thetas, tables, smi)
    grad_plan_vs_trivial("large", model.samples[1], thetas, tables[1], smi)
    return grads, thetas, tables


def large_grad_path(model, dev, smi: str) -> tuple[dict, dict]:
    """The gradient path on the large fixture at the bench's 64 chains;
    returns (per-sample backward-kernel results, the ChEES run's launches)."""
    import torch

    grads, thetas, tables = large_grad_kernels(model, dev, smi)
    with torch.no_grad():
        diff_nll_vs_sampling("large", model, thetas, tables, smi)
    posterior_grad_vs_plain("large", model, thetas, LARGE_GRAD_LAUNCHES, smi)
    grad_budget("large", model, thetas, smi)
    launches = run_chees(model, thetas, smi)
    return grads, launches


def blockdiag_vs_plain(model, checked, smi: str) -> float:
    """K5b (``hist="blockdiag"``) against the plain version on each
    per-chain sample's arguments, within the kernels' tolerance, and twice:
    bit for bit the same (no float atomics). Returns its max abs error."""
    import torch

    from mach3_tpu_torch.splines import reweight

    errs = []
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
        errs.append(max(e1, e2))
        phase(f"[exp:blockdiag-vs-plain] {s.name} (reweight_perchain_det, bin map, plan): "
              f"max|dmc|={e1:.3e} max|dw2|={e2:.3e} max rel err {max(q1, q2):.3e} (worst "
              f"{max(r1, r2):.3f} of tol); bit-identical over two runs | {smi}")
    return max(errs)


def bins_given_vs_plain(model, thetas, checked, smi: str) -> dict:
    """The per-chain kernel with the bins given as input (the form of a
    shift that is torch code), fed ``SampleModel._perchain_bins``, on each
    generic sample's arguments: those bins equal the bin map's plain bins,
    and both histogram forms agree with the plain version and with the bin
    map's kernel, within the kernels' tolerance, K5b bit for bit twice.
    Comparisons, not the path's launches. Returns {sample name: the input
    form's arguments}."""
    import torch

    from mach3_tpu_torch.splines import reweight

    out = {}
    for s in model.samples:
        if s.kernel_route.variant != "generic":
            continue
        args, kwargs, _ = checked[s.name]
        given = s._perchain_bins(thetas).to(torch.int32).contiguous()
        if not torch.equal(given, args[4].bins(s.n_bins)):
            raise AssertionError(f"{s.name}: the bin map's plain bins differ from _perchain_bins")
        a_in = args[:4] + (given,)
        worst = 0.0
        for hist in reweight.HIST_FORMS:
            kw = dict(kwargs, hist=hist)
            got = reweight.fused_reweight_histogram(*a_in, **kw)
            ref = reweight.fused_reweight_histogram_ref(*a_in, **kw)
            by_map = reweight.fused_reweight_histogram(*args, **kw)
            if hist == "blockdiag":
                again = reweight.fused_reweight_histogram(*a_in, **kw)
                if not all(torch.equal(x, y) for x, y in zip(got, again)):
                    raise AssertionError(f"{s.name}: K5b on given bins differs between runs")
            for x, y, h in zip(got + got, ref + by_map, ("mc", "w2", "mc vs map", "w2 vs map")):
                worst = max(worst, compare(x, y, K_RTOL, K_ATOL_FRAC, f"{s.name} given {h}")[2])
        out[s.name] = a_in
        phase(f"[exp:bins-given-vs-plain] {s.name} (reweight_perchain and _det, bins given "
              f"[C, E] from _perchain_bins, equal to the bin map's plain bins): both forms vs "
              f"plain and vs the bin map's kernel within {worst:.3f} of tol; K5b bit-identical "
              f"twice | {smi}")
    return out


def exp_path(dev, smi: str) -> dict:
    """The YAML experiment path: files written into a temporary directory,
    ``build_experiment`` on the card, then the phases of the other paths,
    the deterministic histogram's run and the gradient at 64 chains."""
    import tempfile

    import numpy as np
    import torch

    from mach3_tpu_torch.core.config import Config
    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
    from mach3_tpu_torch.samples.experiment import build_experiment
    from mach3_tpu_torch.kernels.launch import LAUNCHES
    from mach3_tpu_torch.tutorial.experiment_files import write_experiment

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        exp_yaml = write_experiment(tmp, n_events=EXP_EVENTS, seed=EXP_SEED)
        written_s = time.perf_counter() - t0
        model = build_experiment(Config.from_file(str(exp_yaml)), device=dev).model
        built_s = time.perf_counter() - t0 - written_s
        exp_io(model, exp_yaml, dev, smi)
    routes = [s.kernel_route.variant for s in model.samples]
    phase(f"[exp] files written in {written_s:.1f} s, built in {built_s:.1f} s; "
          f"{model.n_params} params; "
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
        k5b_err = blockdiag_vs_plain(model, checked, smi)
        given = bins_given_vs_plain(model, thetas, checked, smi)
        nd = model.samples[2]
        k4a = wide_form_vs_plain("exp", nd, checked[nd.name], smi, shuffle=True)
        exp_polygon(model, thetas, smi)
        _, _, asimov = model.total_nll_batch_parts(model.prefit_vector()[None])
        phase(f"[exp:asimov] per-sample NLL at prefit through the kernels "
              f"{[f'{float(v):.3e}' for v in asimov[0]]} (bound {ASIMOV_ATOL}) | {smi}")
        if not float(asimov.abs().max()) < ASIMOV_ATOL:
            raise AssertionError(f"experiment Asimov NLL at prefit {asimov.tolist()}")
        nll_vs_plain("exp", model, thetas, tables, smi)

    fitter, step_ms, launches = run_mr2t2(
        "exp", model, thetas, CHUNK, CHUNK * TIMED_CHUNKS, CHUNK, EXP_LAUNCHES, smi, ACC_MIN,
        EAGER_STEPS, ["reweight_perchain_kernel", "reweight_shared"], op_table=True)
    generic = [s for s in model.samples if s.kernel_route.variant == "generic"]
    for s in generic:
        s.perchain_hist = "blockdiag"
    # The graph captured the atomics' kernel: the deterministic form is
    # another graph, of a fitter that goes on from the same chains.
    fitter = MR2T2(model, MCMCConfig(chunk_size=CHUNK), fitter.state.theta.cpu().numpy(), seed=4)
    fitter.run(n_steps=1, collect=False)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    fitter.run(n_steps=EXP_DET_STEPS, collect=False)
    torch.cuda.synchronize()
    det_s = time.perf_counter() - t0
    det_launches = dict(LAUNCHES)
    check_launches("exp:mr2t2-blockdiag", det_launches,
                   {"reweight_perchain_blockdiag": 2 * EXP_DET_STEPS,
                    "reweight_shared": EXP_DET_STEPS})
    det_nll = nll_recheck("exp:mr2t2-blockdiag", fitter)
    for s in generic:
        s.perchain_hist = "maskreduce"
    phase(f"[exp:mr2t2-blockdiag] {EXP_DET_STEPS} more steps with hist='blockdiag': "
          f"{1e3 * det_s / EXP_DET_STEPS:.3f} ms/step, launches {det_launches}, state NLL vs "
          f"its θ anew within {det_nll:.3e} | {smi}")
    with torch.no_grad():
        times = {s.name: time_kernel("exp", s, *checked[s.name][:2], smi) for s in model.samples}
        for s in generic:
            time_kernel("exp", s, given[s.name], checked[s.name][1], smi, " (bins given)")
        det_times = [time_kernel("exp", s, checked[s.name][0],
                                 dict(checked[s.name][1], hist="blockdiag"), smi, " (K5b)")
                     for s in generic]
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
    return {
        "K5": dict(launches=launches["reweight_perchain"],
                   max_abs_err=max(checked[s.name][2] for s in generic),
                   ms=sum(v[0] for v in perchain), plain_ms=sum(v[1] for v in perchain),
                   **summed([v[2] for v in perchain])),
        "K5b": dict(launches=det_launches["reweight_perchain_blockdiag"], max_abs_err=k5b_err,
                    ms=sum(v[0] for v in det_times), plain_ms=sum(v[1] for v in det_times),
                    **summed([v[2] for v in det_times])),
        "K4a": k4a,
        "grad": grads,
    }


def exp_io(model, exp_yaml, dev, smi: str) -> None:
    """The experiment's MC written as ``.m3evt`` and as ``.csv`` files
    (``tutorial/experiment_files.convert_mc_files``) and the experiment
    built from each on the card: every sample's buffers (events, tables,
    bins, layout, plan) and its Asimov histogram at prefit bit-identical to
    the ``.npz`` build's, and every file read by the native library
    (``core/nativeio.py``, built from ``native/m3io.cpp`` into ``_build/``)."""
    import torch

    from mach3_tpu_torch.core import nativeio
    from mach3_tpu_torch.core.config import Config
    from mach3_tpu_torch.samples.experiment import build_experiment
    from mach3_tpu_torch.tutorial.experiment_files import convert_mc_files

    t0 = time.perf_counter()
    nativeio.load_library(required=True)
    lib_s = time.perf_counter() - t0
    for fmt in ("m3evt", "csv"):
        before = dict(nativeio.READS)
        t0 = time.perf_counter()
        path = convert_mc_files(exp_yaml, fmt)
        t1 = time.perf_counter()
        other = build_experiment(Config.from_file(str(path)), device=dev).model
        t2 = time.perf_counter()
        reads = {k: nativeio.READS[k] - before[k] for k in before}
        if reads != {"native": len(model.samples), "numpy": 0}:
            raise AssertionError(f"exp:io {fmt}: readers {reads}, not the native library for "
                                 f"each of the {len(model.samples)} files")
        for a, b in zip(model.samples, other.samples):
            sa, sb = a.state_dict(), b.state_dict()
            same = sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
            if not same or a.kernel_route != b.kernel_route:
                raise AssertionError(f"exp:io {fmt}: {a.name} differs from the .npz build")
        phase(f"[exp:io] {fmt}: MC written in {t1 - t0:.2f} s, experiment built from it in "
              f"{t2 - t1:.2f} s, files read by the native library {reads}; every sample's "
              f"buffers and Asimov histogram at prefit bit-identical to the .npz build's "
              f"(library {nativeio.library_path().name}, loaded in {lib_s:.2f} s) | {smi}")
        del other


def polygons() -> list:
    out = []
    for i in range(len(POLY_COLUMNS) - 1):
        x0, x1, y0, y1 = POLY_COLUMNS[i], POLY_COLUMNS[i + 1], POLY_CUTS[i], POLY_CUTS[i + 1]
        out.append([(x0, -1.0), (x1, -1.0), (x1, y1), (x0, y0)])
        out.append([(x0, y0), (x1, y1), (x1, 1.0), (x0, 1.0)])
    return out


def exp_polygon(model, thetas, smi: str) -> None:
    """Polygon bins (``PolygonBinning``, TH2Poly's class) over (e_reco,
    cos_theta) on two of the experiment's samples: numu_nd (no shift:
    bins found once, the shared kernel under its plan) and numu_2d (an
    energy scale and an offset: bins found per step by plain torch ops and
    given to the per-chain kernel, K5's bins-given form). Each kernel against
    its plain version on the same arguments, and the NLLs through the kernels
    against the plain route with the sample's Asimov data. Comparisons, not
    the path's launches."""
    import torch

    from mach3_tpu_torch.samples.binning import PolygonBinning

    by_name = {s.name: s for s in model.samples}
    prefit = model.prefit_vector()
    all_tables = model._shared_osc_tables(thetas)
    for name, route in (("numu_nd", "shared"), ("numu_2d", "generic")):
        s = by_name[name].with_binning(PolygonBinning.build(polygons(), axis_vars=[1, 2]))
        if s.kernel_route.variant != route or s.bin_map is not None:
            raise AssertionError(f"exp:polygon {name}: route {s.kernel_route.variant}, bin map "
                                 f"{s.bin_map is not None}; want {route} with the bins given")
        s.set_data(s.asimov_data(prefit))
        tables = all_tables[[x.name for x in model.samples].index(name)]
        kname, kern, ref, make_args = kernel_of(s)
        args, kw = make_args(thetas, tables)
        got, want = kern(*args, **kw), ref(*args, **kw)
        worst = max(compare(x, y, K_RTOL, K_ATOL_FRAC, f"{name} polygon {h}")[2]
                    for x, y, h in zip(got, want, ("mc", "w2")))
        nll_k = s._stat_sum(*got)
        mc_p, w2_p = s.reweight_batch_plain(thetas, tables)
        d = (nll_k - s._stat_sum(mc_p, w2_p)).abs()
        nll_worst = float((d / nll_tolerance(s, mc_p, w2_p)).max())
        if nll_worst > 1.0:
            raise AssertionError(f"exp:polygon {name}: NLL through the kernel {float(d.max()):.3e}"
                                 f" from the plain route ({nll_worst:.2f}x the tolerance)")
        form = "bins given [C, E] by plain torch ops" if route == "generic" else "static bins"
        phase(f"[exp:polygon] {name}: {s.n_bins} polygon bins, route {route} ({kname}, {form}):"
              f" kernel vs plain within {worst:.3f} of tol; NLL through the kernel vs the plain "
              f"route {float(d.max()):.3e} ({nll_worst:.3f} of tol) at {thetas.shape[0]} chains "
              f"| {smi}")


def exp_sparse(dev, smi: str) -> None:
    """``build_toy(dense_splines=False)`` on the card: sparse spline tables,
    whose samples take the plain route (the JAX package's routing for such a
    sample: its route and reason printed); its NLLs at prefit and at
    jittered θ against the dense toy's through K1, within each sample's NLL
    tolerance (the kernel's histogram tolerance through the statistic)."""
    import numpy as np
    import torch

    from mach3_tpu_torch.tutorial.toy import build_toy

    t0 = time.perf_counter()
    sparse = build_toy(n_events=N_EVENTS, seed=SEED, e_grid_size=E_GRID, device=dev,
                       dense_splines=False).model
    built_s = time.perf_counter() - t0
    dense = build_toy(n_events=N_EVENTS, seed=SEED, e_grid_size=E_GRID, device=dev).model
    routes = [(s.kernel_route.variant, s.kernel_route.reason) for s in sparse.samples]
    if any(r[0] != "xla" for r in routes):
        raise AssertionError(f"exp:sparse: sparse-table samples must take the plain route: "
                             f"{routes}")
    thetas = torch.as_tensor(jitter_init(dense, N_CHAINS, np.random.default_rng(5)), device=dev)
    thetas[0] = dense.prefit_vector()
    with torch.no_grad():
        _, _, parts = sparse.total_nll_batch_parts(thetas)
        tables = dense._shared_osc_tables(thetas)
        worst, d_max = 0.0, 0.0
        for i, s in enumerate(dense.samples):
            mc_d, w2_d = s.reweight_batch(thetas, tables[i])
            d = (parts[:, i] - s._stat_sum(mc_d, w2_d)).abs()
            worst = max(worst, float((d / nll_tolerance(s, mc_d, w2_d)).max()))
            d_max = max(d_max, float(d.max()))
    if worst > 1.0:
        raise AssertionError(f"exp:sparse: sparse NLLs {d_max:.3e} from the dense toy's "
                             f"({worst:.2f}x the tolerance)")
    widths = [s.spline_table.event_splines.shape[1] for s in sparse.samples]
    phase(f"[exp:sparse] build_toy(dense_splines=False) in {built_s:.1f} s: "
          + "; ".join(f"{s.name}: {s.spline_table.n_splines} splines, width {w}, route "
                      f"{r[0]} ({r[1]})" for s, w, r in zip(sparse.samples, widths, routes))
          + f"; NLLs at prefit and {N_CHAINS - 1} jittered θ vs the dense toy's through K1: max "
          f"|d| {d_max:.3e} ({worst:.3f} of tol) | {smi}")


def large700_path(dev, smi: str) -> dict:
    """``build_large700()`` on the card, then its phases: kernels against
    their plain versions, the Asimov check and NLLs vs the plain route;
    ``total_nll_batch`` at 32 and 128 chains; pooled adaptive MR2T2 as a
    graph and as the eager loop; each sample's kernel time and bound; the
    posterior predictive and the chain diagnostics on the adaptive run's
    draws; one gradient evaluation; the fixture cache's round trip. Returns
    the predictive's kernel launches."""
    import numpy as np
    import torch

    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
    from mach3_tpu_torch.tutorial.large import build_large700

    rss0 = peak_rss_gib()
    t0 = time.perf_counter()
    exp = build_large700(device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    model = exp.model
    routes = [s.kernel_route.variant for s in model.samples]
    table_bytes = sum(_nbytes(s.spline_table.coeffs) for s in model.samples)
    phase(f"[large700] built in {build_s:.1f} s (host arrays and layouts, the move to the card "
          f"and the Asimov data there); {model.n_params} params, "
          f"{sum(int((~s.event_pad).sum()) for s in model.samples)} events "
          f"({sum(s.n_events for s in model.samples)} laid out), "
          f"{sum(s.n_bins for s in model.samples)} bins; "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB on the card, of it "
          f"{table_bytes / 2**30:.3f} GiB of bf16 tables; host peak resident memory of the "
          f"process {rss0:.2f} GiB before the build, {peak_rss_gib():.2f} GiB after | {smi}")
    for s in model.samples:
        phase(f"[large700] {s.name}: E={s.n_events} B={s.n_bins} "
              f"P={s.spline_table.n_spline_params} NA={s.norm_s.shape[0] - 1} route="
              f"{s.kernel_route.variant} ({s.kernel_route.reason});{layout_info(s)}")
    if routes != L7_ROUTES or model.n_params != 700:
        raise AssertionError(f"large700: routes {routes} (want {L7_ROUTES}), "
                             f"{model.n_params} params")
    rng = np.random.default_rng(0)
    thetas = torch.as_tensor(jitter_init(model, L7_CHAINS, rng), device=dev)
    names = ["reweight_shared", "reweight_perchain_kernel"]

    with torch.no_grad():
        tables = model._shared_osc_tables(thetas)
        checked = kernels_vs_plain("large700", model, thetas, tables, smi)
        nue = model.samples[1]
        plan_vs_trivial("large700", nue, checked[nue.name], smi)
        _, _, asimov = model.total_nll_batch_parts(model.prefit_vector()[None])
        phase(f"[large700:asimov] per-sample NLL at prefit through the kernels "
              f"{[f'{float(v):.3e}' for v in asimov[0]]} (bound {ASIMOV_ATOL}) | {smi}")
        if not float(asimov.abs().max()) < ASIMOV_ATOL:
            raise AssertionError(f"large700 Asimov NLL at prefit {asimov.tolist()}")
        nll_vs_plain("large700", model, thetas, tables, smi)
        for c in L7_NLL_CHAINS:
            th = thetas[:c].contiguous()
            model.total_nll_batch(th)
            ms = cuda_ms(lambda: model.total_nll_batch(th), L7_NLL_ITERS)
            phase(f"[large700:total-nll] total_nll_batch at {c} chains: {ms:.3f} ms "
                  f"({1e3 * c / ms:.1f} chain-NLLs/s; CUDA events over {L7_NLL_ITERS} calls) "
                  f"| {smi}")

    cfg = MCMCConfig(chunk_size=L7_CHUNK, **L7_ADAPTIVE)
    init = thetas.cpu().numpy()
    fit = MR2T2(model, cfg, init, seed=6)
    fit.run(n_steps=L7_WARM, collect=False)
    saved = snapshot(fit.state)
    g = run_sampler("large700:adaptive", "graph", fit, 0, L7_STEPS, L7_LAUNCHES, smi,
                    (ACC_MIN, 0.99), collect=True)
    theta = g.pop("draws")["theta"]
    profile_steps("large700:adaptive", "graph", fit, g["step_ms"], names, smi)
    roofline_line("large700:adaptive:graph", model, L7_CHAINS, g["step_ms"], smi)
    del fit
    eager = MR2T2(model, cfg, init, seed=6, graph=False)
    eager.state = snapshot(saved)
    e = run_sampler("large700:adaptive", "eager", eager, 0, L7_EAGER_STEPS, L7_LAUNCHES, smi)
    profile_steps("large700:adaptive", "eager", eager, e["step_ms"], names, smi, op_table=True)
    del eager, saved
    phase(f"[large700:graph-speedup] {e['step_ms'] / g['step_ms']:.2f}x: eager "
          f"{e['step_ms']:.3f} -> graph {g['step_ms']:.3f} ms/step | {smi}")

    with torch.no_grad():
        for s in model.samples:
            a, kw, _ = checked[s.name]
            time_kernel("large700", s, a, kw, smi)
    del checked, tables
    pred = large700_predictive(model, theta, smi)
    large700_ess(theta, dev, smi)
    del theta

    th = thetas[:L7_GRAD_CHAINS].contiguous()
    with torch.no_grad():
        tables = model._shared_osc_tables(th)
    backward_vs_plain("large700", model, th, tables, smi)
    torch.cuda.reset_peak_memory_stats()
    posterior_grad_vs_plain("large700", model, th, L7_GRAD_LAUNCHES, smi)
    phase(f"[large700:grad-memory] peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on "
          f"the card over the gradient through the kernels and through the plain route at "
          f"{L7_GRAD_CHAINS} chains | {smi}")
    del tables
    large700_grad_chees(model, th, smi)
    fixture_round_trip("large700", exp, thetas[:L7_ROUND_TRIP_CHAINS].contiguous(), dev, smi)
    return pred


def fixture_round_trip(tag: str, exp, thetas, dev, smi: str) -> None:
    """The built fixture written by the fixture cache (``save_fixture``) and
    read back onto the card (``load_fixture``): every buffer bit-identical,
    every route alike, and the per-sample NLLs through the plain route under
    PyTorch's deterministic algorithms equal bit for bit; the seconds and
    bytes of both directions."""
    import os
    import tempfile

    import torch

    from mach3_tpu_torch.core.fixture_cache import load_fixture, save_fixture

    def plain_nlls(model):
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            tables = model._shared_osc_tables(thetas)
            return torch.stack([s.log_likelihood_batch_plain(thetas, tables[i])
                                for i, s in enumerate(model.samples)], dim=1)
        finally:
            torch.use_deterministic_algorithms(False)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{tag}.pt")
        t0 = time.perf_counter()
        save_fixture(path, exp)
        t1 = time.perf_counter()
        n_bytes = os.path.getsize(path)
        loaded = load_fixture(path, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    a, b = exp.model.state_dict(), loaded.model.state_dict()
    if a.keys() != b.keys() or not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError(f"{tag}:fixture-cache: a buffer differs after the round trip")
    if [s.kernel_route for s in exp.model.samples] != \
            [s.kernel_route for s in loaded.model.samples]:
        raise AssertionError(f"{tag}:fixture-cache: the routes differ after the round trip")
    with torch.no_grad():
        n_a, n_b = plain_nlls(exp.model), plain_nlls(loaded.model)
    if not torch.equal(n_a, n_b):
        raise AssertionError(f"{tag}:fixture-cache: NLLs differ after the round trip by "
                             f"{float((n_a - n_b).abs().max()):.3e}")
    phase(f"[{tag}:fixture-cache] saved {n_bytes / 2**30:.3f} GiB in {t1 - t0:.1f} s "
          f"({n_bytes / 2**30 / (t1 - t0):.2f} GiB/s), loaded onto the card in {t2 - t1:.1f} s "
          f"({n_bytes / 2**30 / (t2 - t1):.2f} GiB/s); {len(a)} buffers bit-identical, routes "
          f"alike, per-sample NLLs at {thetas.shape[0]} chains (plain route, deterministic) "
          f"equal bit for bit | {smi}")
    del loaded


# ---------------------------------------------------------------- the remaining fitters
def capture_steps(model) -> int:
    """Steps a graphed run takes beyond those asked: the capture's warm-up
    step, a real step on a copy of the state (1 on the card, 0 on the CPU,
    where runs are eager)."""
    return int(model.flat.prefit.device.type == "cuda")


def octant_init(toy, n_w: int, split: bool = True):
    """Walkers as the JAX package's octant tests start them
    (``tests/test_tempering.py:190-202``): prefit + 0.1 prior error
    scatter inside the bounds, half at sin²θ23 = 0.45, half at 0.555."""
    import numpy as np

    m = toy.model
    th0 = m.prefit_vector().cpu().numpy()
    errs = np.concatenate([np.asarray(toy.xsec.errors), np.asarray(toy.osc.errors)])
    lo, hi = m.flat.low_bound.cpu().numpy(), m.flat.up_bound.cpu().numpy()
    rng = np.random.default_rng(0)
    init = np.clip(np.tile(th0, (n_w, 1)) + 0.1 * errs * rng.normal(size=(n_w, len(th0))),
                   lo + 1e-9, hi - 1e-9)
    if split:
        i23 = toy.names.index("osc_sin2th23")
        init[: n_w // 2, i23] = 0.45
        init[n_w // 2:, i23] = 0.555
    return init


def octant_stats(s23):
    """(octant crossings after the burn-in, upper-octant occupancy, raw and
    folded split R-hat of sin²θ23) of draws [S, W]."""
    import numpy as np

    from mach3_tpu_torch.diagnostics.rhat import split_rhat

    up = (s23 > 0.5).astype(int)[OCT_BURN:]
    post = s23[OCT_BURN:, :, None]
    return (int(np.abs(np.diff(up, axis=0)).sum()), float(up.mean()),
            float(split_rhat(post)[0]), float(split_rhat(np.abs(post - 0.5))[0]))


def octant_mcmc(tag: str, toy, smi: str, jax_gates: bool) -> None:
    """Adaptive MR2T2 and parallel tempering (OCT_PT) from walkers started
    per octant, as CUDA graphs, OCT_STEPS steps each. With ``jax_gates``
    the JAX test's: PT's cold level crosses octants more than 4x as often
    as MR2T2 (at least 4 times) with an upper-octant occupancy inside
    OCT_JAX_OCCUPANCY; else PT's cold level leaves the mirror octant where
    MR2T2's walkers stay (occupancy below and above OCT_LEFT). R-hats,
    crossings, cold and swap acceptance printed."""
    import numpy as np
    import torch

    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
    from mach3_tpu_torch.fitters.tempering import ParallelTempering, PTConfig
    from mach3_tpu_torch.kernels.launch import LAUNCHES

    m, i23 = toy.model, toy.names.index("osc_sin2th23")
    init = octant_init(toy, OCT_WALKERS)
    per_step = {"reweight_shifted": 2}
    runs = {}
    for name, make in (
        ("mr2t2", lambda: MR2T2(m, MCMCConfig(n_steps=OCT_STEPS, chunk_size=OCT_CHUNK,
                                              **OCT_MR2T2), init, seed=3)),
        ("pt", lambda: ParallelTempering(m, PTConfig(n_steps=OCT_STEPS, chunk_size=OCT_CHUNK,
                                                     **OCT_PT), init, seed=3)),
    ):
        fit = make()
        reset_launches()
        t0 = time.perf_counter()
        out = fit.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        check_launches(f"{tag}:{name}", dict(LAUNCHES),
                       {k: v * (OCT_STEPS + capture_steps(m)) for k, v in per_step.items()})
        d_nll = nll_recheck(f"{tag}:{name}", fit, rtol=PT_NLL_RTOL)
        cold = fit.cold_chain(out) if name == "pt" else out
        runs[name] = (fit, cold, octant_stats(cold["theta"][:, :, i23]), dt, d_nll)
    (_, _, (x_mr, occ_mr, r_mr, rf_mr), dt_mr, d_mr) = runs["mr2t2"]
    (pt, cold, (x_pt, occ_pt, r_pt, rf_pt), dt_pt, d_pt) = runs["pt"]
    cold_acc = float(cold["accepted"][-OCT_CHUNK:].mean())
    phase(f"[{tag}] {OCT_WALKERS} walkers x {OCT_STEPS} steps (burn-in {OCT_BURN}), started "
          f"half per octant: adaptive MR2T2 {1e3 * dt_mr / OCT_STEPS:.3f} ms/step, crossings "
          f"{x_mr}, upper occupancy {occ_mr:.4f}, R-hat raw {r_mr:.4f} folded {rf_mr:.4f}; PT "
          f"{OCT_PT['n_temps']} x {OCT_WALKERS} = {OCT_PT['n_temps'] * OCT_WALKERS} chains, "
          f"T_max {OCT_PT['max_temp']:g}: {1e3 * dt_pt / OCT_STEPS:.3f} ms/step, cold crossings "
          f"{x_pt}, upper occupancy {occ_pt:.4f}, R-hat raw {r_pt:.4f} folded {rf_pt:.4f}, cold "
          f"acceptance (last chunk) {cold_acc:.4f}, swap acceptance per boundary "
          f"{np.round(pt.swap_acceptance, 4).tolist()}; state NLLs vs θ anew within "
          f"{max(d_mr, d_pt):.3e} | {smi}")
    if not jax_gates:
        if not occ_pt < OCT_LEFT < occ_mr:
            raise AssertionError(f"{tag}: upper-octant occupancy PT {occ_pt:.4f}, MR2T2 "
                                 f"{occ_mr:.4f}: PT did not leave the mirror octant")
        return
    if not x_pt > 4 * max(x_mr, 1):
        raise AssertionError(f"{tag}: PT crossed {x_pt} times, MR2T2 {x_mr}: not > 4x")
    if not OCT_JAX_OCCUPANCY[0] < occ_pt < OCT_JAX_OCCUPANCY[1]:
        raise AssertionError(f"{tag}: PT's upper-octant occupancy {occ_pt:.4f} outside "
                             f"{OCT_JAX_OCCUPANCY}")


def octant_log_z(tag: str, toy, smi: str) -> tuple[float, float]:
    """(stepping-stone, thermodynamic) log evidence of a β = 0 ladder
    (OCT_EVIDENCE) run for OCT_EVIDENCE_STEPS steps as CUDA graphs."""
    import numpy as np
    import torch

    from mach3_tpu_torch.fitters.tempering import ParallelTempering, PTConfig
    from mach3_tpu_torch.kernels.launch import LAUNCHES

    pt = ParallelTempering(toy.model, PTConfig(n_steps=OCT_EVIDENCE_STEPS, chunk_size=OCT_CHUNK,
                                               **OCT_EVIDENCE),
                           octant_init(toy, OCT_WALKERS, split=False), seed=4)
    reset_launches()
    t0 = time.perf_counter()
    out = pt.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_launches(tag, dict(LAUNCHES),
                   {"reweight_shifted": 2 * (OCT_EVIDENCE_STEPS + capture_steps(toy.model))})
    d_nll = nll_recheck(tag, pt, rtol=PT_NLL_RTOL)
    ss, ti = pt.log_evidence(out), pt.log_evidence(out, method="thermodynamic")
    if not (np.isfinite(ss) and np.isfinite(ti)):
        raise AssertionError(f"{tag}: log evidence not finite ({ss}, {ti})")
    phase(f"[{tag}] {OCT_EVIDENCE['n_temps']} levels (beta = 0 last) x {OCT_WALKERS} walkers, "
          f"{OCT_EVIDENCE_STEPS} steps in {dt:.3f} s ({1e3 * dt / OCT_EVIDENCE_STEPS:.3f} "
          f"ms/step): log Z stepping-stone {ss:.4f}, thermodynamic {ti:.4f}; swap acceptance "
          f"{np.round(pt.swap_acceptance, 4).tolist()}; state NLLs within {d_nll:.3e} | {smi}")
    return ss, ti


def octant_path(dev, smi: str) -> None:
    """The octant toy at the README's width, NH and IH (``[octant]``): the
    same Asimov data, the sin²θ23 profile's bimodality (the JAX test's
    assertions, ``tests/test_tempering.py:206-221``), MR2T2 against PT;
    ``[octant:evidence]`` log Z(NH) − log Z(IH) > 0; ``[octant:4k]`` the
    JAX test's own width, where the mirror octant holds real mass
    (OCT_LEFT's comment says why the gates differ)."""
    import numpy as np
    import torch

    from mach3_tpu_torch.kernels.launch import LAUNCHES
    from mach3_tpu_torch.tutorial.toy import build_octant_toy

    t0 = time.perf_counter()
    nh = build_octant_toy(n_events=OCT_EVENTS, hierarchy="NH", device=dev)
    ih = build_octant_toy(n_events=OCT_EVENTS, hierarchy="IH", device=dev)
    build_s = time.perf_counter() - t0
    for toy in (nh, ih):
        routes = [s.kernel_route.variant for s in toy.samples]
        if routes != ["shifted", "shifted"]:
            raise AssertionError(f"octant: both samples must take the shifted route, got {routes}")
    if not all(torch.equal(a.data, b.data) for a, b in zip(nh.samples, ih.samples)):
        raise AssertionError("octant: the NH and IH builds' Asimov data differ")
    m, i23 = nh.model, nh.names.index("osc_sin2th23")
    vals = np.linspace(0.42, 0.60, 19)
    th = m.prefit_vector()[None].repeat(19, 1)
    th[:, i23] = torch.as_tensor(vals, device=dev)
    reset_launches()
    with torch.no_grad():
        nll = m.total_nll_batch(th).cpu().numpy()
    check_launches("octant:profile", dict(LAUNCHES), {"reweight_shifted": 2})
    nll = nll - nll.min()
    at = {v: int(np.argmin(np.abs(vals - v))) for v in (0.45, 0.51, 0.55)}
    phase(f"[octant] build_octant_toy(n_events={OCT_EVENTS}) NH and IH in {build_s:.1f} s; "
          + "; ".join(f"{s.name}: E={s.n_events}{layout_info(s)}" for s in m.samples)
          + f"; Asimov data equal; sin²θ23 profile over {vals[0]:.2f}-{vals[-1]:.2f}: "
          f"{np.round(nll, 3).tolist()} | {smi}")
    if not (nll[at[0.45]] < 0.5 and nll[at[0.51]] > nll[at[0.55]] + 0.3
            and nll[at[0.55]] < nll[-1]):
        raise AssertionError("octant: the sin²θ23 profile is not bimodal (minimum at the "
                             "truth, a barrier at 0.51 above the mirror at 0.55, the mirror "
                             "below the edge)")
    octant_mcmc("octant", nh, smi, jax_gates=False)
    lz = {h: octant_log_z(f"octant:evidence:{h}", t, smi) for h, t in (("NH", nh), ("IH", ih))}
    d_ss, d_ti = lz["NH"][0] - lz["IH"][0], lz["NH"][1] - lz["IH"][1]
    phase(f"[octant:evidence] log Z(NH) - log Z(IH): stepping-stone {d_ss:.4f}, "
          f"thermodynamic {d_ti:.4f} (NH-truth data) | {smi}")
    if not d_ss > 0:
        raise AssertionError(f"octant:evidence: log Z(NH) - log Z(IH) = {d_ss:.4f} <= 0")
    del nh, ih, m
    small = build_octant_toy(n_events=OCT_JAX_EVENTS, seed=7, e_grid_size=48, device=dev)
    octant_mcmc("octant:4k", small, smi, jax_gates=True)


def pt_graph_vs_eager(tag: str, model, cfg, saved, n_walkers: int, smi: str) -> None:
    """Parallel tempering as a graph and as the eager loop from the state
    ``saved``. Robbins-Monro held, GVE_STEPS steps each: the generators end
    alike; at most PT_GVE_WALKERS walker columns (a column: one walker's
    chain at every level, which swaps mix) hold a chain that decided
    differently, each first where the two log α differ by at most GVE_NLL;
    θ of every other column bit-identical at every step. Then Robbins-Monro
    on, PT_GVE_SHADOW graph steps each shadowed by an eager step from the
    graph's state: the same, step by step, and the per-level log-scales
    within γ_t x the level-mean acceptance probabilities' difference +
    GVE_RM_ROUND."""
    import dataclasses

    import numpy as np
    import torch

    from mach3_tpu_torch.fitters.tempering import ParallelTempering

    n_t = cfg.n_temps
    init = saved.theta.cpu().numpy()[:n_walkers]

    def columns(flips):  # [S, T*W] -> [W]
        return flips.reshape(flips.shape[0], n_t, n_walkers).any((0, 1))

    def first_gaps(g, e, flips):
        gaps = []
        for c in np.flatnonzero(flips.any(0)):
            s = np.flatnonzero(flips[:, c])[0]
            gaps.append(abs(np.log(g["acc_prob"][s, c]) - np.log(e["acc_prob"][s, c])))
        if gaps and max(gaps) > GVE_NLL:
            raise AssertionError(f"{tag}: a decision differs where the log α differ by "
                                 f"{max(gaps):.3e} > {GVE_NLL}")
        return gaps

    held = dataclasses.replace(cfg, robbins_monro=False)
    runs = {}
    for graph in (True, False):
        fit = ParallelTempering(model, held, init, seed=0, graph=None if graph else False)
        fit.state = snapshot(saved)
        runs[graph] = (fit, fit.run(n_steps=GVE_STEPS))
    (fg, g), (fe, e) = runs[True], runs[False]
    if not torch.equal(fg.state.generator.get_state(), fe.state.generator.get_state()):
        raise AssertionError(f"{tag}: the generators' states differ after the runs")
    flips = g["accepted"] != e["accepted"]
    gaps = first_gaps(g, e, flips)
    bad = columns(flips)
    if bad.sum() > PT_GVE_WALKERS:
        raise AssertionError(f"{tag}: {int(bad.sum())} walker columns decided differently")
    keep = ~np.tile(bad, n_t)
    if not np.array_equal(g["theta"][:, keep], e["theta"][:, keep]):
        raise AssertionError(f"{tag}: θ of walker columns that decided alike differ")
    swaps = "bit-identical" if not bad.any() else "not compared (a column diverged)"
    if not bad.any() and not torch.equal(fg.state.swap_accepts, fe.state.swap_accepts):
        raise AssertionError(f"{tag}: swap counters differ, every decision alike")
    fg = ParallelTempering(model, cfg, init, seed=0)
    fe = ParallelTempering(model, cfg, init, seed=0, graph=False)
    fg.state = snapshot(saved)
    s_flips, s_worst = 0, 0.0
    for _ in range(PT_GVE_SHADOW):
        fe.state = snapshot(fg.state)
        gs, es = fg.run(n_steps=1), fe.run(n_steps=1)
        t = int(fg.state.step)
        if not torch.equal(fg.state.generator.get_state(), fe.state.generator.get_state()):
            raise AssertionError(f"{tag}: the generators' states differ at step {t}")
        fl = gs["accepted"] != es["accepted"]
        first_gaps(gs, es, fl)
        s_flips += int(fl.sum())
        if not np.array_equal(gs["theta"][:, ~np.tile(columns(fl), n_t)],
                              es["theta"][:, ~np.tile(columns(fl), n_t)]):
            raise AssertionError(f"{tag}: θ of columns that decided alike differ at step {t}")
        d_acc = np.abs(gs["acc_prob"][0] - es["acc_prob"][0]).reshape(n_t, n_walkers).mean(1)
        d_scale = (fg.state.log_scale - fe.state.log_scale).abs().cpu().numpy()
        s_worst = max(s_worst, float(d_scale.max()))
        if (d_scale - 2.0 / max(t, 1) ** 0.66 * d_acc).max() > GVE_RM_ROUND:
            raise AssertionError(f"{tag}: the log-scales differ at step {t} by {d_scale.max():.3e}, "
                                 "beyond γ_t x the acceptance probabilities' difference")
    if s_flips > PT_GVE_WALKERS * PT_GVE_SHADOW:
        raise AssertionError(f"{tag}: {s_flips} chain-steps decided differently (shadowed)")
    phase(f"[{tag}] from step {int(saved.step)}, Robbins-Monro held, {GVE_STEPS} steps x "
          f"{n_t * n_walkers} chains as a graph and as the eager loop: generators equal; "
          f"{int(bad.sum())} walker columns decided differently (log α gaps "
          f"{[f'{x:.2e}' for x in gaps]}); θ of the others bit-identical at every step; swap "
          f"counters {swaps}; Robbins-Monro on, {PT_GVE_SHADOW} graph steps each shadowed by an "
          f"eager one: {s_flips} chain-steps decided differently, log-scales within "
          f"{s_worst:.3e} | {smi}")


def toy_pt(model, smi: str) -> None:
    """``[toy:pt]``: the JAX bench's parallel_tempering section
    (``bench.py:839-869``): 6 levels x 64 walkers, chunks of 50, 100
    warm-up steps then 300 timed, as a graph and as the eager loop, each
    profiled; then graph against eager from the graph's state."""
    import numpy as np

    from mach3_tpu_torch.fitters.tempering import ParallelTempering, PTConfig

    init = jitter_init(model, TOY_PT_WALKERS, np.random.default_rng(5))
    cfg = PTConfig(n_steps=TOY_PT_STEPS, **TOY_PT)
    n_t, per_step = cfg.n_temps, {"reweight_shifted": 2}
    names = ["reweight_perchain_kernel"]
    res = {}
    for graph, warm, steps in ((True, TOY_PT_WARM, TOY_PT_STEPS), (False, 10, TOY_PT_EAGER)):
        mode = "graph" if graph else "eager"
        fit = ParallelTempering(model, cfg, init, seed=5, graph=None if graph else False)
        r = run_sampler("toy:pt", mode, fit, warm, steps, per_step, smi)
        prof = profile_steps("toy:pt", mode, fit, r["step_ms"], names, smi)
        res[mode] = (fit, r, prof)
    fit, r, prof = res["graph"]
    e_ms = res["eager"][1]["step_ms"]
    phase(f"[toy:pt] {n_t} levels x {TOY_PT_WALKERS} walkers, T_max {cfg.max_temp:g}: graph "
          f"{r['step_ms']:.3f} ms/step, cold {1e3 * TOY_PT_WALKERS / r['step_ms']:.1f} and "
          f"all-level {1e3 * n_t * TOY_PT_WALKERS / r['step_ms']:.1f} chain-steps/s; eager "
          f"{e_ms:.3f} ms/step ({e_ms / r['step_ms']:.2f}x); graph {prof['launches']:.1f} host "
          f"launches/step, {prof['ops']:.0f} device ops/step, device busy {prof['busy']:.3f} "
          f"ms/step, idle share {1.0 - prof['busy'] / r['step_ms']:.3f}; cold acceptance "
          f"{float(fit.acceptance_rate[:TOY_PT_WALKERS].mean()):.4f}, swap acceptance per "
          f"boundary {np.round(fit.swap_acceptance, 4).tolist()} | {smi}")
    pt_graph_vs_eager("toy:pt:graph-vs-eager", model, cfg, snapshot(fit.state), TOY_PT_WALKERS,
                      smi)


def toy_ensemble(model, smi: str) -> None:
    """``[toy:ensemble]``: the stretch-move ensemble, ENS_WALKERS walkers
    (halves of ENS_WALKERS / 2, each kernel twice a step), as a graph and as
    the eager loop, each profiled; then ENS_SHADOW graph steps each shadowed
    by an eager step from the graph's state: generators alike, at most
    ENS_FLIPS walkers a step deciding differently (each where the two
    acceptance probabilities' logs differ by at most GVE_NLL), θ of the rest
    bit-identical (the second half's walkers only where no first-half walker
    flipped: they move against the first half's new positions)."""
    import numpy as np
    import torch

    from mach3_tpu_torch.fitters.ensemble import EnsembleConfig, EnsembleSampler

    init = jitter_init(model, ENS_WALKERS, np.random.default_rng(6))
    cfg = EnsembleConfig(chunk_size=ENS_CHUNK)
    per_step = {"reweight_shifted": 4}
    names = ["reweight_perchain_kernel"]
    res = {}
    for graph, warm, steps in ((True, ENS_CHUNK, ENS_STEPS), (False, 10, ENS_EAGER)):
        mode = "graph" if graph else "eager"
        fit = EnsembleSampler(model, cfg, init, seed=6, graph=None if graph else False)
        r = run_sampler("toy:ensemble", mode, fit, warm, steps, per_step, smi)
        prof = profile_steps("toy:ensemble", mode, fit, r["step_ms"], names, smi)
        res[mode] = (fit, r, prof)
    fg, r, prof = res["graph"]
    fe = EnsembleSampler(model, cfg, init, seed=6, graph=False)
    half, flipped = ENS_WALKERS // 2, 0
    for _ in range(ENS_SHADOW):
        fe.state = snapshot(fg.state)
        g, e = fg.run(n_steps=1), fe.run(n_steps=1)
        t = int(fg.state.step)
        if not torch.equal(fg.state.generator.get_state(), fe.state.generator.get_state()):
            raise AssertionError(f"toy:ensemble: the generators' states differ at step {t}")
        fl = (g["accepted"] != e["accepted"])[0]
        if fl.sum() > ENS_FLIPS:
            raise AssertionError(f"toy:ensemble: {int(fl.sum())} walkers decided differently "
                                 f"at step {t}")
        if fl.any():
            gap = np.abs(np.log(g["acc_prob"][0, fl]) - np.log(e["acc_prob"][0, fl])).max()
            if gap > GVE_NLL:
                raise AssertionError(f"toy:ensemble: a decision differs at step {t} where the "
                                     f"log acceptance probabilities differ by {gap:.3e}")
        keep = ~fl
        if fl[:half].any():
            keep[half:] = False
        flipped += int(fl.sum())
        if not np.array_equal(g["theta"][0, keep], e["theta"][0, keep]):
            raise AssertionError(f"toy:ensemble: θ of walkers that decided alike differ at "
                                 f"step {t}")
    e_ms = res["eager"][1]["step_ms"]
    phase(f"[toy:ensemble] {ENS_WALKERS} walkers (halves of {half}): graph {r['step_ms']:.3f} "
          f"ms/step ({1e3 * ENS_WALKERS / r['step_ms']:.1f} walker-steps/s), eager "
          f"{e_ms:.3f} ms/step ({e_ms / r['step_ms']:.2f}x); graph {prof['launches']:.1f} host "
          f"launches/step, {prof['ops']:.0f} device ops/step, device busy {prof['busy']:.3f} "
          f"ms/step, idle share {1.0 - prof['busy'] / r['step_ms']:.3f}; acceptance "
          f"{r['acc']:.4f} (last chunk {r['acc_last']:.4f}); {ENS_SHADOW} graph steps shadowed "
          f"by eager ones: generators equal, {flipped} walker-steps decided differently, θ of "
          f"the rest bit-identical | {smi}")


def toy_pso(model, smi: str, fit_result: dict) -> None:
    """``[toy:pso]``: ``run_pso`` (PSO_CFG) from the toy's prefit, its
    iterations as CUDA graphs: each iteration one χ² batch of the particles
    (K1 twice); the final χ² at or below the best initial particle's."""
    import numpy as np
    import torch

    from mach3_tpu_torch.fitters.pso import PSOConfig, run_pso
    from mach3_tpu_torch.kernels.launch import LAUNCHES

    cfg = PSOConfig(**PSO_CFG)
    reset_launches()
    t0 = time.perf_counter()
    res = run_pso(model, cfg, seed=7)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    # The initial batch, the capture's warm-up iteration and every iteration.
    check_launches("toy:pso", dict(LAUNCHES),
                   {"reweight_shifted": 2 * (cfg.n_iterations + 1 + capture_steps(model))})
    if not (np.isfinite(res.chi2) and res.chi2 <= res.initial_chi2):
        raise AssertionError(f"toy:pso: χ² {res.chi2} above the best initial particle's "
                             f"{res.initial_chi2}")
    phase(f"[toy:pso] {cfg.n_particles} particles x {cfg.n_iterations} iterations (graphs): "
          f"χ² {res.initial_chi2:.4f} (best initial particle) -> {res.chi2:.6g}, "
          f"{res.n_evaluations} evaluations in {dt:.3f} s ({1e3 * dt / cfg.n_iterations:.3f} "
          f"ms/iteration); run_minimizer: χ² {fit_result['chi2']:.6g} in "
          f"{fit_result['n']} evaluations, {fit_result['dt']:.3f} s | {smi}")


def toy_scan2d(toy, smi: str) -> None:
    """``[toy:scan2d]``: ``llh_scan_2d`` of SCAN2D_POINTS² on (sin²θ23,
    Δm²31), the grid points on the chain axis; its minimum at the Asimov
    truth, the grid's centre."""
    import numpy as np
    import torch

    from mach3_tpu_torch.fitters.scans import llh_scan_2d
    from mach3_tpu_torch.kernels.launch import LAUNCHES

    ix, iy = toy.names.index("osc_sin2th23"), toy.names.index("osc_dm2_31")
    reset_launches()
    t0 = time.perf_counter()
    s2 = llh_scan_2d(toy.model, ix, iy, n_points=SCAN2D_POINTS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    check_launches("toy:scan2d", dict(LAUNCHES), {"reweight_shifted": 2})
    at = np.unravel_index(np.argmin(s2["total"]), s2["total"].shape)
    centre = (SCAN2D_POINTS // 2, SCAN2D_POINTS // 2)
    phase(f"[toy:scan2d] {SCAN2D_POINTS} x {SCAN2D_POINTS} points in {dt:.3f} s "
          f"({SCAN2D_POINTS ** 2 / dt:.1f} points/s, one batched call): minimum "
          f"{s2['total'].min():.3e} at {tuple(int(i) for i in at)} (the truth: {centre}), "
          f"total at the corners {np.round(s2['total'][[0, -1]][:, [0, -1]], 2).tolist()} | {smi}")
    if tuple(at) != centre or not np.isfinite(s2["total"]).all():
        raise AssertionError(f"toy:scan2d: minimum at {at}, not at the Asimov truth {centre}")


def toy_llhscan_cli(dev, smi: str) -> None:
    """``[toy:llhscan-cli]``: ``mach3-llhscan-torch`` on the toy at N_EVENTS
    (1-D scans of all 16 parameters, a 2-D scan, both samples' sigma
    variations) writing its output file."""
    import os
    import tempfile

    import numpy as np
    import torch

    from mach3_tpu_torch.cli import llhscan
    from mach3_tpu_torch.kernels.launch import LAUNCHES

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "llhscan.npz")
        reset_launches()
        t0 = time.perf_counter()
        rc = llhscan.main([f"Toy:NEvents:{N_EVENTS}", f"Toy:Seed:{SEED}", "--device", dev.type,
                           "--points", str(SCAN_POINTS), "--scan-2d", "osc_sin2th23",
                           "osc_dm2_31", "--sigma-var", "-o", out])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"toy:llhscan-cli: exit code {rc}")
        with np.load(out) as f:
            shapes = {k: f[k].shape for k in f.files}
            finite = all(np.isfinite(f[k]).all() for k in f.files if k != "names")
        size = os.path.getsize(out)
    want = {"scan1d_total": (16, SCAN_POINTS), "scan1d_samples": (16, SCAN_POINTS, 2),
            "sigvar_numu_sample_hists": (16, 5, 30), "sigvar_nue_sample_hists": (16, 5, 15)}
    if any(shapes.get(k) != v for k, v in want.items()) or not finite:
        raise AssertionError(f"toy:llhscan-cli: output {shapes} (finite {finite})")
    launches = dict(LAUNCHES)
    if not launches.get("reweight_shifted"):
        raise AssertionError("toy:llhscan-cli: the shifted kernel was not launched")
    phase(f"[toy:llhscan-cli] mach3-llhscan-torch, {N_EVENTS} events: {len(shapes)} arrays "
          f"({size} bytes) in {dt:.1f} s (build included); kernel launches {launches} | {smi}")


def large_scan(model, smi: str) -> None:
    """``[large:scan]``: ``llh_scan_1d`` over every parameter x SCAN_POINTS
    points on the chain axis in chunks of the default size; SCAN_PLAIN
    points' per-sample NLLs against the plain route within
    ``nll_tolerance``; each scan's centre (where it is the prefit value)
    against ``total_nll_batch`` at prefit; ``sigma_variations`` of numu_beam
    (K2) and nue_beam (K3) against the plain route within the kernels'
    tolerance; ``drag_race``."""
    import math

    import numpy as np
    import torch

    from mach3_tpu_torch.fitters.scans import (
        default_max_points,
        drag_race,
        llh_scan_1d,
        sigma_variations,
    )
    from mach3_tpu_torch.kernels.launch import LAUNCHES

    dev = model.flat.prefit.device
    n_par = model.n_params
    n_pts = n_par * SCAN_POINTS
    chunk = default_max_points(model)
    n_chunks = math.ceil(n_pts / chunk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    scan = llh_scan_1d(model, n_points=SCAN_POINTS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    check_launches("large:scan", dict(LAUNCHES),
                   {"reweight_shared": 2 * n_chunks, "reweight_shifted": n_chunks,
                    "osc_layered": n_chunks})
    if not np.isfinite(scan["total"]).all():
        raise AssertionError("large:scan: non-finite scan values")
    prefit = model.prefit_vector().cpu().numpy()

    def points(idx, values):
        th = np.tile(prefit, (len(values), 1))
        th[np.arange(len(values)), idx] = values
        return torch.as_tensor(th, device=dev)

    flat_idx = np.repeat(np.arange(n_par), SCAN_POINTS)
    flat_val = scan["values"].reshape(-1)
    sel = np.linspace(0, n_pts - 1, SCAN_PLAIN).astype(int)
    th = points(flat_idx[sel], flat_val[sel])
    with torch.no_grad():
        tables = model._shared_osc_tables(th)
        worst, d_max = 0.0, 0.0
        for i, s in enumerate(model.samples):
            mc, w2 = s.reweight_batch_plain(th, tables[i])
            got = torch.as_tensor(scan["samples"].reshape(n_pts, -1)[sel, i], device=dev)
            d = (got - s._stat_sum(mc, w2)).abs()
            worst = max(worst, float((d / nll_tolerance(s, mc, w2)).max()))
            d_max = max(d_max, float(d.max()))
        at_prefit = model.total_nll_batch(torch.as_tensor(prefit[None], device=dev))
        tol0 = sum(nll_tolerance(s, *s.reweight_batch_plain(
            torch.as_tensor(prefit[None], device=dev))) for s in model.samples)
    if worst > 1.0:
        raise AssertionError(f"large:scan: per-sample NLLs {worst:.2f}x the tolerance from the "
                             "plain route")
    mid = SCAN_POINTS // 2
    centred = np.abs(scan["values"][:, mid] - prefit) <= 1e-12 * np.maximum(np.abs(prefit), 1.0)
    d_centre = np.abs(scan["total"][centred, mid] - float(at_prefit[0]))
    if not d_centre.max() <= float(tol0[0]):
        raise AssertionError(f"large:scan: a centre point is {d_centre.max():.3e} from "
                             f"total_nll_batch at prefit (tolerance {float(tol0[0]):.3e})")
    phase(f"[large:scan] llh_scan_1d: {n_par} params x {SCAN_POINTS} points = {n_pts} points "
          f"in {n_chunks} chunks of <= {chunk} in {dt:.3f} s ({n_pts / dt:.1f} points/s), peak "
          f"{peak:.2f} GiB; {SCAN_PLAIN} points' per-sample NLLs vs plain within {d_max:.3e} "
          f"({worst:.3f} of tol); {int(centred.sum())} centre points (the others' grids are "
          f"clipped at a bound) within {d_centre.max():.3e} of total_nll_batch at prefit "
          f"{float(at_prefit[0]):.3e} | {smi}")
    for si, kern in ((0, "reweight_shared"), (1, "reweight_shifted")):
        s = model.samples[si]
        reset_launches()
        t0 = time.perf_counter()
        sv = sigma_variations(model, sample_index=si)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n_sv = sv["values"].size
        check_launches(f"large:sigma-var:{s.name}", dict(LAUNCHES),
                       {kern: math.ceil(n_sv / chunk)})
        th = points(np.repeat(np.arange(n_par), len(sv["sigmas"])), sv["values"].reshape(-1))
        with torch.no_grad():
            ref = s.reweight_batch_plain(th)[0]
        got = torch.as_tensor(sv["hists"].reshape(n_sv, -1), device=dev, dtype=ref.dtype)
        err, rel, w = compare(got, ref, K_RTOL, K_ATOL_FRAC, f"large:sigma-var:{s.name}")
        phase(f"[large:sigma-var] {s.name} ({kern}): hists {list(sv['hists'].shape)} in "
              f"{dt:.3f} s; vs plain max abs err {err:.3e}, max rel {rel:.3e} ({w:.3f} of tol) "
              f"| {smi}")
    reset_launches()
    race = drag_race(model, n_laps=20, n_chains=LARGE_CHAINS)
    phase(f"[large:drag-race] ms/call at {LARGE_CHAINS} chains (drag_race): "
          + ", ".join(f"{k} {1e3 * v:.3f}" for k, v in race.items()) + f" | {smi}")


def exp_cli_pt(dev, smi: str) -> None:
    """``[exp:cli-pt]``: ``mach3-mcmc-torch`` running parallel tempering with
    a β = 0 ladder (``General:FittingAlgorithm:PT``, ``General:PT:BetaZero``)
    on the YAML experiment: two chunks, then a resume for a third. The chain
    file holds the cold level only (EXP_PT_WALKERS chains) with
    ``log_evidence`` in its metadata; the checkpoint holds every level."""
    import os
    import tempfile

    import numpy as np
    import torch

    from mach3_tpu_torch.cli import mcmc as cli
    from mach3_tpu_torch.diagnostics.chain_io import load_chain
    from mach3_tpu_torch.kernels.launch import LAUNCHES
    from mach3_tpu_torch.tutorial.experiment_files import write_experiment

    n_chains = EXP_PT_TEMPS * EXP_PT_WALKERS
    with tempfile.TemporaryDirectory() as tmp:
        exp_yaml = str(write_experiment(tmp, n_events=EXP_EVENTS, seed=EXP_SEED))
        out = os.path.join(tmp, "chain.npz")
        overrides = ["General:FittingAlgorithm:PT", "General:PT:BetaZero:true",
                     f"General:PT:NTemps:{EXP_PT_TEMPS}", f"General:MCMC:NChains:{EXP_PT_WALKERS}",
                     f"General:MCMC:AutoSave:{EXP_PT_CHUNK}"]
        opts = ["--device", dev.type, "--seed", "4", "--stream", "off", "-o", out]
        first, total = 2 * EXP_PT_CHUNK, 3 * EXP_PT_CHUNK
        reset_launches()
        t0 = time.perf_counter()
        if cli.main([exp_yaml, *overrides, f"General:MCMC:NSteps:{first}", *opts]) != 0:
            raise AssertionError("exp:cli-pt: the first run failed")
        t1 = time.perf_counter()
        d1, meta1, _ = load_chain(out)
        _, _, ck = load_chain(out + ".ckpt")
        if cli.main([exp_yaml, *overrides, f"General:MCMC:NSteps:{total}", *opts,
                     "--checkpoint", out + ".ckpt"]) != 0:
            raise AssertionError("exp:cli-pt: the resumed run failed")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        d2, meta2, _ = load_chain(out)
        _, _, ck2 = load_chain(out + ".ckpt")
    n_par = len(meta1["names"])
    if d1["theta"].shape != (first, EXP_PT_WALKERS, n_par) or d2["theta"].shape != (
            total, EXP_PT_WALKERS, n_par):
        raise AssertionError(f"exp:cli-pt: chain shapes {d1['theta'].shape}, "
                             f"{d2['theta'].shape}: not the cold level")
    if ck["st.theta"].shape != (n_chains, n_par) or int(ck2["st.step"]) != total:
        raise AssertionError("exp:cli-pt: the checkpoint does not hold every level's state")
    if not np.array_equal(ck["st.theta"][:EXP_PT_WALKERS], d1["theta"][-1]):
        raise AssertionError("exp:cli-pt: the checkpoint's cold level is not the chain's last")
    if not np.array_equal(d2["theta"][:first], d1["theta"]):
        raise AssertionError("exp:cli-pt: the resumed chain file changed the first run's draws")
    lz = [m.get("log_evidence") for m in (meta1, meta2)]
    if not all(v is not None and np.isfinite(v) for v in lz):
        raise AssertionError(f"exp:cli-pt: log_evidence in the metadata: {lz}")
    if not np.isfinite(d2["nll"]).all():
        raise AssertionError("exp:cli-pt: non-finite NLLs in the chain")
    launches = dict(LAUNCHES)
    if not (launches.get("reweight_perchain") and launches.get("reweight_shared")):
        raise AssertionError(f"exp:cli-pt: a kernel of the path was not launched: {launches}")
    phase(f"[exp:cli-pt] mach3-mcmc-torch, parallel tempering {EXP_PT_TEMPS} levels (beta = 0 "
          f"last) x {EXP_PT_WALKERS} walkers = {n_chains} chains x {EXP_EVENTS} events: "
          f"{first} steps in {t1 - t0:.1f} s (files, build and capture included), resumed for "
          f"{total - first} more in {t2 - t1:.1f} s; chain file {d2['theta'].shape} (cold "
          f"level), checkpoint {ck2['st.theta'].shape} at step {int(ck2['st.step'])}; "
          f"log_evidence {lz[0]:.4f} (first run), {lz[1]:.4f} (resumed run's steps); kernel "
          f"launches {launches} | {smi}")


def device_busy(fn) -> tuple[float, float]:
    """(device busy ms, device ops) of one call of ``fn`` under
    ``torch.profiler``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in dev_ops) / 1e3,
            sum(e.count for e in dev_ops))


def timed_predictive(tag: str, model, toys, smi: str, categories=None):
    """``run_predictive`` over ``toys`` twice: a first run (at new shapes
    it loads CUDA modules and grows the allocator's pool: ~3 s on the toy),
    then the timed run on the host clock, whose kernel launches are gated:
    each sample's kernel once per chunk. Returns (result, seconds, launches,
    peak GiB, chunks, the first run's seconds)."""
    import numpy as np
    import torch

    from mach3_tpu_torch.diagnostics.predictive import run_predictive
    from mach3_tpu_torch.kernels.launch import LAUNCHES

    t0 = time.perf_counter()
    run_predictive(model, toys, seed=PRED_SEED, categories=categories)
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    res = run_predictive(model, toys, seed=PRED_SEED, categories=categories)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_chunks = -(-len(toys) // res.chunk)
    want: dict = {"osc_layered": layered_grids_of(model) * n_chunks}
    for s in model.samples:
        name = kernel_of(s)[0]
        want[name] = want.get(name, 0) + n_chunks
    check_launches(f"{tag} ({len(toys)} toys, {n_chunks} chunks)", launches, want)
    for x in (res.llh_data, res.llh_draw) + tuple(res.spectra):
        if not np.isfinite(x).all():
            raise AssertionError(f"{tag}: non-finite spectra or NLLs")
    return res, dt, launches, peak, n_chunks, first


def toy_predictive(toy, draws: dict, smi: str) -> dict:
    """``[toy:predictive]``: PRED_TOYS toys drawn from ``[toy:adaptive]``'s
    timed run (1,000 steps x 256 chains) through ``run_predictive`` with the
    toy's interaction modes as categories: K1 once per sample and chunk.
    Gates: the spectra against the plain route on the same toys; each toy's
    ``llh_data`` against the per-sample parts of ``total_nll_batch_parts``
    at its θ; the by-mode sum against the kernel spectra; the per-bin
    p-values on the Asimov data inside PRED_BIN_BAND and, on a copy of the
    model with the data x PRED_BAD_SCALE, the p-value below PRED_P_BAD and
    the per-bin ones of bins with data below the band. Returns the
    launches."""
    import copy

    import numpy as np
    import torch

    from mach3_tpu_torch.diagnostics.predictive import draw_parameter_sets, run_predictive

    model = toy.model
    dev = model.flat.prefit.device
    toys = draw_parameter_sets(draws["theta"], PRED_TOYS, np.random.default_rng(PRED_SEED),
                               burn_in=PRED_BURN)
    res, dt, launches, peak, n_chunks, first = timed_predictive(
        "toy:predictive", model, toys, smi, categories=toy.event_modes)
    th = torch.as_tensor(toys, device=dev)
    worst = {}
    with torch.no_grad():
        tables = model._shared_osc_tables(th)
        parts = model.total_nll_batch_parts(th)[2]
        for i, s in enumerate(model.samples):
            mc = torch.as_tensor(res.spectra[i], device=dev)
            ref_mc, ref_w2 = s.reweight_batch_plain(th, tables[i])
            _, rel, w = compare(mc, ref_mc, K_RTOL, K_ATOL_FRAC, f"toy:predictive {s.name}")
            gap = (torch.as_tensor(res.llh_data_per_sample[:, i], device=dev) - parts[:, i]).abs()
            tol = nll_tolerance(s, mc, ref_w2)
            if not bool((gap <= tol).all()):
                raise AssertionError(f"toy:predictive {s.name}: llh_data {float(gap.max()):.3e} "
                                     f"from total_nll_batch_parts (tolerance "
                                     f"{float(tol.min()):.3e}+)")
            bym = torch.as_tensor(res.spectra_by_mode[i], device=dev).sum(1)
            _, _, wb = compare(bym, mc, K_RTOL, K_ATOL_FRAC, f"toy:predictive {s.name} by mode")
            worst[s.name] = (rel, w, float(gap.max()), wb)
    lo, hi = PRED_BIN_BAND
    per_bin = np.concatenate(res.p_value_per_bin)
    if not (lo < per_bin.min() and per_bin.max() < hi):
        raise AssertionError(f"toy:predictive: per-bin p-values {per_bin.min():.3f}-"
                             f"{per_bin.max():.3f} on the Asimov data, outside {PRED_BIN_BAND}")
    bad = copy.deepcopy(model)
    for s in bad.samples:
        s.set_data(s.data * PRED_BAD_SCALE)
    res_bad = run_predictive(bad, toys, seed=PRED_SEED)
    del bad
    filled = np.concatenate([s.data.cpu().numpy() > 0 for s in model.samples])  # x 1.5 moves
    p_bad, bad_bin = res_bad.p_value, np.concatenate(res_bad.p_value_per_bin)[filled].max()
    if not (p_bad < PRED_P_BAD and bad_bin < lo):
        raise AssertionError(f"toy:predictive: p-value {p_bad}, per-bin up to {bad_bin} with "
                             f"the data x {PRED_BAD_SCALE}")
    busy, ops = device_busy(lambda: run_predictive(model, toys, seed=PRED_SEED,
                                                   categories=toy.event_modes))
    phase(f"[toy:predictive] {PRED_TOYS} toys x {N_EVENTS} events (burn-in {PRED_BURN} of "
          f"{draws['theta'].shape[0]} steps x {draws['theta'].shape[1]} chains) in {dt:.3f} s "
          f"(first run {first:.3f} s): {PRED_TOYS / dt:.1f} toys/s, {n_chunks} chunk(s) of <= "
          f"{res.chunk}, peak "
          f"{peak:.2f} GiB, device busy {busy:.3f} ms ({ops:.0f} device ops; profiled run); "
          f"kernel launches {launches}; p-value {res.p_value:.4f} (Asimov; per bin "
          f"{per_bin.min():.3f}-{per_bin.max():.3f}), {p_bad:.4f} (data x {PRED_BAD_SCALE}; per "
          f"bin <= {bad_bin:.3f}); fluctuated pred {res.p_value_fluct_pred:.4f}, data "
          f"{res.p_value_fluct_data:.4f}, rate {res.p_value_rate:.4f}; per sample (spectra max "
          f"rel err vs plain, of tol; llh_data vs total_nll_batch_parts; by-mode sum of tol): "
          + ", ".join(f"{k} {v[0]:.3e} {v[1]:.3f} {v[2]:.3e} {v[3]:.3f}"
                      for k, v in worst.items()) + f" | {smi}")
    return launches


def large700_predictive(model, theta, smi: str) -> dict:
    """``[large700:predictive]``: PRED_TOYS toys drawn from
    ``[large700:adaptive]``'s timed run through ``run_predictive`` at the
    default chunk (``default_max_points``): five samples on K2 and two on
    K3, each once per chunk; on the first L7_PRED_CHECK toys each sample's
    spectra against its kernel's plain version. Returns the launches."""
    import numpy as np
    import torch

    from mach3_tpu_torch.diagnostics.predictive import draw_parameter_sets

    dev = model.flat.prefit.device
    toys = draw_parameter_sets(theta, PRED_TOYS, np.random.default_rng(PRED_SEED),
                               burn_in=PRED_BURN)
    res, dt, launches, peak, n_chunks, first = timed_predictive("large700:predictive", model, toys,
                                                                smi)
    th = torch.as_tensor(toys[:L7_PRED_CHECK], device=dev)
    errs = []
    with torch.no_grad():
        tables = model._shared_osc_tables(th)
        for i, s in enumerate(model.samples):
            _, _, ref, make = kernel_of(s)
            args, kw = make(th, tables[i])
            ref_mc, _ = ref(*args, **kw)
            mc = torch.as_tensor(res.spectra[i][:L7_PRED_CHECK], device=dev)
            _, rel, w = compare(mc, ref_mc, K_RTOL, K_ATOL_FRAC, f"large700:predictive {s.name}")
            errs.append(f"{s.name} {rel:.3e} ({w:.3f} of tol)")
    n_events = sum(s.n_events for s in model.samples)
    phase(f"[large700:predictive] {PRED_TOYS} toys x 7 samples ({n_events} laid-out events) "
          f"in {dt:.3f} s (first run {first:.3f} s): {PRED_TOYS / dt:.1f} toys/s, {n_chunks} "
          f"chunk(s) of <= {res.chunk}, peak {peak:.2f} GiB; kernel launches {launches}; p-value "
          f"{res.p_value:.4f}; kernels vs plain on {L7_PRED_CHECK} toys: " + ", ".join(errs)
          + f" | {smi}")
    return launches


def np_tau(x):
    """numpy f64 reference of the integrated autocorrelation time of each
    column of x [S, N] (``autocorrelation_fft`` + ``integrated_autocorr_time``)."""
    import numpy as np

    s = x.shape[0]
    x = x - x.mean(0, keepdims=True)
    nfft = 1 << int(np.ceil(np.log2(2 * s)))
    f = np.fft.rfft(x, n=nfft, axis=0)
    acf = np.fft.irfft(f * np.conj(f), n=nfft, axis=0)[:min(s - 1, 1000)]
    rho = acf / np.maximum(acf[0:1], 1e-30)
    cum = 2.0 * np.cumsum(rho, axis=0) - 1.0
    ok = np.arange(rho.shape[0])[:, None] >= 5.0 * cum
    first = np.where(ok.any(0), np.argmax(ok, axis=0), rho.shape[0] - 1)
    return np.take_along_axis(cum, first[None], axis=0)[0]


def large700_ess(theta, dev, smi: str) -> None:
    """``[large700:ess]``: ESS, Geweke z and batched means of
    ``[large700:adaptive]``'s chain [S, 128, 700] on the card against a
    numpy f64 reference (within ESS_RTOL of the value, or of the terms it
    is the difference of: a Geweke z-score's two means, a batch's mean
    |value|; columns that never moved are left out, their FFTs read only
    rounding); then an AR(1) chain of AR1_STEPS x
    L7_CHAINS x 700 f64 made on the card from a seeded generator, whose ESS
    (in chunks under ``autocorr.CHUNK_BYTES``) must give its known τ."""
    import numpy as np
    import torch

    from mach3_tpu_torch.diagnostics import autocorr

    s = theta.shape[0]
    x2 = theta.reshape(s, -1)
    moving = np.ptp(x2, axis=0) > 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = torch.as_tensor(theta, device=dev)
    ess = autocorr.effective_sample_size(x)
    z = autocorr.geweke(x)
    bm = autocorr.batched_means(x)
    got = [ess.cpu().numpy().reshape(-1), z.cpu().numpy().reshape(-1),
           bm.cpu().numpy().reshape(20, -1)]
    dt = time.perf_counter() - t0
    ref_ess = s / np.maximum(np_tau(x2), 1.0)
    a, b = x2[: int(0.1 * s)], x2[int(0.5 * s):]
    sd = np.sqrt(np.maximum(
        a.var(0, ddof=1) * np_tau(a) / a.shape[0] + b.var(0, ddof=1) * np_tau(b) / b.shape[0],
        1e-30))
    ref_z = (a.mean(0) - b.mean(0)) / sd
    usable = (s // 20) * 20
    batches = x2[:usable].reshape(20, usable // 20, -1)
    ref_bm = batches.mean(1)
    # Each error relative to the size of the terms before a cancellation: a
    # z-score of two nearly equal means, a batch mean of values around 0.
    scales = (ref_ess, (np.abs(a.mean(0)) + np.abs(b.mean(0))) / sd, np.abs(batches).mean(1))
    worst = {}
    for what, g, r, sc in zip(("ESS", "Geweke", "batched means"), got,
                              (ref_ess, ref_z, ref_bm), scales):
        m = moving if g.ndim == 1 else moving[None, :].repeat(20, 0)
        worst[what] = float((np.abs(g - r)[m] / np.maximum(np.abs(r), sc)[m]).max())
        if not worst[what] <= ESS_RTOL:
            raise AssertionError(f"large700:ess: {what} {worst[what]:.3e} from numpy "
                                 f"(> {ESS_RTOL})")
    phase(f"[large700:ess] the adaptive run's chain {tuple(theta.shape)} on the card: ESS, Geweke "
          f"and batched means in {dt:.3f} s (copy to the card included); against numpy f64 within "
          f"{ESS_RTOL} on {int(moving.sum())} moving of {moving.size} columns (largest "
          + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()) + "); ESS per parameter "
          f"(summed over chains) min {float(ess.sum(0).min()):.1f}, median "
          f"{float(ess.sum(0).median()):.1f} | {smi}")
    del x, ess, z, bm

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ar = torch.randn((AR1_STEPS, L7_CHAINS, 700), dtype=torch.float64, device=dev, generator=gen)
    ar[1:] *= math.sqrt(1.0 - AR1_PHI ** 2)
    for t in range(1, AR1_STEPS):
        ar[t].add_(ar[t - 1], alpha=AR1_PHI)
    torch.cuda.synchronize()
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    ess = autocorr.effective_sample_size(ar)
    torch.cuda.synchronize()
    t_ess = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_series = L7_CHAINS * 700
    chunks = -(-n_series // autocorr.series_per_chunk(AR1_STEPS))
    tau = AR1_STEPS / ess
    want = (1 + AR1_PHI) / (1 - AR1_PHI)
    mean_tau = float(tau.mean())
    if not (torch.isfinite(ess).all() and abs(mean_tau / want - 1) < AR1_TAU_RTOL):
        raise AssertionError(f"large700:ess: AR(1) mean tau {mean_tau:.4f}, want {want:.4f} "
                             f"within {AR1_TAU_RTOL}")
    phase(f"[large700:ess] AR(1), phi {AR1_PHI}: {AR1_STEPS} steps x {L7_CHAINS} chains x 700 "
          f"params f64 ({ar.numel() * 8 / 2**30:.2f} GiB) made on the card in {t_gen:.3f} s; ESS "
          f"in {t_ess:.3f} s, {chunks} chunks of <= {autocorr.series_per_chunk(AR1_STEPS)} series "
          f"({n_series / t_ess:.0f} series/s), peak {peak:.2f} GiB; mean tau {mean_tau:.4f} "
          f"(known {want:.4f}, {mean_tau / want - 1:+.5f}), sd over series "
          f"{float(tau.std()):.4f} | {smi}")
    del ar, ess, tau


def post_cli_files(tag: str, chain: str, tmp: str, dev, smi: str, jarlskog: bool) -> None:
    """``mach3-diag-torch`` and ``mach3-process-torch`` (with ``--jarlskog``
    when asked) on ``chain``: exit code 0, the JAX CLIs' npz keys."""
    import os

    import numpy as np

    from mach3_tpu_torch.cli import diag, process

    runs = (("mach3-diag-torch", diag, [], DIAG_KEYS),
            ("mach3-process-torch", process, ["--jarlskog"] if jarlskog else [], PROCESS_KEYS))
    for name, cli, extra, keys in runs:
        out = os.path.join(tmp, f"{name}.npz")
        t0 = time.perf_counter()
        rc = cli.main([chain, *extra, "-o", out, "--device", dev.type])
        dt = time.perf_counter() - t0
        with np.load(out) as f:
            got = set(f.files)
            finite = all(np.isfinite(f[k]).all() for k in f.files if k != "names")
        if rc != 0 or got != keys or not finite:
            raise AssertionError(f"{tag}: {name} exit code {rc}, keys {sorted(got)} (want "
                                 f"{sorted(keys)}), finite {finite}")
        phase(f"[{tag}] {name} {' '.join(extra)}: rc 0 in {dt:.2f} s, {len(got)} arrays | {smi}")


def toy_post_cli(toy, draws: dict, smi: str) -> None:
    """``[toy:post-cli]``: ``[toy:adaptive]``'s draws saved with
    ``save_chain`` beside a second adaptive run's (CLI_SECOND_STEPS steps,
    256 chains); on them ``mach3-diag-torch``, ``mach3-process-torch
    --jarlskog``, ``mach3-rhat-torch`` over both files, ``mach3-combine-torch``
    and ``mach3-predictive-torch`` (CLI_PRED_TOYS toys of the 100,000-event
    toy): each exits 0 and writes the JAX CLI's npz keys."""
    import os
    import tempfile

    import numpy as np
    import torch

    from mach3_tpu_torch.cli import combine, predictive, rhat
    from mach3_tpu_torch.diagnostics.chain_io import load_chain, save_chain
    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
    from mach3_tpu_torch.kernels.launch import LAUNCHES

    model = toy.model
    init = draws["theta"][-1]
    second = MR2T2(model, MCMCConfig(chunk_size=CHUNK, **ADAPTIVE), init, seed=9).run(
        n_steps=CLI_SECOND_STEPS)
    opt = ["--device", model.flat.prefit.device.type]
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "chain.npz"), os.path.join(tmp, "chain_2.npz")
        save_chain(a, draws, toy.names, config_yaml="toy")
        save_chain(b, second, toy.names, config_yaml="toy")
        post_cli_files("toy:post-cli", a, tmp, model.flat.prefit.device, smi, jarlskog=True)
        t0 = time.perf_counter()
        if rhat.main([a, b, "--folded", *opt]) != 0:
            raise AssertionError("toy:post-cli: mach3-rhat-torch failed")
        phase(f"[toy:post-cli] mach3-rhat-torch --folded over both files: rc 0 in "
              f"{time.perf_counter() - t0:.2f} s | {smi}")
        comb = os.path.join(tmp, "combined.npz")
        if combine.main([a, b, "-o", comb, *opt]) != 0:
            raise AssertionError("toy:post-cli: mach3-combine-torch failed")
        dc, _, _ = load_chain(comb)
        want = draws["theta"].shape[0] + CLI_SECOND_STEPS
        if dc.keys() != draws.keys() or dc["theta"].shape[0] != want:
            raise AssertionError(f"toy:post-cli: combined {sorted(dc)} {dc['theta'].shape}")
        phase(f"[toy:post-cli] mach3-combine-torch: rc 0, {dc['theta'].shape} | {smi}")
        out = os.path.join(tmp, "predictive.npz")
        reset_launches()
        t0 = time.perf_counter()
        rc = predictive.main([a, "--toys", str(CLI_PRED_TOYS), "--n-events", str(N_EVENTS),
                              "-o", out, *opt])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        with np.load(out) as f:
            got = set(f.files)
        keys = PRED_KEYS | {p + s.name for p in PRED_SAMPLE_KEYS for s in model.samples}
        launches = dict(LAUNCHES)
        if rc != 0 or got != keys or not launches.get("reweight_shifted"):
            raise AssertionError(f"toy:post-cli: mach3-predictive-torch rc {rc}, keys "
                                 f"{sorted(got ^ keys)} differ, launches {launches}")
        phase(f"[toy:post-cli] mach3-predictive-torch --toys {CLI_PRED_TOYS} --n-events "
              f"{N_EVENTS}: rc 0 in {dt:.1f} s (the toy's build included), {len(got)} arrays; "
              f"kernel launches {launches} | {smi}")


def free_port() -> int:
    """A free TCP port on this machine for a process group's rendezvous."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def roofline_line(tag: str, model, n_chains: int, step_ms: float, smi: str) -> float:
    """The graphed step's share of its roofline floor
    (``diagnostics/roofline.py`` at the H100 SXM's peaks): the memory floor
    over the measured ms/step, which must lie in (0, ROOFLINE_MAX]."""
    from mach3_tpu_torch.diagnostics import roofline

    rep = roofline.report(model, n_chains, step_ms)
    frac = rep["memory_floor_ms"] / step_ms
    phase(f"[{tag}:roofline] {n_chains} chains: {rep['hbm_gbytes_per_step']} GB/step, memory "
          f"floor {rep['memory_floor_ms']} ms, f32 floor {rep['mxu_floor_ms']} ms, combined "
          f"{rep['combined_floor_ms']} ms; f64 transcendentals at one operation each (a lower "
          f"bound, in no floor) {rep['f64_lower_bound_ms']} ms (H100 SXM peaks 3.35 TB/s, "
          f"67 / 34 TFLOP/s f32 / f64) against {step_ms:.3f} ms/step: "
          f"fraction_of_memory_floor {frac:.4f} | {smi}")
    if not 0.0 < frac <= ROOFLINE_MAX:
        raise AssertionError(f"{tag}: fraction_of_memory_floor {frac} outside (0, "
                             f"{ROOFLINE_MAX}]: the byte count is wrong")
    return frac


def sharded_vs_unsharded(tag: str, model, shard, mesh, cfg, init, smi: str) -> None:
    """The sharded sampler (its step's all-reduces captured in the graph)
    against the unsharded MR2T2 from one state and seed, ``DIST_GVE_STEPS``
    steps each as graphs, Robbins-Monro held: the generators end alike; at
    most GVE_MAX_FLIPPED of the chains decide differently, each first where
    its two log α differ by at most GVE_NLL; before the first divergence
    every chain's θ is bit-identical."""
    import dataclasses

    import numpy as np
    import torch

    from mach3_tpu_torch.distributed import chain_state_sharding
    from mach3_tpu_torch.distributed.shard_step import ShardedMR2T2
    from mach3_tpu_torch.fitters.mcmc import MR2T2

    held = dataclasses.replace(cfg, robbins_monro=False)
    plain = MR2T2(model, held, init, seed=DIST_SEED)
    sharded = ShardedMR2T2(mesh, held, shard, chain_state_sharding(mesh, snapshot(plain.state)))
    if model.flat.prefit.device.type == "cuda" and not sharded.graph:
        raise AssertionError(f"{tag}: the sharded sampler does not run as graphs")
    g = sharded.run(n_steps=DIST_GVE_STEPS)
    u = plain.run(n_steps=DIST_GVE_STEPS)
    torch.cuda.synchronize()
    if not torch.equal(sharded.state.generator.get_state(), plain.state.generator.get_state()):
        raise AssertionError(f"{tag}: the generators' states differ after the runs")
    flips = g["accepted"] != u["accepted"]
    diverged = flips.any(0)
    n_chains = diverged.shape[0]
    if diverged.sum() > GVE_MAX_FLIPPED * n_chains:
        raise AssertionError(f"{tag}: {int(diverged.sum())} of {n_chains} chains decided "
                             f"differently")
    gaps = []
    for c in np.flatnonzero(diverged):
        st = np.flatnonzero(flips[:, c])[0]
        gaps.append(abs(np.log(g["acc_prob"][st, c]) - np.log(u["acc_prob"][st, c])))
    if gaps and max(gaps) > GVE_NLL:
        raise AssertionError(f"{tag}: a decision differs where the log α differ by "
                             f"{max(gaps):.3e} > {GVE_NLL}")
    first = int(np.flatnonzero(flips.any(1))[0]) if diverged.any() else DIST_GVE_STEPS
    if not np.array_equal(g["theta"][:first], u["theta"][:first]):
        raise AssertionError(f"{tag}: θ differs before any decision did")
    phase(f"[{tag}:vs-unsharded] {DIST_GVE_STEPS} graph steps x {n_chains} chains, sharded "
          f"(all-reduces in the graph) vs unsharded from one state and seed, Robbins-Monro "
          f"held: generators equal; {int(diverged.sum())} chains decided differently (log α "
          f"gaps {[f'{x:.2e}' for x in gaps]}); θ of every chain bit-identical over the first "
          f"{first} steps; NLLs of the chains that decided alike within "
          f"{np.abs(g['nll'][:, ~diverged] - u['nll'][:, ~diverged]).max():.3e}; acceptance "
          f"sharded {g['accepted'].mean():.4f}, unsharded {u['accepted'].mean():.4f} | {smi}")


def collective_calls(fitter) -> dict:
    """{profiler key: calls per step} of the collectives (keys holding
    ``allreduce``) over 10 steps of an eager sampler: what a graph captures
    and replays."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fitter.run(n_steps=10, collect=False)
    return {e.key: e.count / 10 for e in prof.key_averages() if "allreduce" in e.key.lower()}


def toy_dist(model, thetas, dev, smi: str) -> int:
    """``[toy:dist-1x1]``: one NCCL rank (``multihost.initialise`` with a
    world of 1, its communicator made at once), a 1 x 1 mesh, the toy at
    full width: the sharded NLL against ``total_nll_batch``, the sharded
    sampler against the unsharded one (``sharded_vs_unsharded``), then both
    timed as the production sampler, profiled (NCCL kernels per step, idle
    share) and held against their roofline. Returns K1's launches in the
    timed runs."""
    import torch
    import torch.distributed as dist

    from mach3_tpu_torch.distributed import make_mesh, shard_fit_model
    from mach3_tpu_torch.distributed.mesh import EVENT_AXIS, chain_state_sharding
    from mach3_tpu_torch.distributed.multihost import initialise
    from mach3_tpu_torch.distributed.shard_step import ShardedMR2T2
    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig

    tag = "toy:dist-1x1"
    initialise(f"tcp://localhost:{free_port()}", world_size=1, rank=0, device=dev.type)
    try:
        mesh = make_mesh(1, 1)
        t0 = time.perf_counter()
        shard = shard_fit_model(mesh, model)
        shard_s = time.perf_counter() - t0
        group = mesh.get_group(EVENT_AXIS)
        with torch.no_grad():
            total, _, parts = shard.total_nll_batch_parts(thetas, event_group=group)
            ref_total, _, ref = model.total_nll_batch_parts(thetas)
            tables = model._shared_osc_tables(thetas)
            tols = torch.stack([nll_tolerance(s, *s.reweight_batch(thetas, tables[i]))
                                for i, s in enumerate(model.samples)], dim=1)
        worst = float(((parts - ref).abs() / tols).max())
        rel = float(((total - ref_total).abs() / ref_total.abs()).max())
        phase(f"[{tag}] {dist.get_backend()} world of {dist.get_world_size()}, mesh "
              f"{tuple(mesh.shape)}; shard_fit_model {shard_s:.1f} s (host: the builder's "
              f"order, then each sample laid out and planned again); sharded vs unsharded "
              f"per-sample NLL at {thetas.shape[0]} chains within {worst:.3f} of nll_vs_plain's "
              f"tolerance, total within {rel:.3e} relative | {smi}")
        if worst > 1.0:
            raise AssertionError(f"{tag}: sharded NLL {worst:.2f}x the tolerance")
        cfg = MCMCConfig(chunk_size=CHUNK, **ADAPTIVE)
        init = thetas.cpu().numpy()
        sharded_vs_unsharded(tag, model, shard, mesh, cfg, init, smi)

        names = ["reweight_perchain_kernel", "nccl"]
        out, launches = {}, 0
        for mode in ("unsharded-graph", "sharded-graph"):
            plain = MR2T2(model, cfg, init, seed=DIST_SEED)
            fit = plain if mode == "unsharded-graph" else ShardedMR2T2(
                mesh, cfg, shard, chain_state_sharding(mesh, plain.state))
            r = run_sampler(tag, mode, fit, ADAPTIVE_WARM, ADAPTIVE_STEPS,
                            {"reweight_shifted": 2}, smi, ACC_BAND)
            prof = profile_steps(tag, mode, fit, r["step_ms"], names, smi)
            frac = roofline_line(f"{tag}:{mode}", fit.model, thetas.shape[0], r["step_ms"], smi)
            out[mode] = (r["step_ms"], prof, frac)
            launches += r["launches"]["reweight_shifted"]
            del fit, plain
        eager = ShardedMR2T2(mesh, cfg, shard, chain_state_sharding(
            mesh, MR2T2(model, cfg, init, seed=DIST_SEED).state), graph=False)
        calls = collective_calls(eager)
        del eager
        (u_ms, u_prof, u_frac), (s_ms, s_prof, s_frac) = out["unsharded-graph"], out[
            "sharded-graph"]
        n = thetas.shape[0]
        phase(f"[{tag}:summary] pooled adaptive MR2T2, {n} chains as graphs: sharded "
              f"{s_ms:.3f} ms/step ({1e3 * n / s_ms:.1f} chain-steps/s) vs unsharded "
              f"{u_ms:.3f} ms/step ({1e3 * n / u_ms:.1f} chain-steps/s), {s_ms / u_ms:.3f}x; "
              f"collective calls/step of the eager sharded step {calls}, NCCL device "
              f"ops/step in the graph {s_prof['by_name']['nccl'][0]:.1f} "
              f"({s_prof['by_name']['nccl'][1]:.4f} ms/step); device ops/step sharded "
              f"{s_prof['ops']:.0f} vs {u_prof['ops']:.0f}; idle share sharded "
              f"{1.0 - s_prof['busy'] / s_ms:.3f} vs {1.0 - u_prof['busy'] / u_ms:.3f}; "
              f"fraction_of_memory_floor {s_frac:.4f} vs {u_frac:.4f} | {smi}")
        return launches
    finally:
        dist.destroy_process_group()


def large_dist_rank(rank: int, world: int, port: int, tmp: str, device: str) -> None:
    """One of ``[large:dist-2proc]``'s ranks (a spawned process; gloo, both
    on card 0): the large fixture from the parent's file on a 1 x 2 mesh,
    its NLLs against the parent's unsharded ones, DIST_LARGE_STEPS eager
    steps with their launches; then a 2 x 1 mesh, DIST_FILE_STEPS pooled
    adaptive steps, this row's chain file; rank 0 merges them and takes
    R-hat. Writes its figures to ``<tmp>/rank<r>.npz``; a failed gate
    raises (the process exits non-zero)."""
    import os

    import numpy as np
    import torch
    import torch.distributed as dist

    from mach3_tpu_torch.core.fixture_cache import load_fixture
    from mach3_tpu_torch.core.precision import disable_tf32
    from mach3_tpu_torch.diagnostics.chain_io import load_chain
    from mach3_tpu_torch.diagnostics.rhat import split_rhat
    from mach3_tpu_torch.distributed import chain_state_sharding, make_mesh, shard_fit_model
    from mach3_tpu_torch.distributed.mesh import sharded_total_nll
    from mach3_tpu_torch.distributed.multihost import (
        initialise,
        merge_host_shards,
        save_host_shard,
    )
    from mach3_tpu_torch.distributed.shard_step import ShardedMR2T2
    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
    from mach3_tpu_torch.kernels.launch import LAUNCHES

    disable_tf32()
    os.environ["LOCAL_RANK"] = "0"  # both ranks on card 0
    initialise(f"tcp://localhost:{port}", world_size=world, rank=rank, device=device,
               backend="gloo")
    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    res = {}
    inp = np.load(os.path.join(tmp, "inputs.npz"))
    model = load_fixture(os.path.join(tmp, "large.pt"), device=dev)
    thetas = torch.as_tensor(inp["thetas"], device=dev)

    mesh = make_mesh(1, 2)
    t0 = time.perf_counter()
    shard = shard_fit_model(mesh, model)
    res["shard_s"] = time.perf_counter() - t0
    res["events"] = [int((~s.event_pad).sum()) for s in shard.samples]
    res["routes"] = [s.kernel_route.variant for s in shard.samples]
    with torch.no_grad():
        nll = sharded_total_nll(mesh, shard, thetas)
    ratio = ((nll.cpu().numpy() - inp["nll"]) / inp["tol"])
    res["nll_worst"] = float(np.abs(ratio).max())
    if res["nll_worst"] > 1.0:
        raise AssertionError(f"rank {rank}: sharded NLL {res['nll_worst']:.2f}x the tolerance")
    cfg = MCMCConfig(chunk_size=DIST_LARGE_STEPS, **DIST_LARGE_ADAPTIVE)
    state = chain_state_sharding(
        mesh, MR2T2(model, cfg, inp["thetas"], seed=LARGE_SEED, graph=False).state, model=shard)
    fit = ShardedMR2T2(mesh, cfg, shard, state, graph=False)
    fit.run(n_steps=2, collect=False)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    reset_launches()
    t0 = time.perf_counter()
    out = fit.run(n_steps=DIST_LARGE_STEPS)
    sync()
    res["step_ms"] = 1e3 * (time.perf_counter() - t0) / DIST_LARGE_STEPS
    res["launches"] = dict(LAUNCHES)
    check_launches(f"large:dist-2proc rank {rank}", res["launches"],
                   {"reweight_shared": 2 * DIST_LARGE_STEPS,
                    "reweight_shifted": DIST_LARGE_STEPS, "osc_layered": DIST_LARGE_STEPS})
    with torch.no_grad():
        anew = sharded_total_nll(mesh, shard, fit.state.theta)
    res["state_vs_anew"] = float((fit.state.nll - anew).abs().max())
    if res["state_vs_anew"] > GVE_NLL or not np.isfinite(out["nll"]).all():
        raise AssertionError(f"rank {rank}: the state's NLL is {res['state_vs_anew']:.3e} from "
                             f"its θ's NLL anew")
    res["acc"] = float(out["accepted"].mean())
    if res["acc"] < DIST_ACC_MIN:
        raise AssertionError(f"rank {rank}: acceptance {res['acc']:.4f} below {DIST_ACC_MIN}: "
                             f"the state-vs-anew check saw few accepted moves")
    del fit, shard, state

    # 2 x 1: each row half of the chains; an events axis of 1 holds the whole
    # model, which shard_fit_model would only lay out again.
    mesh = make_mesh(2, 1)
    cfg = MCMCConfig(chunk_size=DIST_FILE_STEPS, **DIST_FILE_ADAPTIVE)
    state = chain_state_sharding(
        mesh, MR2T2(model, cfg, inp["thetas"], seed=LARGE_SEED + 1, graph=False).state)
    fit = ShardedMR2T2(mesh, cfg, model, state, graph=False)
    reset_launches()
    t0 = time.perf_counter()
    out = fit.run(n_steps=DIST_FILE_STEPS)
    sync()
    res["file_step_ms"] = 1e3 * (time.perf_counter() - t0) / DIST_FILE_STEPS
    res["file_launches"] = dict(LAUNCHES)
    res["file_acc"] = float(out["accepted"].mean())
    names = [str(n) for n in inp["names"]]
    path = save_host_shard(os.path.join(tmp, "chain{host}.npz"),
                           {k: out[k] for k in ("theta", "nll", "accepted")}, names, "large",
                           mesh=mesh)
    res["wrote"] = path
    dist.barrier()
    if rank == 0:
        merged = os.path.join(tmp, "merged.npz")
        merge_host_shards([os.path.join(tmp, f"chain{h}.npz") for h in range(2)], merged)
        draws, meta, _ = load_chain(merged)
        rhat = np.asarray(split_rhat(draws["theta"]))
        free = np.isfinite(rhat)
        res["merged_shape"] = list(draws["theta"].shape)
        res["rhat"] = (float(np.nanmedian(rhat)), float(np.nanmax(rhat)), int(free.sum()))
        if draws["theta"].shape[:2] != (DIST_FILE_STEPS, thetas.shape[0]) or not free.any():
            raise AssertionError(f"merged chain {draws['theta'].shape}, R-hat {rhat}")
        res["merged_hosts"] = meta["merged_hosts"]
    dist.barrier()
    dist.destroy_process_group()
    np.save(os.path.join(tmp, f"rank{rank}.npy"), res, allow_pickle=True)


def large_dist(model, thetas, names, dev, smi: str) -> dict:
    """``[large:dist-2proc]``: the parent writes the large fixture
    (``core/fixture_cache.save_fixture``), its chains and their unsharded
    NLLs with nll_vs_plain's tolerance, then spawns two ranks
    (``large_dist_rank``) and reads their figures. Gloo stages the
    collectives through the host, so the times are written down, not
    gated. Returns K2's, K3's and the layered oscillation kernel's launches
    in the ranks' timed runs."""
    import multiprocessing as mp
    import os
    import tempfile

    import numpy as np
    import torch

    from mach3_tpu_torch.core.fixture_cache import save_fixture

    tag = "large:dist-2proc"
    with tempfile.TemporaryDirectory(prefix="dist2proc-") as tmp:
        t0 = time.perf_counter()
        save_fixture(os.path.join(tmp, "large.pt"), model)
        with torch.no_grad():
            nll = model.total_nll_batch(thetas)
            tables = model._shared_osc_tables(thetas)
            tol = sum(nll_tolerance(s, *s.reweight_batch(thetas, tables[i]))
                      for i, s in enumerate(model.samples))
        np.savez(os.path.join(tmp, "inputs.npz"), thetas=thetas.cpu().numpy(),
                 nll=nll.cpu().numpy(), tol=tol.cpu().numpy(), names=np.asarray(names))
        save_s = time.perf_counter() - t0
        ctx = mp.get_context("spawn")
        port = free_port()
        procs = [ctx.Process(target=large_dist_rank, args=(r, 2, port, tmp, dev.type))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=max(1.0, DIST_TIMEOUT - (time.perf_counter() - t0)))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        wall = time.perf_counter() - t0
        codes = [p.exitcode for p in procs]
        if codes != [0, 0]:
            raise AssertionError(f"{tag}: rank exit codes {codes}")
        res = [np.load(os.path.join(tmp, f"rank{r}.npy"), allow_pickle=True).item()
               for r in range(2)]
    for r, x in enumerate(res):
        phase(f"[{tag}] rank {r} of 2 (gloo on the card's tensors, card {dev}): mesh "
              f"(1, 2) shard {x['shard_s']:.1f} s, events {x['events']}, routes {x['routes']}; "
              f"NLL at {thetas.shape[0]} chains within {x['nll_worst']:.3f} of the unsharded "
              f"NLL's tolerance; {DIST_LARGE_STEPS} eager steps {x['step_ms']:.3f} ms/step, "
              f"launches {x['launches']}, acceptance {x['acc']:.4f} (at least {DIST_ACC_MIN}), "
              f"state NLL vs anew "
              f"{x['state_vs_anew']:.3e}; mesh (2, 1) {DIST_FILE_STEPS} pooled adaptive steps "
              f"{x['file_step_ms']:.3f} ms/step, launches {x['file_launches']}, acceptance "
              f"{x['file_acc']:.4f}, wrote "
              f"{os.path.basename(x['wrote']) if x['wrote'] else None} | {smi}")
    m = res[0]
    phase(f"[{tag}:merge] merge_host_shards of {m['merged_hosts']} rows: theta "
          f"{m['merged_shape']}, split R-hat median {m['rhat'][0]:.4f}, max {m['rhat'][1]:.4f} "
          f"over {m['rhat'][2]} free parameters ({DIST_FILE_STEPS} steps: not converged, a "
          f"check that the merged file reads); fixture written in {save_s:.1f} s; two ranks "
          f"{wall:.1f} s wall, start-up included | {smi}")
    return {k: sum(x["launches"].get(k, 0) + x["file_launches"].get(k, 0) for x in res)
            for k in ("reweight_shared", "reweight_shifted", "osc_layered")}


# The gathers' backward (csrc/gather_backward.cu via samples/gather.py) on
# the reference-scale fixture's two beam samples at beam1det's event counts
# (the port's own builder, tutorial/large.py, whose default draws select
# 190,828 numu and 60,000 nue events; 43 splines; its atmospheric sample
# left out), 128 chains. First
# one gradient of log_posterior_batch through autograd, with the launch
# counts set to 0 before it: 4 kernel launches, 0 by index_add. Then each
# gather's backward as the autograd function runs it (norm_product_backward
# / event_gather_backward, the wrapper's choice included) against the plain
# version in f64 on the card (a slot's error over Σ|terms| of that slot, as
# tests/test_torch_gather_cuda.py), timed beside its bound, its plain
# version (f32: the other factors' product and index_add) and the library's
# form before the kernel (index_add and, for the norm product, the product's
# former backward before it).
GATHER_SPLINES = 43
GATHER_CHAINS = 128
GATHER_REPS = 50
GATHER_TOL = 1e-5
GATHER_SEED = 2200000101


def graph_ms(fn, reps: int) -> float:
    """Device ms per call of ``fn``: ``reps`` calls captured in one CUDA
    graph (after two on a side stream), one replay timed with CUDA events,
    so that no host time of the calls enters."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _former_norm_backward(g, x, out, idx, n_slots):
    """The norm product's backward as the port ran it before the kernel:
    from the saved gathered factors x [C, E, W] and product out, the other
    factors' product from running products (elementwise ops and a stack),
    a where on zero factors, g·out/x, then index_add into the table."""
    import torch

    xs = x.unbind(-1)
    before = [torch.ones_like(xs[0])]
    for f in xs[:-1]:
        before.append(before[-1] * f)
    after = [torch.ones_like(xs[0])]
    for f in xs[:0:-1]:
        after.append(after[-1] * f)
    others = torch.stack([b * a for b, a in zip(before, after[::-1])], -1)
    gu = g.unsqueeze(-1)
    gx = torch.where(x == 0, gu * others, gu * (out.unsqueeze(-1) / x))
    return torch.zeros(g.shape[0], n_slots, device=g.device).index_add_(
        1, idx.reshape(-1), gx.reshape(g.shape[0], -1))


def gather_kernel_times(dev, smi: str) -> dict:
    """[gather:*] The gathers' backward kernel on beam1det's shapes (see
    GATHER_SPLINES): the main path's launches, then per gather the error,
    kernel ms (launch and the partials' sum, as the backward runs it;
    device time of graph replays, as the sampler runs it, since the
    wrapper's host time exceeds the kernel's), bound (bytes: the cotangent,
    the index, the table and the result once, over 3.35 TB/s; operations
    over 67 TFLOP/s), the plain version's and the library's ms. Returns the
    kernel table's row, ms and bounds summed over the four."""
    import torch

    from mach3_tpu_torch.core.device import take
    from mach3_tpu_torch.fitters.model import FitModel
    from mach3_tpu_torch.samples import gather as gm
    from mach3_tpu_torch.kernels.launch import LAUNCHES
    from mach3_tpu_torch.tutorial.large import build_large

    t0 = time.perf_counter()
    exp = build_large(n_atmo=2_000, n_splines=GATHER_SPLINES, low_memory=True, device="cpu")
    model = FitModel.build([exp.xsec, exp.osc], exp.samples[:2]).to(dev)
    c = GATHER_CHAINS
    gen = torch.Generator(device=dev).manual_seed(GATHER_SEED)
    theta = model.prefit_vector().to(dev).expand(c, -1).clone()
    theta = (theta + 1e-3 * torch.randn(theta.shape, dtype=theta.dtype, device=dev,
                                        generator=gen)).requires_grad_(True)
    model.log_posterior_batch(theta)  # builds the kernels
    reset_launches()
    (grad,) = torch.autograd.grad(model.log_posterior_batch(theta).sum(), theta)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    if (launches["gather_backward"] != 4 or launches["gather_backward_fallback"] != 0
            or not bool(torch.isfinite(grad).all())):
        raise AssertionError(f"gather:launches: one gradient at {c} chains launched "
                             f"{launches['gather_backward']} gathers' kernels and "
                             f"{launches['gather_backward_fallback']} fallbacks, not 4 and 0, "
                             f"or a gradient is not finite")
    shapes = [(s.name, s.n_events, s.norm_idx.shape[1], s.norm_applied.numel() + 1,
               s.osc.chan_alpha.numel() * s.osc.e_grid.numel()) for s in model.samples]
    phase(f"[gather:launches] {shapes} (name, E, W, norm slots, oscillation slots), built in "
          f"{time.perf_counter() - t0:.1f} s: one gradient at {c} chains, "
          f"{launches['gather_backward']} launches, {launches['gather_backward_fallback']} "
          f"fallbacks | {smi}")
    row = dict(launches=launches["gather_backward"], ms=0.0, plain_ms=0.0, library_ms=0.0,
               bound_ms=0.0, bound_by="bytes", max_abs_err=0.0)
    with torch.no_grad():
        for s in model.samples:
            e = s.n_events
            n_norm = s.norm_applied.numel() + 1
            ext = 1.0 + 0.2 * torch.randn(c, n_norm, device=dev, generator=gen)
            ext[:, -1] = 1.0
            n_osc = s.osc.chan_alpha.numel() * s.osc.e_grid.numel()
            table = torch.rand(c, n_osc, device=dev, generator=gen)
            g = torch.randn(c, e, device=dev, generator=gen)
            w = s.norm_idx.shape[1]
            x = take(ext, 1, s.norm_idx)
            out = x.prod(-1)
            osc_shape = (c, n_osc)
            cases = {
                "norm": (w, n_norm, s.norm_idx,
                         lambda: gm.norm_product_backward(g, ext, s.norm_idx),
                         lambda: gm.norm_product_backward_ref(g, ext, s.norm_idx),
                         lambda: _former_norm_backward(g, x, out, s.norm_idx, n_norm),
                         lambda gg, xx: gm.norm_product_backward_ref(gg, xx, s.norm_idx),
                         ext),
                "osc": (1, n_osc, s.osc.flat_idx,
                        lambda: gm.event_gather_backward(g, osc_shape, torch.float32,
                                                         s.osc.flat_idx),
                        lambda: gm.event_gather_backward_ref(g, osc_shape, torch.float32,
                                                             s.osc.flat_idx),
                        lambda: gm.event_gather_backward_ref(g, osc_shape, torch.float32,
                                                             s.osc.flat_idx),
                        lambda gg, xx: gm.event_gather_backward_ref(gg, osc_shape, gg.dtype,
                                                                    s.osc.flat_idx),
                        table),
            }
            for kind, (width, n_slots, idx, kern, plain, library, ref, tab) in cases.items():
                before = dict(LAUNCHES)
                got = kern()
                again = kern()
                if (LAUNCHES["gather_backward"] - before["gather_backward"] != 2
                        or LAUNCHES["gather_backward_fallback"]
                        != before["gather_backward_fallback"]):
                    raise AssertionError(f"gather:{s.name}:{kind}: the wrapper did not launch "
                                         f"the kernel")
                want = ref(g.double(), tab.double())
                scale = ref(g.double().abs(), tab.double().abs())
                err = float(((got.double() - want).abs() / scale.clamp_min(1e-300)).max())
                err_plain = float(((plain().double() - want).abs()
                                   / scale.clamp_min(1e-300)).max())
                if err > GATHER_TOL or not torch.equal(got, again):
                    raise AssertionError(f"gather:{s.name}:{kind}: error {err:.3e} > "
                                         f"{GATHER_TOL} or a second call differs")
                ms = graph_ms(kern, GATHER_REPS)
                plain_ms = graph_ms(plain, GATHER_REPS)
                library_ms = graph_ms(library, GATHER_REPS)
                chains, events = gm.kernel_blocking(n_slots, kind == "norm")
                nbytes = (4 * c * e + 8 * e * width
                          + 4 * c * n_slots * (2 if kind == "norm" else 1))
                flops = c * e * (4 * width if kind == "norm" else 1)
                bound_ms = 1e3 * max(nbytes / 3.35e12, flops / 67e12)
                phase(f"[gather:kernel-time] {s.name} {kind} (C={c} E={e} W={width} "
                      f"S={n_slots}, {chains} chains x {events} events a block): kernel "
                      f"{ms:.4f} ms, bound {bound_ms:.4f} ms ({100 * bound_ms / ms:.1f}% of "
                      f"it), plain {plain_ms:.4f} ms, library {library_ms:.4f} ms; error / "
                      f"Σ|terms| kernel {err:.2e}, plain {err_plain:.2e}; bit-identical "
                      f"twice | {smi}")
                row["ms"] += ms
                row["plain_ms"] += plain_ms
                row["library_ms"] += library_ms
                row["bound_ms"] += bound_ms
                row["max_abs_err"] = max(row["max_abs_err"], err)
    phase(f"[gather:kernel-time] all four: kernel {row['ms']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
          f"{row['library_ms']:.4f} ms; {row['launches']} launches a gradient | {smi}")
    return row


# The layered-PREM oscillation kernel (csrc/osc_layered.cu via
# osc/layered.py) at large700's atmospheric grid: 20 zeniths from 15 km (up
# to 10 layers a path), 50 energies, 512 chains (the benchmark cell's), the
# oscillation parameters drawn about the fixture's prefit point (sin²θ23 and
# δCP uniform). One prob_grids call through the kernel (one launch, no
# fallback), the largest |P - P_plain| against the plain path on the card,
# then the kernel's and the plain path's device ms (graph replays, CUDA
# events) beside the bound: the two grids written once over 3.35 TB/s, or
# the benchmark's operations (216 a 3x3 complex product, ceil(n/2) products a
# path of n layers) over 67 TFLOP/s.
OSC_CHAINS = 512
OSC_ENERGIES = (0.5, 100.0, 50)
OSC_ZENITHS = (-0.99, 0.99, 20)
OSC_REPS = 50
OSC_PLAIN_REPS = 5
OSC_TOL = 2e-5
OSC_SEED = 2200000121


def osc_layered_kernel_times(dev, smi: str) -> dict:
    """[osc-layered:*] The layered oscillation kernel at large700's grid
    (see OSC_CHAINS): one call's launches, the largest |P - P_plain|, kernel
    and plain ms and the bound. Returns the kernel table's row but for its
    launches, which the main paths count."""
    import numpy as np
    import torch

    from mach3_tpu_torch.osc import layered
    from mach3_tpu_torch.osc.prob import OscParams, probabilities_layered
    from mach3_tpu_torch.samples.events import EventData, build_atmo_osc_config
    from mach3_tpu_torch.kernels.launch import LAUNCHES

    n = 4
    ev = EventData(kinematics={"e_true": np.full(n, 5.0), "cos_zenith": np.full(n, -0.5)},
                   mode=np.zeros(n, np.int32), target=np.full(n, 12, np.int32),
                   pdg=np.full(n, 14, np.int32), preosc_pdg=np.full(n, 14, np.int32),
                   mc_weight=np.ones(n))
    cfg = build_atmo_osc_config(ev, np.geomspace(*OSC_ENERGIES), np.linspace(*OSC_ZENITHS),
                                list(range(6))).to(dev)
    rng = np.random.default_rng(OSC_SEED)
    c = OSC_CHAINS
    theta = torch.as_tensor(np.stack([
        0.307 + 0.013 * rng.normal(size=c), 0.0220 + 0.0007 * rng.normal(size=c),
        rng.uniform(0.4, 0.62, c), rng.uniform(-np.pi, np.pi, c),
        7.53e-5 + 1.8e-6 * rng.normal(size=c), 2.494e-3 + 3e-5 * rng.normal(size=c)], 1),
        device=dev)
    pars = OscParams.from_array(theta)
    paths = (cfg.e_grid, cfg.layer_lengths, cfg.rho_idx, cfg.rho_unique)

    def plain():
        return torch.stack([probabilities_layered(
            pars, cfg.e_grid, cfg.layer_lengths, cfg.layer_rho, antineutrino=anti,
            dtype=cfg.dtype, rho_unique=cfg.rho_unique, rho_idx=cfg.rho_idx,
            z_groups=cfg.z_groups, z_order=cfg.z_order, z_inverse=cfg.z_inverse)
            for anti in (False, True)])

    with torch.no_grad():
        before = dict(LAUNCHES)
        got = torch.stack(cfg.prob_grids(theta))
        seen = {k: LAUNCHES[k] - before[k] for k in ("osc_layered",
                                                              "osc_layered_fallback")}
        err = float((got - plain()).abs().max())
        again = torch.stack(cfg.prob_grids(theta))
        torch.cuda.synchronize()
        if seen != {"osc_layered": 1, "osc_layered_fallback": 0} or err > OSC_TOL \
                or not torch.equal(got, again):
            raise AssertionError(f"osc-layered: launches {seen}, max |P - P_plain| {err:.3e} "
                                 f"(tolerance {OSC_TOL}), or a second call differs")
        ms = graph_ms(lambda: layered.layered_grids(pars, *paths), OSC_REPS)
        plain_ms = graph_ms(plain, OSC_PLAIN_REPS)
    layers = (cfg.layer_lengths > 0).sum(-1).cpu().numpy()
    n_e = cfg.e_grid.numel()
    nbytes = got.numel() * 4
    flops = 2 * c * n_e * 216 * int(((layers + 1) // 2).sum())
    bnd = bound(nbytes, flops)
    phase(f"[osc-layered:kernel-time] C={c} NZ={layers.shape[-1]} NE={n_e} paths of "
          f"{sorted(set(layers.ravel().tolist()))} layers: kernel {ms:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']}; {100 * bnd['bound_ms'] / ms:.1f}% of "
          f"it), plain {plain_ms:.4f} ms "
          f"({plain_ms / ms:.1f}x); max |P - P_plain| {err:.3e}; launches {seen}; "
          f"bit-identical twice | {smi}")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, max_abs_err=err, **bnd)


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
              + " | ".join(res))

    if sys.argv[1:] == ["--kernel-times"]:
        toy_path(dev, smi, quick=True)
        large_grad_kernels(large_path(dev, smi, quick=True)[1], dev, smi)
        gather_kernel_times(dev, smi)
        osc_layered_kernel_times(dev, smi)
        print(smi)
        return 0
    if sys.argv[1:]:
        raise SystemExit(f"chip_smoke: unknown arguments {sys.argv[1:]} (only --kernel-times)")

    results = toy_path(dev, smi)
    toy_grads = results.pop("grad")
    octant_path(dev, smi)
    results.update(exp_path(dev, smi))
    exp_grads = results.pop("grad")
    exp_sparse(dev, smi)
    exp_cli(dev, smi)
    exp_cli_pt(dev, smi)
    large_results, model = large_path(dev, smi)
    results.update(large_results)
    grads, chees = large_grad_path(model, dev, smi)
    results["K4b"]["launches"] = chees["reweight_shared"]
    every = {**toy_grads, **exp_grads, **grads}
    k6 = dict(launches=chees["reweight_backward"], ms=sum(v[2] for v in grads.values()),
              plain_ms=sum(v[3] for v in grads.values()), **summed([v[4] for v in grads.values()]))
    results["K6a"] = dict(k6, max_abs_err=max(v[0] for v in every.values()))  # ḡ_base
    results["K6b"] = dict(k6, max_abs_err=max(v[1] for v in every.values()))  # ḡ_t
    del model
    torch.cuda.empty_cache()
    gather = gather_kernel_times(dev, smi)
    osc = osc_layered_kernel_times(dev, smi)
    torch.cuda.empty_cache()
    l7_pred = large700_path(dev, smi)
    results["K2"]["launches"] += l7_pred["reweight_shared"]
    results["K3"]["launches"] += l7_pred["reweight_shifted"]
    osc["launches"] = results.pop("osc_layered") + l7_pred["osc_layered"]

    print(json.dumps({"kernels": [
        {"name": NAMES.get(k, SOURCES[k]), "route": "cuda",
         "source": f"mach3_tpu_torch/csrc/{SOURCES[k]}.cu", "replaces": TPU_KERNELS[k],
         "library_ms": None, **{f: v for f, v in results[k].items() if f != "responses"}}
        for k in TPU_KERNELS
    ] + [{"name": "gather_backward", "route": "cuda",
          "source": "mach3_tpu_torch/csrc/gather_backward.cu", "replaces": None, **gather},
        {"name": "osc_layered", "route": "cuda", "source": "mach3_tpu_torch/csrc/osc_layered.cu",
         "replaces": None, **osc}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
