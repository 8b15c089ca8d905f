"""Particle swarm optimisation over the χ² surface (port of
``mach3_tpu/fitters/pso.py``; ``Fitters/PSO.cpp``, ``PSO.h:17-69``).

The swarm is a few [N, P] tensors with the particles on the chain axis:
every iteration evaluates all particles' χ² (``minimize.chi2_batch``, each
sample on its kernel route) as one batch, and the personal and global bests,
the ``argmin`` and the global-best gather included, stay on the device. On
the card the iterations replay one iteration captured as a CUDA graph
(``mcmc.GraphChunk``); ``graph=False`` runs them eagerly, as the CPU does.
Particles are clipped to the bounds, and the χ² has no out-of-bounds
sentinel.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.precision import ATYPE
from .mcmc import ChunkedSampler
from .minimize import chi2_batch
from .model import FitModel

_log = get_logger("pso")


@dataclasses.dataclass(frozen=True)
class PSOConfig:
    n_particles: int = 64
    n_iterations: int = 500
    inertia: float = 0.72
    cognitive: float = 1.49  # c1: pull to the personal best
    social: float = 1.49  # c2: pull to the global best
    init_spread: float = 1.0  # initial scatter in prior sigmas
    chunk_size: int = 100  # iterations a chunk (the host reads the history per chunk)


@dataclasses.dataclass
class PSOResult:
    x: np.ndarray
    chi2: float
    history: np.ndarray  # [iters] best χ² after each iteration
    n_evaluations: int  # χ² evaluations (particles x (iterations + 1))
    initial_chi2: float  # the best χ² of the initial scatter


@dataclasses.dataclass
class PSOState:
    x: torch.Tensor  # [N, P]
    v: torch.Tensor  # [N, P]
    pbest_x: torch.Tensor  # [N, P]
    pbest_f: torch.Tensor  # [N]
    gbest_x: torch.Tensor  # [P]
    gbest_f: torch.Tensor  # 0-d
    generator: torch.Generator
    step: torch.Tensor  # 0-d int32


def _gather(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d device index, without a host read."""
    return x.index_select(0, i.view(1))[0]


def make_pso_step_fn(config: PSOConfig, lo: torch.Tensor, hi: torch.Tensor):
    """One iteration ``step(model, state, r1=None, r2=None)``; ``r1``, ``r2``
    [N, P] inject the uniforms of the cognitive and social pulls."""

    def step_fn(model: FitModel, state: PSOState, r1=None, r2=None):
        x, v, gen = state.x, state.v, state.generator
        if r1 is None:
            r1 = torch.rand(x.shape, generator=gen, dtype=ATYPE, device=x.device)
        if r2 is None:
            r2 = torch.rand(x.shape, generator=gen, dtype=ATYPE, device=x.device)
        v = (config.inertia * v + config.cognitive * r1 * (state.pbest_x - x)
             + config.social * r2 * (state.gbest_x[None, :] - x))
        x = torch.clamp(x + v, lo, hi)
        f = chi2_batch(model, x)
        better = f < state.pbest_f
        pbest_x = torch.where(better[:, None], x, state.pbest_x)
        pbest_f = torch.where(better, f, state.pbest_f)
        i_best = torch.argmin(pbest_f)
        gbest_f = _gather(pbest_f, i_best)
        new = PSOState(x=x, v=v, pbest_x=pbest_x, pbest_f=pbest_f,
                       gbest_x=_gather(pbest_x, i_best), gbest_f=gbest_f, generator=gen,
                       step=state.step + 1)
        return new, {"gbest_f": gbest_f}

    return step_fn


class _Swarm(ChunkedSampler):
    """The iterations as the samplers' chunk loop (graphs on the card)."""

    def __init__(self, model: FitModel, config: PSOConfig, state: PSOState, lo, hi,
                 graph: bool | None):
        self.model = model
        self.config = config
        self.graph = self._use_graph(graph)
        self.state = state
        self._step = make_pso_step_fn(config, lo, hi)


def run_pso(model: FitModel, config: PSOConfig = PSOConfig(), seed: int = 0,
            graph: bool | None = None, draws: dict | None = None) -> PSOResult:
    """Minimise χ² from a swarm scattered about the prefit point by
    ``init_spread`` prior sigmas (clipped into the bounds), with initial
    velocities of 0.1 sigma. ``draws`` injects the normals of the scatter
    (``x0`` [N, P]) and of the velocities (``v0``), and the pulls' uniforms
    (``r1``, ``r2`` [iterations, N, P]); the iterations then run eagerly."""
    flat = model.flat
    dev = flat.prefit.device
    lo, hi = flat.low_bound, flat.up_bound
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    sigma = torch.sqrt(torch.diag(flat.chol @ flat.chol.T))
    n, p = config.n_particles, model.n_params
    draws = draws or {}
    x_n = draws.get("x0")
    if x_n is None:
        x_n = torch.randn((n, p), generator=gen, dtype=ATYPE, device=dev)
    v_n = draws.get("v0")
    if v_n is None:
        v_n = torch.randn((n, p), generator=gen, dtype=ATYPE, device=dev)
    x0 = torch.clamp(flat.prefit[None, :] + config.init_spread * sigma[None, :] * x_n, lo, hi)
    v0 = 0.1 * sigma[None, :] * v_n
    with torch.no_grad():
        f0 = chi2_batch(model, x0)
    initial_chi2 = float(f0.min())  # read now: a captured iteration writes f0 in place
    i0 = torch.argmin(f0)
    # No two fields share a tensor: a captured step writes each in place.
    state = PSOState(x=x0, v=v0, pbest_x=x0.clone(), pbest_f=f0, gbest_x=_gather(x0, i0),
                     gbest_f=_gather(f0, i0), generator=gen,
                     step=torch.zeros((), dtype=torch.int32, device=dev))
    if "r1" in draws:
        step = make_pso_step_fn(config, lo, hi)
        hist = []
        with torch.no_grad():
            for r1, r2 in zip(draws["r1"], draws["r2"]):
                state, out = step(model, state, r1=r1, r2=r2)
                hist.append(float(out["gbest_f"]))
        history = np.asarray(hist)
    elif config.n_iterations > 0:
        swarm = _Swarm(model, config, state, lo, hi, graph)
        history = swarm.run(n_steps=config.n_iterations)["gbest_f"]
        state = swarm.state
    else:
        history = np.zeros(0)
    chi2 = float(state.gbest_f)
    _log.info("PSO: chi2 %.4f after %d iterations", chi2, len(history))
    return PSOResult(x=state.gbest_x.cpu().numpy(), chi2=chi2, history=history,
                     n_evaluations=n * (len(history) + 1), initial_chi2=initial_chi2)
