"""Affine-invariant ensemble sampler, the Goodman & Weare stretch move (port
of ``mach3_tpu/fitters/ensemble.py``).

Walkers propose along directions set by other walkers, so the sampler is
invariant to linear reparameterisation and needs no covariance tuning. The
two half-ensembles update in turn, the second against the first half as it
stands after its update; each half-update is one batched likelihood over
half the walkers. Walker count: even and at least 2·P.

On the card a chunk replays one step captured as a CUDA graph
(``mcmc.GraphChunk``); ``graph=False`` runs the eager loop, as the CPU does.
Draws come from one ``torch.Generator``, per half in the order stretch
uniform, partner uniform, accept uniform; tests may inject them.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core.precision import ATYPE, LARGE_LOGL
from .mcmc import ChunkedSampler
from .model import FitModel


@dataclasses.dataclass(frozen=True)
class EnsembleConfig:
    n_steps: int = 1000
    chunk_size: int = 100
    stretch_a: float = 2.0  # stretch-move scale parameter


@dataclasses.dataclass
class EnsembleState:
    theta: torch.Tensor  # [W, P]
    nll: torch.Tensor  # [W]
    generator: torch.Generator
    step: torch.Tensor  # 0-d int32, on the walkers' device
    n_accepted: torch.Tensor  # [W] int32


def make_ensemble_step_fn(config: EnsembleConfig, n_params: int):
    """``step(model, state, draws=None)`` -> (state, outputs: theta, nll,
    acc_prob = min(1, the stretch move's acceptance ratio), accepted).
    ``draws``, one dict per half with ``u_z`` [W/2] (the uniforms the
    stretch factors z are made from), ``pick`` [W/2] (int, the partner in
    the other half) and ``u`` [W/2] (accept uniforms), injects the draws."""
    a = config.stretch_a
    lo, hi = math.sqrt(1.0 / a), math.sqrt(a)

    def half_update(model, theta_move, nll_move, theta_ref, gen, d):
        m, n_ref = theta_move.shape[0], theta_ref.shape[0]
        dev = theta_move.device
        u_z = d.get("u_z")
        if u_z is None:
            u_z = torch.rand((m,), generator=gen, dtype=ATYPE, device=dev)
        z = (u_z * (hi - lo) + lo) ** 2  # z ~ g(z) ∝ 1/sqrt(z) on [1/a, a]
        pick = d.get("pick")
        if pick is None:
            u_pick = torch.rand((m,), generator=gen, dtype=ATYPE, device=dev)
            pick = (u_pick * n_ref).long().clamp(max=n_ref - 1)
        anchor = theta_ref.index_select(0, pick)
        proposed = anchor + z[:, None] * (theta_move - anchor)
        nll_prop = model.total_nll_batch(proposed)
        log_acc = (n_params - 1.0) * torch.log(z) - (nll_prop - nll_move)
        u = d.get("u")
        if u is None:
            u = torch.rand((m,), generator=gen, dtype=ATYPE, device=dev)
        accept = (torch.log(u) < log_acc) & (nll_prop < LARGE_LOGL)
        return (torch.where(accept[:, None], proposed, theta_move),
                torch.where(accept, nll_prop, nll_move), accept,
                torch.exp(log_acc.clamp(max=0.0)))

    def step_fn(model: FitModel, state: EnsembleState, draws=None):
        half = state.theta.shape[0] // 2
        d0, d1 = draws if draws is not None else ({}, {})
        th, nll, gen = state.theta, state.nll, state.generator
        t0, n0, a0, p0 = half_update(model, th[:half], nll[:half], th[half:], gen, d0)
        t1, n1, a1, p1 = half_update(model, th[half:], nll[half:], t0, gen, d1)
        theta, nll = torch.cat([t0, t1]), torch.cat([n0, n1])
        accept = torch.cat([a0, a1])
        new_state = EnsembleState(theta=theta, nll=nll, generator=gen, step=state.step + 1,
                                  n_accepted=state.n_accepted + accept.to(torch.int32))
        return new_state, {"theta": theta, "nll": nll, "acc_prob": torch.cat([p0, p1]),
                           "accepted": accept}

    return step_fn


class EnsembleSampler(ChunkedSampler):
    """The stretch-move ensemble with MR2T2's surface (``run``, chain files,
    checkpoints). ``init_theta`` [W, P]: W even and at least 2·P."""

    def __init__(self, model: FitModel, config: EnsembleConfig, init_theta, seed: int = 0,
                 graph: bool | None = None):
        init_theta = np.asarray(init_theta)
        n_walkers, n_params = init_theta.shape
        if n_walkers % 2:
            raise ValueError("Walker count must be even")
        if n_walkers < 2 * n_params:
            raise ValueError(f"Need >= {2 * n_params} walkers for {n_params} params")
        self.model = model
        self.config = config
        self.graph = self._use_graph(graph)
        self._step = make_ensemble_step_fn(config, n_params)
        device = model.flat.prefit.device
        theta0 = torch.as_tensor(init_theta, dtype=ATYPE, device=device)
        with torch.no_grad():
            nll0 = model.total_nll_batch(theta0)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        self.state = EnsembleState(
            theta=theta0, nll=nll0, generator=generator,
            step=torch.zeros((), dtype=torch.int32, device=device),
            n_accepted=torch.zeros(n_walkers, dtype=torch.int32, device=device))

    def online_rhat(self, recent: dict[str, np.ndarray]) -> np.ndarray:
        """Split R-hat over the walkers of a chunk's draws."""
        from ..diagnostics.rhat import split_rhat

        return np.asarray(split_rhat(recent["theta"]))
