"""Delayed-rejection MR2T2, DRAM-style (port of ``mach3_tpu/fitters/delayed.py``;
``Fitters/DelayedMR2T2.cpp``).

On rejection, retry with the step scale multiplied by ``decay_rate``, up to
``max_rejections`` times; later attempts use the DRAM acceptance ratio
(arXiv:2010.04190)

    alpha_2 = min(1, max(0, e^{Lmin - Lprop} - 1) / (e^{Lmin - Lcurr} - 1))

where ``Lmin`` is the lowest -logL among the proposals rejected so far.
Retries "leapfrog": each proposes from the last rejected point, and on final
rejection the original state is restored. All chains run the whole cascade
in lockstep (chains that already accepted are masked out), so a step
evaluates the likelihood ``max_rejections + 1`` times and launches each
kernel that often.

The reference's ``ProbabilisticDelay`` gates on ``Rndm() > delay_probability``,
which inverts its documented meaning (delay_probability = 1 would never
delay); this module, like the JAX package, delays with probability
``delay_probability``.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.precision import ATYPE, LARGE_LOGL
from ..params.state import propose_step_batch
from .mcmc import (
    MR2T2,
    ChainState,
    MCMCConfig,
    _BlockMasks,
    _update_adaptive,
    adaptive_propose,
)
from .model import FitModel


@dataclasses.dataclass(frozen=True)
class DelayedConfig(MCMCConfig):
    decay_rate: float = 0.1
    max_rejections: int = 1
    initial_scale: float = 1.0
    delay_probability: float = 1.0


def dram_acceptance(nll0: torch.Tensor, min_nll: torch.Tensor,
                    nll_prop: torch.Tensor) -> torch.Tensor:
    """The DRAM second-stage acceptance probability of a retry, guarded as
    the reference guards it: 1 where the best rejected proposal was no worse
    than the current point (the denominator ≤ 0), the standard Metropolis
    probability where either term overflows."""
    standard = torch.exp((nll0 - nll_prop).clamp(max=0.0))
    num = (torch.exp(min_nll - nll_prop) - 1.0).clamp(min=0.0)
    den = torch.exp(min_nll - nll0) - 1.0
    ratio = torch.where(den <= 0.0, 1.0, (num / torch.where(den == 0, 1.0, den)).clamp(max=1.0))
    return torch.where(torch.isinf(num) | torch.isinf(den), standard, ratio)


def make_delayed_step_fn_args(config: DelayedConfig):
    """``step(model, state, draws=None)``. ``draws``, one dict per attempt
    with ``z``, ``flip_u``, ``u`` and (all but the last attempt)
    ``u_delay``, injects the draws; by default they come from
    ``state.generator`` in that order. The throw matrix's refresh follows
    the step (``mcmc.refresh_throw_matrix``)."""
    block_mask = _BlockMasks(config.adaption_blocks)

    def step_fn(model: FitModel, state: ChainState, draws=None):
        n_chains = state.theta.shape[0]
        dev = state.theta.device
        gen = state.generator
        theta0, nll0 = state.theta, state.nll  # restore point on total rejection

        base = state.theta  # proposal origin: leapfrogs through rejections
        accepted = torch.zeros(n_chains, dtype=torch.bool, device=dev)
        theta_acc, nll_acc = theta0, nll0
        min_nll = torch.full((n_chains,), LARGE_LOGL, dtype=ATYPE, device=dev)
        delayed_accept = torch.zeros(n_chains, dtype=torch.bool, device=dev)
        first_acc_prob = None

        scale = config.initial_scale
        for attempt in range(config.max_rejections + 1):
            d = draws[attempt] if draws is not None else {}
            if state.adaptive is not None:
                proposed = adaptive_propose(model.flat, state.adaptive, base, gen,
                                            extra_scale=scale, z=d.get("z"),
                                            flip_u=d.get("flip_u"))
            else:
                proposed = propose_step_batch(model.flat, base, gen, z=d.get("z"),
                                              flip_u=d.get("flip_u"), extra_scale=scale)
            nll_prop = model.total_nll_batch(proposed)
            # The reference's skip: out of bounds, or worse than the best
            # rejected proposal so far.
            skip = (nll_prop >= LARGE_LOGL) | (nll_prop > min_nll)
            if attempt == 0:
                acc_prob = first_acc_prob = torch.exp((nll0 - nll_prop).clamp(max=0.0))
            else:
                acc_prob = dram_acceptance(nll0, min_nll, nll_prop)

            u = d.get("u")
            if u is None:
                u = torch.rand((n_chains,), generator=gen, dtype=ATYPE, device=dev)
            accept_now = ~accepted & ~skip & (u < acc_prob)
            theta_acc = torch.where(accept_now[:, None], proposed, theta_acc)
            nll_acc = torch.where(accept_now, nll_prop, nll_acc)
            if attempt > 0:
                delayed_accept = delayed_accept | accept_now
            accepted = accepted | accept_now

            if attempt < config.max_rejections:
                # Probabilistic delay (documented semantics): chains that stop
                # delaying are frozen as rejected.
                u_delay = d.get("u_delay")
                if u_delay is None:
                    u_delay = torch.rand((n_chains,), generator=gen, dtype=ATYPE, device=dev)
                accepted = accepted | (~accepted & ~(u_delay < config.delay_probability))
            base = torch.where(accepted[:, None], base, proposed)
            min_nll = torch.where(accepted, min_nll, torch.minimum(min_nll, nll_prop))
            scale = scale * config.decay_rate

        step = state.step + 1
        adaptive = state.adaptive
        if adaptive is not None:
            # Moments and scale from the step's outcome, as MR2T2's post-step.
            adaptive = _update_adaptive(adaptive, theta_acc, step, config, first_acc_prob,
                                        block_mask(model))
        moved = (theta_acc != theta0).any(1)
        out_state = ChainState(theta=theta_acc, nll=nll_acc, generator=gen, step=step,
                               n_accepted=state.n_accepted + moved.to(torch.int32),
                               adaptive=adaptive)
        outputs = {"theta": theta_acc, "nll": nll_acc, "acc_prob": first_acc_prob,
                   "accepted": moved, "delayed_accept": delayed_accept}
        return out_state, outputs

    return step_fn


class DelayedMR2T2(MR2T2):
    """The MR2T2 runner (chunks, CUDA graphs, storage) with the delayed step."""

    def __init__(self, model: FitModel, config: DelayedConfig, init_theta, seed: int = 0,
                 graph: bool | None = None):
        super().__init__(model, config, init_theta, seed, graph=graph)
        self._step = make_delayed_step_fn_args(config)
