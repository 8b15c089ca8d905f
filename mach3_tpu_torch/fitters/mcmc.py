"""MR2T2 — Metropolis-Hastings over a chain batch (port of the fixed-proposal
part of ``mach3_tpu/fitters/mcmc.py``; ``Fitters/MR2T2.cpp``,
``Fitters/MCMCBase.cpp``).

One step: correlated proposal, prior + sample -logL of the proposal, the
accept test of ``MR2T2::AcceptanceProbability`` (``MR2T2.cpp:103-115``), and
a masked update. ``MR2T2.run`` drives the steps in chunks (the reference's
tree-fill / auto-save boundary). Random draws come from one
``torch.Generator`` on the chains' device (Philox on the card); tests may
inject them. Adaptive (Haario / Robbins-Monro) proposals wait (ROADMAP).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.precision import ATYPE, LARGE_LOGL
from ..params.state import propose_step_batch
from .model import FitModel

_log = get_logger("mcmc")


@dataclasses.dataclass
class ChainState:
    theta: torch.Tensor  # [C, P] f64
    nll: torch.Tensor  # [C] current -logL (prior + samples)
    generator: torch.Generator
    step: int  # global step counter (host)
    n_accepted: torch.Tensor  # [C] int32


@dataclasses.dataclass(frozen=True)
class MCMCConfig:
    """Static knobs (reference YAML ``General.MCMC``)."""

    n_steps: int = 1000
    chunk_size: int = 100  # steps per chunk; the host sees outputs per chunk
    # Record the proposal's per-handler / per-sample -logL pieces each step.
    record_breakdown: bool = False


def make_step_fn_args(
    config: MCMCConfig,
) -> Callable[..., tuple[ChainState, dict[str, torch.Tensor]]]:
    """The single-step transition ``step(model, state, z=None, flip_u=None,
    u_acc=None)``. ``z [C, K]``, ``flip_u [C, P]`` and ``u_acc [C]`` inject
    the proposal normals, the flip uniforms and the accept uniforms; by
    default they are drawn from ``state.generator``."""

    def step_fn(model: FitModel, state: ChainState, z=None, flip_u=None, u_acc=None):
        n_chains = state.theta.shape[0]
        proposed = propose_step_batch(
            model.flat, state.theta, state.generator, z=z, flip_u=flip_u
        )
        nll_prop, prior_parts, sample_parts = model.total_nll_batch_parts(proposed)

        acc_prob = torch.exp((state.nll - nll_prop).clamp(max=0.0))
        if u_acc is None:
            u_acc = torch.rand(
                (n_chains,), generator=state.generator, dtype=ATYPE, device=state.theta.device
            )
        accept = (nll_prop < LARGE_LOGL) & (u_acc < acc_prob)

        theta = torch.where(accept[:, None], proposed, state.theta)
        nll = torch.where(accept, nll_prop, state.nll)
        new_state = ChainState(
            theta=theta,
            nll=nll,
            generator=state.generator,
            step=state.step + 1,
            n_accepted=state.n_accepted + accept.to(torch.int32),
        )
        outputs = {"theta": theta, "nll": nll, "acc_prob": acc_prob, "accepted": accept}
        if config.record_breakdown:
            outputs["prior_nll_parts"] = prior_parts
            outputs["sample_nll_parts"] = sample_parts
        return new_state, outputs

    return step_fn


class MR2T2:
    """Chunked MCMC runner with host-side chain storage
    (``MCMCBase::RunMCMC``, ``Fitters/MCMCBase.cpp:32-123``). The model and
    ``init_theta`` decide the device; the generator lives there too."""

    def __init__(self, model: FitModel, config: MCMCConfig, init_theta, seed: int = 0):
        self.model = model
        self.config = config
        self._step = make_step_fn_args(config)
        device = model.flat.prefit.device
        theta0 = torch.as_tensor(np.asarray(init_theta), dtype=ATYPE, device=device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        with torch.no_grad():
            nll0 = model.total_nll_batch(theta0)
        n_oob = int((nll0 >= LARGE_LOGL).sum())
        if n_oob:
            # A chain at the sentinel may never repair itself (accept needs
            # an in-bounds proposal; narrow priors make that rare).
            _log.warning(
                "%d/%d initial chains are OUT OF BOUNDS (nll at the LARGE_LOGL "
                "sentinel) — they will likely stay stuck; clip the initial "
                "throws into the parameter bounds", n_oob, theta0.shape[0],
            )
        self.state = ChainState(
            theta=theta0,
            nll=nll0,
            generator=generator,
            step=0,
            n_accepted=torch.zeros(theta0.shape[0], dtype=torch.int32, device=device),
        )

    def run(
        self, n_steps: int | None = None, callback=None, collect: bool = True
    ) -> dict[str, np.ndarray]:
        """Run the chains; returns host arrays theta [S, C, P], nll [S, C],
        acc_prob [S, C], accepted [S, C] and step_time [S] (per-step wall
        seconds, averaged over each chunk).

        callback(done, state, chunk) sees each chunk's host arrays.
        collect=False streams: chunks go to ``callback`` only and run()
        returns {}; with no callback either, no draw leaves the device."""
        n_steps = n_steps or self.config.n_steps
        chunks: list[dict[str, np.ndarray]] = []
        keep = collect or callback is not None
        done = 0
        with torch.no_grad():
            while done < n_steps:
                n = min(self.config.chunk_size, n_steps - done)
                t0 = time.perf_counter()
                outs: list[dict[str, torch.Tensor]] = []
                for _ in range(n):
                    self.state, out = self._step(self.model, self.state)
                    if keep:
                        outs.append(out)
                done += n
                if not keep:
                    continue
                host = {k: torch.stack([o[k] for o in outs]).cpu().numpy() for k in outs[0]}
                host["step_time"] = np.full(n, (time.perf_counter() - t0) / n)
                if collect:
                    chunks.append(host)
                if callback is not None:
                    callback(done, self.state, host)
        if not collect or not chunks:
            return {}
        return {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}

    @property
    def acceptance_rate(self) -> np.ndarray:
        return self.state.n_accepted.cpu().numpy() / max(self.state.step, 1)
