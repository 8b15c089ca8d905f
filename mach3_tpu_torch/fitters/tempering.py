"""Parallel tempering (replica exchange) over the chain batch axis (port of
``mach3_tpu/fitters/tempering.py``).

Oscillation posteriors are multimodal (the θ23 octant, the mass ordering),
and single-temperature chains mix between modes exponentially slowly; the
reference answers with annealing inside one chain
(``Fitters/MR2T2.cpp:103-115``) and many independent processes. Here
``n_temps`` levels x ``n_walkers`` walkers run as one [T·W, P] batch, level
major (chain c = t·W + w), through the same batched likelihood as MR2T2, so
the reweight kernels see a larger chain batch; the exchange phase is a masked
roll along the level axis with no likelihood evaluation.

Tempering is likelihood-only: level t targets prior(θ)·like(θ)^β_t with
β_0 = 1 (the posterior) and β_t = max_temp^(−t/(T−1)), or with
``beta_zero`` a last level at β = 0 (the bounded prior: the ladder of the
evidence estimators, ``diagnostics/evidence.py``). Adjacent levels swap with
log α = (β_t − β_{t+1})(E_t − E_{t+1}), E the untempered sample −logL, even
and odd pairs in turn. Each level tunes its throw scale by Robbins-Monro.

On the card a chunk replays one step captured as a CUDA graph
(``mcmc.GraphChunk``): the swap step, its parity and Robbins-Monro's γ are
read from the device step counter, so the step has no host branch and no
host read; the counters are read on the host only between chunks.
``graph=False`` runs the eager loop, which is what runs on the CPU. Random
draws come from one ``torch.Generator`` in a fixed order (proposal normals,
flip uniforms, accept uniforms, swap uniforms); tests may inject them.
Posterior draws are the β = 1 level: :meth:`ParallelTempering.cold_chain`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.logging import get_logger
from ..core.precision import ATYPE, LARGE_LOGL
from ..params.state import propose_step_batch
from .mcmc import ChunkedSampler
from .model import FitModel

_log = get_logger("pt")


@dataclasses.dataclass
class PTState:
    theta: torch.Tensor  # [T*W, P] level-major: chain c = t * W + w
    prior_nll: torch.Tensor  # [T*W]
    sample_nll: torch.Tensor  # [T*W] untempered E = -log like (the sentinel when out of bounds)
    generator: torch.Generator
    step: torch.Tensor  # 0-d int32, on the chains' device
    n_accepted: torch.Tensor  # [T*W] int32
    swap_attempts: torch.Tensor  # [T-1] int32
    swap_accepts: torch.Tensor  # [T-1] int32: accepted swaps summed over walkers
    log_scale: torch.Tensor  # [T] per-level Robbins-Monro log throw scale


@dataclasses.dataclass(frozen=True)
class PTConfig:
    """Static knobs for parallel tempering (the JAX package's)."""

    n_steps: int = 1000
    chunk_size: int = 100
    n_temps: int = 8
    #: Hottest temperature; the ladder is geometric, T_t = max_temp^(t/(T-1)).
    max_temp: float = 64.0
    #: Attempt swaps every this many steps (pair parity alternating).
    swap_every: int = 1
    #: Scale level t's throws by T_t^0.5 (its target is flatter by about that).
    scale_throws: bool = True
    #: Robbins-Monro per-level scale towards ``target_accept``.
    robbins_monro: bool = True
    target_accept: float = 0.234
    #: Make the hottest level the prior itself (β = 0): needed for evidence.
    beta_zero: bool = False


def temperature_ladder(n_temps: int, max_temp: float) -> np.ndarray:
    """Geometric ladder [T]: 1 = T_0 < ... < T_{n-1} = max_temp."""
    if n_temps < 2:
        return np.ones(max(n_temps, 1))
    return max_temp ** (np.arange(n_temps) / (n_temps - 1))


def pt_betas(config: PTConfig) -> np.ndarray:
    """Inverse temperatures [n_temps], descending from β_0 = 1; with
    ``beta_zero`` the last is 0 and the geometric part spans the first
    ``n_temps - 1`` levels."""
    if config.beta_zero:
        if config.n_temps < 3:
            raise ValueError("beta_zero needs n_temps >= 3")
        core = 1.0 / temperature_ladder(config.n_temps - 1, config.max_temp)
        return np.concatenate([core, [0.0]])
    return 1.0 / temperature_ladder(config.n_temps, config.max_temp)


class _Ladder:
    """The ladder's device constants, made once per device: a captured step
    must not copy them from the host."""

    def __init__(self, config: PTConfig, n_walkers: int):
        n_t = config.n_temps
        betas = pt_betas(config)
        # Throw scale ~ sqrt(T); the β = 0 level is seeded like the hottest
        # tempered one (Robbins-Monro takes over from there).
        scales = np.sqrt(1.0 / np.maximum(betas, 1.0 / config.max_temp))
        self.host = {
            "betas": betas,
            "beta_c": np.repeat(betas, n_walkers),
            "base_scale": scales if config.scale_throws else np.ones(n_t),
            "pair": np.arange(max(n_t - 1, 1)) % 2,
        }
        self._made: dict = {}

    def __call__(self, device: torch.device) -> dict:
        if device not in self._made:
            self._made[device] = {k: torch.as_tensor(v, device=device)
                                  for k, v in self.host.items()}
        return self._made[device]


def pt_nll_parts(model: FitModel, thetas: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(prior [C], E [C]) of a chain batch, one batched likelihood: the
    prior with its out-of-bounds sentinel, E the samples' -logL summed, or
    ``n_samples * LARGE_LOGL`` where the prior is at the sentinel."""
    _, prior_parts, sample_parts = model.total_nll_batch_parts(thetas)
    prior = prior_parts.sum(1)
    n_s = max(len(model.samples), 1)
    return prior, torch.where(prior >= LARGE_LOGL, n_s * LARGE_LOGL, sample_parts.sum(1))


def make_pt_step_fn_args(config: PTConfig, n_walkers: int):
    """The transition ``step(model, state, z=None, flip_u=None, u_acc=None,
    u_swap=None)``: a tempered Metropolis step of every chain (``z [C, K]``,
    ``flip_u [C, P]`` and ``u_acc [C]`` inject its draws), the per-level
    Robbins-Monro scale, then the replica exchange (``u_swap [T-1, W]``).
    The swap uniforms are drawn every step, swap step or not, so that the
    generator moves alike on every step."""
    n_t = config.n_temps
    ladder = _Ladder(config, n_walkers)

    def step_fn(model: FitModel, state: PTState, z=None, flip_u=None, u_acc=None,
                u_swap=None):
        k = ladder(state.theta.device)
        gen = state.generator
        c = state.theta.shape[0]
        dev = state.theta.device

        # Tempered Metropolis step: one batched likelihood evaluation.
        throw_scale = (k["base_scale"] * torch.exp(state.log_scale))[:, None].expand(
            n_t, n_walkers).reshape(c)
        proposed = propose_step_batch(model.flat, state.theta, gen, z=z, flip_u=flip_u,
                                      scale=throw_scale)
        prior_p, e_p = pt_nll_parts(model, proposed)
        d = (prior_p - state.prior_nll) + k["beta_c"] * (e_p - state.sample_nll)
        acc_prob = torch.exp((-d).clamp(max=0.0))
        if u_acc is None:
            u_acc = torch.rand((c,), generator=gen, dtype=ATYPE, device=dev)
        accept = (e_p < LARGE_LOGL) & (u_acc < acc_prob)
        theta = torch.where(accept[:, None], proposed, state.theta)
        prior_nll = torch.where(accept, prior_p, state.prior_nll)
        sample_nll = torch.where(accept, e_p, state.sample_nll)

        step = state.step + 1
        log_scale = state.log_scale
        if config.robbins_monro:
            acc_level = acc_prob.view(n_t, n_walkers).mean(1)
            gamma = 2.0 / step.to(ATYPE).clamp(min=1.0) ** 0.66
            log_scale = (log_scale + gamma * (acc_level - config.target_accept)).clamp(-8.0, 4.0)

        # Replica exchange: no likelihood evaluation, no host branch.
        swap_attempts, swap_accepts = state.swap_attempts, state.swap_accepts
        if n_t > 1:
            if u_swap is None:
                u_swap = torch.rand((n_t - 1, n_walkers), generator=gen, dtype=ATYPE, device=dev)
            do_swap = (step % config.swap_every) == 0
            parity = (step // config.swap_every) % 2
            th = theta.view(n_t, n_walkers, -1)
            pr = prior_nll.view(n_t, n_walkers)
            en = sample_nll.view(n_t, n_walkers)
            betas = k["betas"]
            log_r = (betas[:-1, None] - betas[1:, None]) * (en[:-1] - en[1:])
            pair_active = (k["pair"] == parity) & do_swap
            acc_s = (torch.log(u_swap) < log_r) & pair_active[:, None]
            # Non-overlapping pairs: row t takes t+1 where acc_s[t], row t+1
            # takes t where acc_s[t].
            pad = torch.zeros((1, n_walkers), dtype=torch.bool, device=dev)
            take_next = torch.cat([acc_s, pad])
            take_prev = torch.cat([pad, acc_s])

            def exchange(a):
                m = take_next.view(take_next.shape + (1,) * (a.dim() - 2))
                p = take_prev.view(m.shape)
                return torch.where(m, torch.roll(a, -1, 0),
                                   torch.where(p, torch.roll(a, 1, 0), a))

            theta = exchange(th).reshape(c, -1)
            prior_nll = exchange(pr).reshape(c)
            sample_nll = exchange(en).reshape(c)
            swap_attempts = swap_attempts + pair_active.to(torch.int32)
            swap_accepts = swap_accepts + acc_s.sum(1, dtype=torch.int32)

        new_state = PTState(
            theta=theta, prior_nll=prior_nll, sample_nll=sample_nll, generator=gen, step=step,
            n_accepted=state.n_accepted + accept.to(torch.int32),
            swap_attempts=swap_attempts, swap_accepts=swap_accepts, log_scale=log_scale)
        outputs = {
            "theta": theta,
            "nll": prior_nll + sample_nll,  # untempered -logL of every level
            # Untempered sample -logL per level: the evidence estimators' input.
            "sample_nll": sample_nll,
            "acc_prob": acc_prob,
            "accepted": accept,
        }
        return new_state, outputs

    return step_fn


class ParallelTempering(ChunkedSampler):
    """Chunked replica-exchange driver with MR2T2's surface (``run``, chain
    files, checkpoints). ``init_theta`` [W, P] is replicated over the
    ladder, or with ``pretiled=True`` a level-major [T·W, P] seed starts
    every level. The model decides the device; ``graph`` as for MR2T2."""

    def __init__(self, model: FitModel, config: PTConfig, init_theta, seed: int = 0,
                 pretiled: bool = False, graph: bool | None = None):
        self.model = model
        self.config = config
        self.graph = self._use_graph(graph)
        init_theta = np.asarray(init_theta)
        n_t = config.n_temps
        if init_theta.ndim != 2:
            raise ValueError("init_theta must be [walkers, P]")
        if pretiled:
            if init_theta.shape[0] % n_t != 0:
                raise ValueError(f"pretiled init needs a multiple of n_temps={n_t} rows")
            self.n_walkers = init_theta.shape[0] // n_t
            tiled = init_theta
        else:
            self.n_walkers = init_theta.shape[0]
            tiled = np.tile(init_theta, (n_t, 1))
        self._step = make_pt_step_fn_args(config, self.n_walkers)

        device = model.flat.prefit.device
        theta0 = torch.as_tensor(tiled, dtype=ATYPE, device=device)
        with torch.no_grad():
            total0, prior_parts, _ = model.total_nll_batch_parts(theta0)
        prior0 = prior_parts.sum(1)
        n_oob = int((total0 >= LARGE_LOGL).sum())
        if n_oob:
            _log.warning(
                "%d/%d initial walkers are OUT OF BOUNDS (LARGE_LOGL sentinel) — they will "
                "likely stay stuck; clip the initial throws into the parameter bounds",
                n_oob, theta0.shape[0])
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        n_pairs = max(n_t - 1, 1)
        self.state = PTState(
            theta=theta0, prior_nll=prior0, sample_nll=total0 - prior0, generator=generator,
            step=torch.zeros((), dtype=torch.int32, device=device),
            n_accepted=torch.zeros(theta0.shape[0], dtype=torch.int32, device=device),
            swap_attempts=torch.zeros(n_pairs, dtype=torch.int32, device=device),
            swap_accepts=torch.zeros(n_pairs, dtype=torch.int32, device=device),
            log_scale=torch.zeros(n_t, dtype=ATYPE, device=device))
        _log.info("parallel tempering: %d levels x %d walkers, T_max=%g, swap every %d",
                  n_t, self.n_walkers, config.max_temp, config.swap_every)

    def log_evidence(self, out: dict[str, np.ndarray], burn_frac: float = 0.3,
                     method: str = "stepping_stone", normalise_prior: bool = True) -> float:
        """log Z(1) − log Z(0) from a run's per-level draws (needs
        ``beta_zero``): the evidence against the normalised, bound-truncated
        prior; ``normalise_prior=False`` adds the Gaussian prior mass back
        (``log_prior_mass``)."""
        from ..diagnostics.evidence import (
            log_prior_mass,
            stepping_stone_log_evidence,
            thermodynamic_log_evidence,
        )

        betas = pt_betas(self.config)
        if betas.min() > 0:
            raise ValueError("log_evidence needs PTConfig(beta_zero=True): the ladder stops "
                             f"at beta={betas.min():.3g}, not 0")
        e = out["sample_nll"]  # [S, T*W]
        s0 = int(e.shape[0] * burn_frac)
        e = e[s0:].reshape(e.shape[0] - s0, self.config.n_temps, self.n_walkers)
        fn = (stepping_stone_log_evidence if method == "stepping_stone"
              else thermodynamic_log_evidence)
        logz = float(fn(e, betas))
        if not normalise_prior:
            logz += log_prior_mass(self.model)
        return logz

    def cold_chain(self, out: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
        """The β = 1 (posterior) slice of a run's outputs."""
        w = self.n_walkers
        return {k: v[:, :w] if v.ndim >= 2 else v for k, v in out.items()}

    def online_rhat(self, recent: dict[str, np.ndarray]) -> np.ndarray:
        """Split R-hat over the cold walkers of a chunk's draws (the hot
        levels target other distributions)."""
        from ..diagnostics.rhat import split_rhat

        return np.asarray(split_rhat(recent["theta"][:, : self.n_walkers]))

    @property
    def swap_acceptance(self) -> np.ndarray:
        """Per-boundary swap acceptance [T-1] (healthy exchange: ~0.2-0.4)."""
        att = np.maximum(self.state.swap_attempts.cpu().numpy() * self.n_walkers, 1)
        return self.state.swap_accepts.cpu().numpy() / att
