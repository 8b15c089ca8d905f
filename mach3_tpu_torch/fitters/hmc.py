"""Hamiltonian Monte Carlo on the differentiable posterior (port of
``mach3_tpu/fitters/hmc.py``).

The reference has no gradient sampler (its spline weights go through CUDA
kernels with no backward). Here ``FitModel.log_posterior_batch`` runs the
fused reweight kernels forward and their hand-written backward
(``splines/grad.py``), so one forward and one backward pass give every
chain's log-density and gradient.

Leapfrog HMC over a chain batch with a diagonal mass matrix (from the prior,
then adapted from pooled Welford moments), dual-averaging step size (Hoffman
& Gelman 2014, Algorithm 5), jittered or fixed trajectory lengths, and ChEES
trajectory-time adaptation (Hoffman, Radul & Sountsov 2021) with Adam on
log T. Hard bounds act through rejection (−inf outside). The chunk loop is
plain Python; a ChEES step with the dynamic bound reads its trajectory
length on the host once. Every random draw (momenta, uniforms, lengths) can
be injected, so a test can replay another implementation's draws.
"""
from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from ..core.precision import ATYPE
from .model import FitModel

TRAJ_LEARNING_RATE = 0.025  # Adam's step on log T (ChEES)


@dataclasses.dataclass(frozen=True)
class HMCConfig:
    """Static knobs, with the JAX package's defaults and meanings."""

    n_steps: int = 500
    n_leapfrog: int = 16
    step_size: float = 0.01
    chunk_size: int = 50
    # Dual-averaging step-size adaptation.
    adapt_step_size: bool = True
    target_accept: float = 0.8
    adapt_steps: int = 200
    # Windowed mass adaptation: the inverse mass starts as the prior
    # covariance's diagonal; pooled (cross-chain) Welford moments of θ
    # refresh it every ``mass_update_every`` steps inside the adaptation
    # window.
    adapt_mass: bool = True
    mass_update_every: int = 50
    mass_start_update: int = 25
    # Per chain and step, a number of leapfrog steps drawn from [1, n_leapfrog].
    jitter_trajectory: bool = True
    # ChEES: one shared, halton-jittered trajectory time per step, learnt by
    # Adam ascent on log T; n_leapfrog / jitter_trajectory are then ignored
    # for lengths in [1, max_leapfrog].
    adapt_trajectory: bool = False
    max_leapfrog: int = 128
    initial_traj_length: float | None = None  # default: 4 * step_size
    # ChEES loop bound: False integrates exactly the step's length (one host
    # read per step); True always runs max_leapfrog + 1 masked iterations.
    chees_static_bound: bool = False


@dataclasses.dataclass
class HMCState:
    theta: torch.Tensor  # [C, P] f64
    logp: torch.Tensor  # [C]
    generator: torch.Generator
    step: int  # global step counter (host)
    n_accepted: torch.Tensor  # [C] int32
    # dual averaging (shared across chains), 0-d f64
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    # adaptive diagonal inverse mass and pooled Welford moments
    minv: torch.Tensor  # [P]
    mass_mean: torch.Tensor  # [P]
    mass_m2: torch.Tensor  # [P]
    mass_n: float  # pooled count (host)
    # ChEES trajectory adaptation, 0-d f64
    log_traj: torch.Tensor
    log_traj_bar: torch.Tensor
    traj_m: torch.Tensor
    traj_v: torch.Tensor


def _halton2(i: int, bits: int = 16) -> float:
    """Base-2 radical inverse of the step index: ChEES's quasi-random jitter
    of the trajectory time."""
    r, f = 0.0, 0.5
    for _ in range(bits):
        r += f * (i & 1)
        i >>= 1
        f *= 0.5
    return r


def _bounds_logp_batch(model: FitModel, thetas: torch.Tensor) -> torch.Tensor:
    """[C, P] -> [C]: −inf for chains outside the hard bounds, else 0."""
    flat = model.flat
    bad = ((thetas < flat.low_bound) | (thetas > flat.up_bound)).any(1)
    return torch.where(bad, -math.inf, 0.0).to(ATYPE)


class HMC:
    """Chain-batched HMC / ChEES-HMC. The model and ``init_theta`` decide the
    device. ``n_logp_evals`` and ``n_grad_evals`` count the forward-only and
    the forward-and-backward evaluations of the log-density."""

    def __init__(self, model: FitModel, config: HMCConfig, init_theta, seed: int = 0):
        self.model = model
        self.config = config
        self.n_logp_evals = 0
        self.n_grad_evals = 0
        device = model.flat.prefit.device
        minv = torch.cat([torch.diag(p.chol @ p.chol.T) for p in model.priors])
        theta0 = torch.as_tensor(np.asarray(init_theta), dtype=ATYPE, device=device)
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
        with torch.no_grad():
            logp0 = self.logp_batch(theta0)

        def scalar(v):
            return torch.tensor(v, dtype=ATYPE, device=device)

        log_traj0 = math.log(config.initial_traj_length if config.initial_traj_length is not None
                             else 4.0 * config.step_size)
        zeros = torch.zeros(model.n_params, dtype=ATYPE, device=device)
        self.state = HMCState(
            theta=theta0, logp=logp0, generator=generator, step=0,
            n_accepted=torch.zeros(theta0.shape[0], dtype=torch.int32, device=device),
            log_eps=scalar(math.log(config.step_size)),
            log_eps_bar=scalar(math.log(config.step_size)), h_bar=scalar(0.0),
            minv=minv, mass_mean=zeros, mass_m2=zeros.clone(), mass_n=0.0,
            log_traj=scalar(log_traj0), log_traj_bar=scalar(log_traj0),
            traj_m=scalar(0.0), traj_v=scalar(0.0),
        )

    # ------------------------------------------------------- log-density
    def logp_batch(self, thetas: torch.Tensor) -> torch.Tensor:
        """[C, P] -> [C] log-density with the hard bounds (forward only)."""
        self.n_logp_evals += 1
        return self.model.log_posterior_batch(thetas) + _bounds_logp_batch(self.model, thetas)

    def value_grad_batch(self, thetas: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """([C] log-density, [C, P] its gradient) from one forward and one
        backward pass: chains are independent, so the gradient of the sum is
        each chain's own."""
        self.n_grad_evals += 1
        with torch.enable_grad():
            th = thetas.detach().requires_grad_(True)
            val = self.model.log_posterior_batch(th)
            (g,) = torch.autograd.grad(val.sum(), th)
        return val.detach(), g

    def _leapfrog(self, theta, p, eps, n_active, minv, n_max: int):
        """Velocity Verlet with per-chain lengths: chain c integrates
        ``n_active[c]`` steps in n_max + 1 gradient evaluations. Iteration i
        kicks with ½ at the ends (i == 0, i == n_active), 1 inside and 0
        after, and the evaluation at i == n_active is the endpoint logp."""
        logp_end = torch.zeros(theta.shape[0], dtype=theta.dtype, device=theta.device)
        for i in range(n_max + 1):
            val, g = self.value_grad_batch(theta)
            at_end = n_active == i
            kick = torch.where(at_end | (i == 0), 0.5, torch.where(i < n_active, 1.0, 0.0))
            p = p + eps * kick.to(theta.dtype)[:, None] * g
            logp_end = torch.where(at_end, val, logp_end)
            drift = (i < n_active).to(theta.dtype)[:, None]
            theta = theta + eps * minv * p * drift
        return theta, p, logp_end

    # -------------------------------------------------------------- step
    def step(self, state: HMCState, z=None, u=None, n_active=None):
        """One transition. ``z [C, P]`` (standard normals of the momenta),
        ``u [C]`` (accept uniforms) and ``n_active [C]`` (jittered lengths)
        may be injected; by default they come from ``state.generator``.
        Returns (new state, {theta, logp, accepted, accept_prob, n_leapfrog})."""
        cfg = self.config
        c, n_par = state.theta.shape
        dev = state.theta.device
        eps = torch.exp(state.log_eps)
        traj_t = None
        if cfg.adapt_trajectory:
            traj_t = _halton2(state.step) * torch.exp(state.log_traj)
            ratio = traj_t / eps
            ratio = torch.where(torch.isfinite(ratio), ratio, 1.0)
            n_shared = torch.ceil(ratio).clamp(1, cfg.max_leapfrog).to(torch.int64)
            n_active = n_shared.expand(c)
            n_max = cfg.max_leapfrog if cfg.chees_static_bound else int(n_shared)
        elif cfg.jitter_trajectory:
            if n_active is None:
                n_active = torch.randint(1, cfg.n_leapfrog + 1, (c,), generator=state.generator,
                                         device=dev)
            n_max = cfg.n_leapfrog
        else:
            n_active = torch.full((c,), cfg.n_leapfrog, dtype=torch.int64, device=dev)
            n_max = cfg.n_leapfrog
        n_active = torch.as_tensor(n_active, device=dev).to(torch.int64)

        minv = state.minv
        if z is None:
            z = torch.randn((c, n_par), generator=state.generator, dtype=ATYPE, device=dev)
        p0 = z.to(ATYPE) / torch.sqrt(minv)
        ke0 = 0.5 * (minv * p0 * p0).sum(1)
        theta_new, p_new, logp_end = self._leapfrog(state.theta, p0, eps, n_active, minv, n_max)
        logp_new = logp_end + _bounds_logp_batch(self.model, theta_new)
        ke_new = 0.5 * (minv * p_new * p_new).sum(1)
        log_ratio = ((logp_new - ke_new) - (state.logp - ke0)).clamp(max=0.0)
        log_ratio = torch.where(torch.isnan(log_ratio), -math.inf, log_ratio)
        if u is None:
            u = torch.rand((c,), generator=state.generator, dtype=ATYPE, device=dev)
        accept = torch.log(u.to(ATYPE)) < log_ratio
        theta = torch.where(accept[:, None], theta_new, state.theta)
        logp = torch.where(accept, logp_new, state.logp)
        alpha = torch.exp(log_ratio)

        # Dual averaging on the mean acceptance probability.
        t = state.step + 1.0
        in_window = state.step < cfg.adapt_steps
        log_eps, log_eps_bar, h_bar = state.log_eps, state.log_eps_bar, state.h_bar
        if in_window and cfg.adapt_step_size:
            kappa, gamma, t0 = 0.75, 0.05, 10.0
            mu = math.log(10.0 * cfg.step_size)
            h_bar = (1.0 - 1.0 / (t + t0)) * h_bar + (cfg.target_accept - alpha.mean()) / (t + t0)
            log_eps = mu - math.sqrt(t) / gamma * h_bar
            eta = t ** (-kappa)
            log_eps_bar = eta * log_eps + (1.0 - eta) * log_eps_bar
        if state.step == cfg.adapt_steps:  # after adaptation: the averaged step size
            log_eps = log_eps_bar

        # Pooled Welford moments of the accepted positions (Chan et al.'s
        # exact batch update); the inverse mass refreshes on its cadence.
        in_mass = cfg.adapt_mass and cfg.mass_start_update <= state.step < cfg.adapt_steps
        mass_mean, mass_m2, mass_n, minv_new = state.mass_mean, state.mass_m2, state.mass_n, minv
        if in_mass:
            cnt = state.mass_n + c
            batch_mean = theta.mean(0)
            delta = batch_mean - state.mass_mean
            mass_mean = state.mass_mean + delta * (c / cnt)
            m2_b = ((theta - batch_mean) ** 2).sum(0)
            mass_m2 = state.mass_m2 + m2_b + delta * delta * state.mass_n * c / cnt
            mass_n = cnt
            if cnt > 2.0 * c and state.step % cfg.mass_update_every == 0:
                var_est = mass_m2 / max(cnt - 1.0, 1.0)
                minv_new = torch.maximum(var_est, 1e-12 * var_est.max())

        log_traj, log_traj_bar = state.log_traj, state.log_traj_bar
        traj_m, traj_v = state.traj_m, state.traj_v
        if cfg.adapt_trajectory:
            # d/dT of the ChEES criterion, pooled over chains: α-weighted
            # Δ|θ − μ|² · <θ' − μ', M⁻¹p'>, times d traj_t / d log T = traj_t.
            mu_old, mu_new = state.theta.mean(0), theta_new.mean(0)
            dsq = (((theta_new - mu_new) ** 2).sum(1)
                   - ((state.theta - mu_old) ** 2).sum(1))
            dot = ((theta_new - mu_new) * (minv * p_new)).sum(1)
            per_chain = alpha * dsq * dot
            per_chain = torch.where(torch.isfinite(per_chain), per_chain, 0.0)
            ghat = per_chain.sum() / alpha.sum().clamp(min=1e-10) * traj_t
            ghat = torch.where(torch.isfinite(ghat), ghat, 0.0)
            if in_window:
                b1, b2, eps_a = 0.9, 0.95, 1e-8
                traj_m = b1 * traj_m + (1 - b1) * ghat
                traj_v = b2 * traj_v + (1 - b2) * ghat * ghat
                upd = (TRAJ_LEARNING_RATE * (traj_m / (1.0 - b1**t))
                       / (torch.sqrt(traj_v / (1.0 - b2**t)) + eps_a))
                log_traj = log_traj + upd
            log_traj = torch.minimum(torch.maximum(log_traj, state.log_eps),
                                     state.log_eps + math.log(cfg.max_leapfrog))
            if in_window:
                eta_t = t ** (-0.75)
                log_traj_bar = eta_t * log_traj + (1.0 - eta_t) * log_traj_bar
            if state.step == cfg.adapt_steps:
                log_traj = log_traj_bar

        new_state = HMCState(
            theta=theta, logp=logp, generator=state.generator, step=state.step + 1,
            n_accepted=state.n_accepted + accept.to(torch.int32), log_eps=log_eps,
            log_eps_bar=log_eps_bar, h_bar=h_bar, minv=minv_new, mass_mean=mass_mean,
            mass_m2=mass_m2, mass_n=mass_n, log_traj=log_traj, log_traj_bar=log_traj_bar,
            traj_m=traj_m, traj_v=traj_v,
        )
        out = {"theta": theta, "logp": logp, "accepted": accept, "accept_prob": alpha,
               "n_leapfrog": n_active}
        return new_state, out

    def run(self, n_steps: int | None = None, callback=None,
            collect: bool = True) -> dict[str, np.ndarray]:
        """Run the chains; returns host arrays theta [S, C, P], logp, accepted,
        accept_prob, n_leapfrog [S, C] and step_time [S] (per-step wall
        seconds, averaged over each chunk). callback(done, state, chunk) sees
        each chunk's host arrays; collect=False keeps nothing."""
        n_steps = n_steps or self.config.n_steps
        chunks: list[dict[str, np.ndarray]] = []
        keep = collect or callback is not None
        done = 0
        with torch.no_grad():
            while done < n_steps:
                n = min(self.config.chunk_size, n_steps - done)
                t0 = time.perf_counter()
                outs = []
                for _ in range(n):
                    self.state, out = self.step(self.state)
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
        if not chunks:
            return {}
        return {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}
