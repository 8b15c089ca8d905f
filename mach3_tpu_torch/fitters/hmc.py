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
log T. Hard bounds act through rejection (−inf outside). MALA is HMC with
one fixed leapfrog step (``fitters/factory.py``).

The state lives on the chains' device, its step counter and Welford count
included, and the adaptation windows are device ``torch.where``s, as the JAX
package's ``jnp.where``s are: a step has no host branch. It runs in three
parts: the prologue draws the momenta and the lengths, each iteration is one
gradient evaluation of the leapfrog (JAX's ``fori_loop`` body), the
epilogue accepts and adapts. ``HMC.run`` is ``ChunkedSampler``'s loop: on
the card a step with a static iteration count (fixed or jittered lengths,
MALA, ``chees_static_bound``) is captured whole as one CUDA graph and
replayed with no host read; ChEES with the dynamic bound (JAX's
``while_loop``) replays three graphs, the prologue, the iteration (one
forward and one backward) as many times as the step's length plus one,
which the host reads once a step (8 bytes), and the epilogue. The eager loop
(``graph=False``, and the CPU) runs the same three parts. Every random draw
(momenta, uniforms, lengths) can be injected into :meth:`HMC.step`, so a
test can replay another implementation's draws.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..core import tracing
from ..core.precision import ATYPE
from .mcmc import ChunkedSampler, GraphChunk
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
    step: torch.Tensor  # 0-d int32 global step counter, on the chains' device
    n_accepted: torch.Tensor  # [C] int32
    # dual averaging (shared across chains), 0-d f64
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor
    # adaptive diagonal inverse mass and pooled Welford moments
    minv: torch.Tensor  # [P]
    mass_mean: torch.Tensor  # [P]
    mass_m2: torch.Tensor  # [P]
    mass_n: torch.Tensor  # 0-d f64 pooled count
    # ChEES trajectory adaptation, 0-d f64
    log_traj: torch.Tensor
    log_traj_bar: torch.Tensor
    traj_m: torch.Tensor
    traj_v: torch.Tensor


@dataclasses.dataclass
class Trajectory:
    """A step's trajectory in flight: what the prologue hands the
    iterations (the leapfrog's loop carry, ``hmc.py:197-213`` of the JAX
    package) and the iterations the epilogue."""

    theta: torch.Tensor  # [C, P] position
    p: torch.Tensor  # [C, P] momentum
    logp_end: torch.Tensor  # [C] log-density at each chain's end point
    i: torch.Tensor  # 0-d int64: the next iteration
    n_active: torch.Tensor  # [C] int64 leapfrog steps of each chain
    eps: torch.Tensor  # 0-d step size
    ke0: torch.Tensor  # [C] kinetic energy at the start
    traj_t: torch.Tensor | None = None  # ChEES: 0-d trajectory time
    n_shared: torch.Tensor | None = None  # ChEES: 0-d int64 length shared by the chains


@dataclasses.dataclass
class _InFlight:
    """The static state of the three captured parts of a dynamic-length step."""

    state: HMCState
    traj: Trajectory


def _halton2(i: torch.Tensor, bits: int = 16) -> torch.Tensor:
    """Base-2 radical inverse of the (device) step index: ChEES's
    quasi-random jitter of the trajectory time. The low ``bits`` bits
    reversed as an integer, over 2^bits: exact, so equal to the JAX
    package's sum of halves bit for bit."""
    k = torch.arange(bits, dtype=torch.int64, device=i.device)
    rev = (((i.to(torch.int64) >> k) & 1) << (bits - 1 - k)).sum()
    return rev.to(ATYPE) / float(1 << bits)


def _bounds_logp_batch(model: FitModel, thetas: torch.Tensor) -> torch.Tensor:
    """[C, P] -> [C]: −inf for chains outside the hard bounds, else 0."""
    flat = model.flat
    bad = ((thetas < flat.low_bound) | (thetas > flat.up_bound)).any(1)
    return torch.where(bad, -math.inf, 0.0).to(ATYPE)


class HMC(ChunkedSampler):
    """Chain-batched HMC / ChEES-HMC / MALA. The model and ``init_theta``
    decide the device. ``graph`` (default: on a CUDA device) replays
    captured CUDA graphs; ``graph=False`` runs the eager loop.
    ``n_logp_evals`` and ``n_grad_evals`` count the forward-only and the
    forward-and-backward evaluations of the log-density (a graph's replays
    included)."""

    def __init__(self, model: FitModel, config: HMCConfig, init_theta, seed: int = 0,
                 graph: bool | None = None):
        self.model = model
        self.config = config
        self.graph = self._use_graph(graph)
        self._evals = tracing.counters("hmc.evals", ("logp", "grad"))
        if config.adapt_trajectory and not config.chees_static_bound:
            self._iterations = None  # the step's own length + 1, read once a step
        else:
            self._iterations = (config.max_leapfrog if config.adapt_trajectory
                                else config.n_leapfrog) + 1
        device = model.flat.prefit.device
        minv = torch.cat([torch.diag(p.chol @ p.chol.T) for p in model.priors])
        theta0 = torch.tensor(np.asarray(init_theta), dtype=ATYPE, device=device)  # a copy
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
            theta=theta0, logp=logp0, generator=generator,
            step=torch.zeros((), dtype=torch.int32, device=device),
            n_accepted=torch.zeros(theta0.shape[0], dtype=torch.int32, device=device),
            log_eps=scalar(math.log(config.step_size)),
            log_eps_bar=scalar(math.log(config.step_size)), h_bar=scalar(0.0),
            minv=minv, mass_mean=zeros, mass_m2=zeros.clone(), mass_n=scalar(0.0),
            log_traj=scalar(log_traj0), log_traj_bar=scalar(log_traj0),
            traj_m=scalar(0.0), traj_v=scalar(0.0),
        )

    @property
    def n_logp_evals(self) -> int:
        return self._evals["logp"]

    @property
    def n_grad_evals(self) -> int:
        return self._evals["grad"]

    # ------------------------------------------------------- log-density
    def logp_batch(self, thetas: torch.Tensor) -> torch.Tensor:
        """[C, P] -> [C] log-density with the hard bounds (forward only)."""
        self._evals["logp"] += 1
        return self.model.log_posterior_batch(thetas) + _bounds_logp_batch(self.model, thetas)

    def value_grad_batch(self, thetas: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """([C] log-density, [C, P] its gradient) from one forward and one
        backward pass: chains are independent, so the gradient of the sum is
        each chain's own. ``autograd.grad``: no ``.grad`` accumulates, so a
        graph can hold the evaluation."""
        self._evals["grad"] += 1
        tracing.stamp("forward")
        with torch.enable_grad():
            th = thetas.detach().requires_grad_(True)
            val = self.model.log_posterior_batch(th)
            tracing.stamp("backward")
            (g,) = torch.autograd.grad(val.sum(), th)
        tracing.stamp("leapfrog")
        return val.detach(), g

    # -------------------------------------------------------------- step
    def prologue(self, state: HMCState, z=None, n_active=None) -> Trajectory:
        """The trajectory's start: each chain's length (ChEES: one shared,
        halton-jittered length from the device step; jittered: drawn from
        [1, n_leapfrog]) and its momenta. ``z [C, P]`` standard normals and
        ``n_active [C]`` jittered lengths may be injected."""
        tracing.stamp("prologue")
        cfg = self.config
        c, n_par = state.theta.shape
        dev = state.theta.device
        eps = torch.exp(state.log_eps)
        traj_t = n_shared = None
        if cfg.adapt_trajectory:
            traj_t = _halton2(state.step) * torch.exp(state.log_traj)
            ratio = traj_t / eps
            # A non-finite time must not reach the integer cast.
            ratio = torch.where(torch.isfinite(ratio), ratio, 1.0)
            n_shared = torch.ceil(ratio).clamp(1, cfg.max_leapfrog).to(torch.int64)
            n_active = n_shared.expand(c).clone()
        elif cfg.jitter_trajectory:
            if n_active is None:
                n_active = torch.randint(1, cfg.n_leapfrog + 1, (c,), generator=state.generator,
                                         device=dev)
        else:
            n_active = torch.full((c,), cfg.n_leapfrog, dtype=torch.int64, device=dev)
        n_active = torch.as_tensor(n_active, device=dev).to(torch.int64)
        if z is None:
            z = torch.randn((c, n_par), generator=state.generator, dtype=ATYPE, device=dev)
        p0 = z.to(ATYPE) / torch.sqrt(state.minv)
        ke0 = 0.5 * (state.minv * p0 * p0).sum(1)
        return Trajectory(theta=state.theta, p=p0,
                          logp_end=torch.zeros(c, dtype=ATYPE, device=dev),
                          i=torch.zeros((), dtype=torch.int64, device=dev), n_active=n_active,
                          eps=eps, ke0=ke0, traj_t=traj_t, n_shared=n_shared)

    def iterate(self, state: HMCState, traj: Trajectory) -> Trajectory:
        """One leapfrog iteration (velocity Verlet with per-chain lengths,
        one gradient evaluation): iteration i kicks with ½ at the ends
        (i == 0, i == n_active), 1 inside and 0 after, and the evaluation at
        i == n_active is the endpoint logp."""
        i, n_active = traj.i, traj.n_active
        val, g = self.value_grad_batch(traj.theta)
        at_end = n_active == i
        kick = torch.where(at_end | (i == 0), 0.5, torch.where(i < n_active, 1.0, 0.0))
        p = traj.p + traj.eps * kick.to(ATYPE)[:, None] * g
        logp_end = torch.where(at_end, val, traj.logp_end)
        drift = (i < n_active).to(ATYPE)[:, None]
        theta = traj.theta + traj.eps * state.minv * p * drift
        return dataclasses.replace(traj, theta=theta, p=p, logp_end=logp_end, i=i + 1)

    def n_iterations(self, traj: Trajectory) -> int:
        """Leapfrog iterations of the step: static, or (ChEES with the
        dynamic bound) its shared length + 1, read on the host."""
        if self._iterations is not None:
            return self._iterations
        with tracing.span("hmc.length_read"):
            return tracing.read_int(traj.n_shared) + 1

    def epilogue(self, state: HMCState, traj: Trajectory, u=None):
        """The accept test and the adaptation, every window a device
        ``torch.where`` on the step counter. ``u [C]`` accept uniforms may be
        injected. Returns (new state, {theta, logp, accepted, accept_prob,
        n_leapfrog})."""
        tracing.stamp("accept")
        cfg = self.config
        c = state.theta.shape[0]
        minv = state.minv
        theta_new, p_new = traj.theta, traj.p
        logp_new = traj.logp_end + _bounds_logp_batch(self.model, theta_new)
        ke_new = 0.5 * (minv * p_new * p_new).sum(1)
        log_ratio = ((logp_new - ke_new) - (state.logp - traj.ke0)).clamp(max=0.0)
        log_ratio = torch.where(torch.isnan(log_ratio), -math.inf, log_ratio)
        if u is None:
            u = torch.rand((c,), generator=state.generator, dtype=ATYPE,
                           device=state.theta.device)
        accept = torch.log(u.to(ATYPE)) < log_ratio
        theta = torch.where(accept[:, None], theta_new, state.theta)
        logp = torch.where(accept, logp_new, state.logp)
        alpha = torch.exp(log_ratio)

        # Dual averaging on the mean acceptance probability.
        tracing.stamp("adapt")
        t = state.step.to(ATYPE) + 1.0
        in_window = state.step < cfg.adapt_steps
        in_adapt = in_window & cfg.adapt_step_size
        at_end = state.step == cfg.adapt_steps
        kappa, gamma, t0 = 0.75, 0.05, 10.0
        mu = math.log(10.0 * cfg.step_size)
        h_bar = torch.where(in_adapt, (1.0 - 1.0 / (t + t0)) * state.h_bar
                            + (cfg.target_accept - alpha.mean()) / (t + t0), state.h_bar)
        log_eps = torch.where(in_adapt, mu - torch.sqrt(t) / gamma * h_bar, state.log_eps)
        eta = t ** (-kappa)
        log_eps_bar = torch.where(in_adapt, eta * log_eps + (1.0 - eta) * state.log_eps_bar,
                                  state.log_eps_bar)
        log_eps = torch.where(at_end, log_eps_bar, log_eps)  # then the averaged step size

        # Pooled Welford moments of the accepted positions (Chan et al.'s
        # exact batch update); the inverse mass refreshes on its cadence.
        in_mass = ((state.step >= cfg.mass_start_update) & (state.step < cfg.adapt_steps)
                   & cfg.adapt_mass)
        cnt = state.mass_n + in_mass.to(ATYPE) * c
        batch_mean = theta.mean(0)
        delta = batch_mean - state.mass_mean
        safe_cnt = cnt.clamp(min=1.0)
        mass_mean = state.mass_mean + torch.where(in_mass, delta * (c / safe_cnt), 0.0)
        dev_b = theta - batch_mean
        cross = delta * delta * state.mass_n * c / safe_cnt
        mass_m2 = state.mass_m2 + torch.where(in_mass, (dev_b * dev_b).sum(0) + cross, 0.0)
        refresh = in_mass & (cnt > 2.0 * c) & (state.step % cfg.mass_update_every == 0)
        var_est = mass_m2 / (cnt - 1.0).clamp(min=1.0)
        minv_new = torch.where(refresh, torch.maximum(var_est, 1e-12 * var_est.max()), minv)

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
            ghat = per_chain.sum() / alpha.sum().clamp(min=1e-10) * traj.traj_t
            ghat = torch.where(torch.isfinite(ghat), ghat, 0.0)
            b1, b2, eps_a = 0.9, 0.95, 1e-8
            traj_m = torch.where(in_window, b1 * traj_m + (1 - b1) * ghat, traj_m)
            traj_v = torch.where(in_window, b2 * traj_v + (1 - b2) * ghat * ghat, traj_v)
            upd = (TRAJ_LEARNING_RATE * (traj_m / (1.0 - b1**t))
                   / (torch.sqrt(traj_v / (1.0 - b2**t)) + eps_a))
            log_traj = torch.where(in_window, log_traj + upd, log_traj)
            log_traj = torch.minimum(torch.maximum(log_traj, state.log_eps),
                                     state.log_eps + math.log(cfg.max_leapfrog))
            eta_t = t ** (-0.75)
            log_traj_bar = torch.where(in_window, eta_t * log_traj + (1.0 - eta_t) * log_traj_bar,
                                       log_traj_bar)
            log_traj = torch.where(at_end, log_traj_bar, log_traj)

        new_state = HMCState(
            theta=theta, logp=logp, generator=state.generator, step=state.step + 1,
            n_accepted=state.n_accepted + accept.to(torch.int32), log_eps=log_eps,
            log_eps_bar=log_eps_bar, h_bar=h_bar, minv=minv_new, mass_mean=mass_mean,
            mass_m2=mass_m2, mass_n=cnt, log_traj=log_traj, log_traj_bar=log_traj_bar,
            traj_m=traj_m, traj_v=traj_v,
        )
        out = {"theta": theta, "logp": logp, "accepted": accept, "accept_prob": alpha,
               "n_leapfrog": traj.n_active}
        return new_state, out

    def step(self, state: HMCState, z=None, u=None, n_active=None):
        """One transition: the prologue, :meth:`n_iterations` iterations and
        the epilogue. ``z [C, P]`` (standard normals of the momenta), ``u
        [C]`` (accept uniforms) and ``n_active [C]`` (jittered lengths) may
        be injected; by default they come from ``state.generator``.
        Returns (new state, {theta, logp, accepted, accept_prob, n_leapfrog})."""
        traj = self.prologue(state, z=z, n_active=n_active)
        for _ in range(self.n_iterations(traj)):
            traj = self.iterate(state, traj)
        return self.epilogue(state, traj, u=u)

    # ------------------------------------------------------- chunk runner
    def _step(self, model: FitModel, state: HMCState):
        return self.step(state)

    def _capture(self):
        if self._iterations is not None:
            return GraphChunk(self._step, self.model, self.state, self.config.chunk_size,
                              self._graph_name)
        return SegmentedStep(self)


class SegmentedStep:
    """A dynamic-length step (ChEES with the dynamic bound) as three CUDA
    graphs on one static state: the prologue, one leapfrog iteration (one
    forward and one backward) and the epilogue. :meth:`replay` replays the
    prologue, reads the step's shared length (one 8-byte copy to the host,
    the step's only read), replays the iteration length + 1 times and the
    epilogue: length + 3 graph launches and one copy a step. The interface
    is :class:`GraphChunk`'s (``adopt``, ``check_model``, ``index``,
    ``outputs``, ``replay``, ``launches`` per iteration, ``stamp_sets``: the
    three graphs' stamps). The read is the span ``hmc.length_read``."""

    def __init__(self, fit: HMC):
        chunk, model = fit.config.chunk_size, fit.model
        gen = torch.Generator(device=fit.state.theta.device)
        gen.set_state(fit.state.generator.get_state())
        template = fit.prologue(dataclasses.replace(fit.state, generator=gen))
        traj = dataclasses.replace(template, **{
            f.name: getattr(template, f.name).clone() for f in dataclasses.fields(template)})
        self.static = _InFlight(fit.state, traj)

        def start(_, s):
            return dataclasses.replace(s, traj=fit.prologue(s.state)), {}

        def advance(_, s):
            return dataclasses.replace(s, traj=fit.iterate(s.state, s.traj)), {}

        def finish(_, s):
            new, out = fit.epilogue(s.state, s.traj)
            return dataclasses.replace(s, state=new), out

        self.prologue = GraphChunk(start, model, self.static, chunk, "hmc.prologue")
        self.iteration = GraphChunk(advance, model, self.static, chunk, "hmc.iteration")
        self.epilogue = GraphChunk(finish, model, self.static, chunk, "hmc.epilogue")
        self.outputs, self.index = self.epilogue.outputs, self.epilogue.index
        self.launches = self.iteration.launches
        self._iterations = fit.n_iterations

    def check_model(self, model: FitModel) -> None:
        self.epilogue.check_model(model)

    def adopt(self, state: HMCState) -> HMCState:
        if state is not self.static.state:
            self.epilogue.adopt(_InFlight(state, self.static.traj))
        return self.static.state

    def replay(self) -> None:
        self.prologue.replay()
        for _ in range(self._iterations(self.static.traj)):
            self.iteration.replay()
        self.epilogue.replay()

    def stamp_sets(self) -> list:
        return [s for g in (self.prologue, self.iteration, self.epilogue) for s in g.stamp_sets()]
