"""MR2T2 — Metropolis-Hastings over a chain batch (port of
``mach3_tpu/fitters/mcmc.py``; ``Fitters/MR2T2.cpp``, ``Fitters/MCMCBase.cpp``).

One step: a correlated proposal (the prior-scaled throw, or the adapted
Haario matrix), prior + sample -logL of the proposal, the accept test of
``MR2T2::AcceptanceProbability`` (``MR2T2.cpp:103-115``, with simulated
annealing ``exp(-dL / exp(-step / T))``), a masked update and the adaptive
moments' update (Haario, pooled over chains or per chain; Robbins-Monro
global scale, ``Parameters/AdaptiveMCMCHandler.cpp:332-400``).

``MR2T2.run`` drives the steps in chunks (the reference's tree-fill /
auto-save boundary). On the card a chunk is one step captured as a CUDA
graph and replayed (the counterpart of the JAX package's jitted
``lax.scan``): the state lives in static tensors, each replay writes its
outputs into preallocated [chunk, C, ...] buffers at a device index, and the
host reads them once a chunk. The throw matrix's Cholesky refresh runs
between steps on the host-known schedule, in both loops the same helper
(``refresh_throw_matrix``), eagerly and without a host sync. The eager loop
stays selectable (``graph=False``) and is what runs on the CPU.

Random draws come from one ``torch.Generator`` on the chains' device
(Philox on the card); tests may inject them.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Callable

import numpy as np
import torch

from ..core import tracing
from ..core.collectives import all_reduce_mean
from ..core.logging import get_logger
from ..core.precision import ATYPE, LARGE_LOGL
from ..params.state import circular_wrap, propose_step_batch
from ..splines import reweight
from .model import FitModel

_log = get_logger("mcmc")

#: Haario's optimal scale numerator, 2.38².
HAARIO_SCALE = 5.6644


@dataclasses.dataclass
class AdaptiveState:
    """Running moments of the Haario adaptive covariance.

    ``"pooled"`` mode: one set of moments for all chains (mean [P], cov/chol
    [P, P], log_scale 0-d), each step contributing the chain-averaged outer
    products. ``"per_chain"``: the reference recursion per chain (mean
    [C, P], cov/chol [C, P, P], log_scale [C]). ``chol`` is the throw matrix,
    refreshed every ``adaption_update_step`` steps from the scaled
    covariance; ``log_scale`` is the Robbins-Monro global scale."""

    mean: torch.Tensor
    cov: torch.Tensor
    chol: torch.Tensor
    n_updates: torch.Tensor  # 0-d int32: steps accumulated into the moments
    log_scale: torch.Tensor

    @property
    def per_chain(self) -> bool:
        return self.cov.dim() == 3


@dataclasses.dataclass
class ChainState:
    theta: torch.Tensor  # [C, P] f64
    nll: torch.Tensor  # [C] current -logL (prior + samples)
    generator: torch.Generator
    step: torch.Tensor  # 0-d int32 global step counter, on the chains' device
    n_accepted: torch.Tensor  # [C] int32
    adaptive: AdaptiveState | None = None


def state_leaves(state, prefix: str = "") -> dict:
    """{dotted field path: value} of a state dataclass, nested dataclasses
    walked (tensors, generators, host numbers; ``None`` fields kept)."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.update(state_leaves(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


@dataclasses.dataclass(frozen=True)
class MCMCConfig:
    """Static knobs (reference YAML ``General.MCMC`` + ``AdaptionOptions``)."""

    n_steps: int = 1000
    chunk_size: int = 100  # steps per chunk; the host sees outputs per chunk
    anneal_temp: float | None = None  # simulated annealing temperature (MCMCBase.cpp:19-26)
    # Adaptive covariance (AdaptiveMCMCHandler.cpp:68-98 config keys)
    adaptive: bool = False
    # "pooled" (cross-chain moments) or "per_chain" (the reference's recursion per chain).
    adaption_mode: str = "pooled"
    adaption_start_throw: int = 1000  # start throwing with the adapted matrix
    adaption_start_update: int = 100  # start accumulating moments
    adaption_end_update: int = 1_000_000
    adaption_update_step: int = 100  # refresh Cholesky cadence
    # Adaption blocks (AdaptiveMCMCHandler.cpp:152-190): each entry a flat
    # tuple of (lower, upper) index pairs; unassigned parameters form the
    # default block; cross-block covariance is never learned.
    adaption_blocks: tuple[tuple[int, ...], ...] | None = None
    target_scale: float | None = None  # None -> 2.38^2 / d (Haario optimal)
    # Robbins-Monro global-scale adaptation towards the target acceptance
    # (AdaptiveMCMCHandler.h:228-239).
    robbins_monro: bool = True
    target_accept: float = 0.234
    # Record the proposal's per-handler / per-sample -logL pieces each step.
    record_breakdown: bool = False


def _masked_cholesky(cov: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Cholesky of ``cov`` [..., P, P] with a diagonal jitter floor, without
    a host sync (``cholesky_ex``); NaN where a factor does not exist, as
    ``jnp.linalg.cholesky`` gives."""
    d = cov.shape[-1]
    chol, info = torch.linalg.cholesky_ex(cov + eps * torch.eye(d, dtype=cov.dtype,
                                                                device=cov.device))
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.nan, chol)


def adaption_block_mask(n_params: int, blocks, device=None) -> torch.Tensor | None:
    """[P, P] f64 0/1 mask keeping only same-block covariance entries (None
    when no blocks are configured: everything adapts jointly)."""
    if not blocks:
        return None
    ids = np.zeros(n_params, np.int32)
    for b, ranges in enumerate(blocks):
        for k in range(0, len(ranges) - 1, 2):
            lb, ub = int(ranges[k]), int(ranges[k + 1])
            if lb > n_params or ub > n_params:
                raise ValueError(f"Adaption block [{lb}, {ub}) exceeds {n_params} parameters")
            ids[lb:ub] = b + 1
    mask = (ids[:, None] == ids[None, :]).astype(np.float64)
    return torch.as_tensor(mask, dtype=ATYPE, device=device)


def adaptive_propose(flat, ad: AdaptiveState, theta: torch.Tensor,
                     generator: torch.Generator | None = None, extra_scale: float = 1.0,
                     z: torch.Tensor | None = None,
                     flip_u: torch.Tensor | None = None) -> torch.Tensor:
    """Throw from the adapted matrix, shared by every fitter
    (``ParameterHandlerBase.cpp:652-684``): theta [C, P] -> [C, P]. Pooled
    mode contracts with the shared [P, P] factor, per-chain mode each chain
    with its own. ``extra_scale`` is the delayed-rejection cascade's shrink
    factor. ``z [C, P]`` normals and ``flip_u [C, P]`` uniforms may be
    injected; otherwise they are drawn from ``generator``."""
    c, p = theta.shape
    if z is None:
        z = torch.randn((c, p), generator=generator, dtype=ATYPE, device=theta.device)
    if flip_u is None:
        flip_u = torch.rand((c, p), generator=generator, dtype=ATYPE, device=theta.device)
    if ad.per_chain:
        # A product and a sum, not a batched matmul: the same reduction
        # order in a CUDA graph and in the eager loop.
        delta = (ad.chol * z[:, None, :]).sum(-1)
        scale = torch.exp(ad.log_scale)[:, None] * extra_scale
    else:
        delta = z @ ad.chol.T
        scale = torch.exp(ad.log_scale) * extra_scale
    prop = theta + scale * delta
    prop = torch.where(flat.fixed, theta, prop)
    wrapped = circular_wrap(prop, flat.circ_low, flat.circ_high)
    prop = torch.where(flat.circ_mask & ~flat.fixed, wrapped, prop)
    flipped = 2.0 * flat.flip_point - prop
    return torch.where(flat.flip_mask & ~flat.fixed & (flip_u < 0.5), flipped, prop)


def refresh_due(config: MCMCConfig, step: int) -> bool:
    """Whether the throw matrix is refreshed at the end of the step that
    brings the counter to ``step`` (``mcmc.py:393-396`` of the JAX package)."""
    return (config.adaptive and step >= config.adaption_start_throw
            and (step - config.adaption_start_throw) % config.adaption_update_step == 0)


def refreshed_chol(ad: AdaptiveState, config: MCMCConfig) -> torch.Tensor:
    """The throw matrix from the current moments: Cholesky of the scaled
    covariance (each chain's in per-chain mode)."""
    d = ad.cov.shape[-1]
    scale = config.target_scale if config.target_scale is not None else HAARIO_SCALE / d
    return _masked_cholesky(ad.cov * scale)


def refresh_throw_matrix(ad: AdaptiveState | None, config: MCMCConfig, step: int) -> None:
    """What follows the step that brings the counter to ``step``: where
    :func:`refresh_due`, the throw matrix refreshed from the moments, written
    into ``ad.chol`` in place. Both chunk loops call it between steps. The
    factor keeps its buffer's row-major layout (``cholesky_ex`` returns
    column-major factors, whose product with the normals would reduce in
    another order), and a captured step reads the buffer it holds."""
    if refresh_due(config, step):
        with tracing.span("runner.refresh"):
            ad.chol.copy_(refreshed_chol(ad, config))


def _moment_update(mean, cov, n, x, xxt):
    """One Haario recursion step (``AdaptiveMCMCHandler.cpp:332-400``):
    mean [..., P] and cov [..., P, P] updated with one sample x [..., P]
    (outer product ``xxt``); ``n`` the samples taken so far (0-d f64)."""
    new_mean = (x + mean * n) / (n + 1.0)
    safe_n = n.clamp(min=1.0)
    outer = mean[..., :, None] * mean[..., None, :]
    new_outer = new_mean[..., :, None] * new_mean[..., None, :]
    cov_updated = cov * (safe_n - 1.0) / safe_n + (n * outer - (n + 1.0) * new_outer + xxt) / safe_n
    return new_mean, torch.where(n > 0, cov_updated, cov)


def _update_adaptive(ad: AdaptiveState, theta: torch.Tensor, step: torch.Tensor,
                     config: MCMCConfig, acc_prob: torch.Tensor,
                     block_mask: torch.Tensor | None = None,
                     chain_group=None) -> AdaptiveState:
    """Haario moment update, pooled or per chain, inside the update window
    read from the device ``step``; Robbins-Monro ``log s += γ (acc −
    target)``, γ = 2 / t^0.66, clipped to [−8, 4]. The throw matrix is
    carried over: :func:`refresh_throw_matrix` refreshes it after the step.
    ``chain_group``: the process group of a chain-sharded batch; the pooled
    mean, outer product and acceptance are averaged over it in one
    all-reduce (per-chain mode needs no communication)."""
    in_window = (step >= config.adaption_start_update) & (step <= config.adaption_end_update)
    th = theta.to(ATYPE)
    n = ad.n_updates.to(ATYPE)
    if ad.per_chain:
        xxt = th[:, :, None] * th[:, None, :]
        new_mean, new_cov = _moment_update(ad.mean, ad.cov, n, th, xxt)
    else:
        x = th.mean(0)
        xxt = (th.T @ th) / th.shape[0]
        if chain_group is not None:
            x, xxt, acc_pooled = all_reduce_mean((x, xxt, acc_prob.mean()), chain_group)
        new_mean, new_cov = _moment_update(ad.mean, ad.cov, n, x, xxt)
    if block_mask is not None:
        new_cov = new_cov * block_mask
    mean = torch.where(in_window, new_mean, ad.mean)
    cov = torch.where(in_window, new_cov, ad.cov)
    n_updates = ad.n_updates + in_window.to(torch.int32)
    if config.robbins_monro:
        t = step.to(ATYPE).clamp(min=1.0)
        gamma = 2.0 / t**0.66
        if ad.per_chain:
            acc = acc_prob
        else:
            acc = acc_prob.mean() if chain_group is None else acc_pooled
        log_scale = (ad.log_scale + gamma * (acc - config.target_accept)).clamp(-8.0, 4.0)
    else:
        log_scale = ad.log_scale
    return AdaptiveState(mean=mean, cov=cov, chol=ad.chol, n_updates=n_updates,
                         log_scale=log_scale)


class _BlockMasks:
    """The adaption block mask per (parameter count, device), made once:
    a step must not copy it to the card (a host copy cannot be captured)."""

    def __init__(self, blocks):
        self.blocks = blocks
        self._made: dict = {}

    def __call__(self, model: FitModel) -> torch.Tensor | None:
        key = (model.n_params, model.flat.prefit.device)
        if key not in self._made:
            self._made[key] = adaption_block_mask(model.n_params, self.blocks, key[1])
        return self._made[key]


def make_step_fn_args(
    config: MCMCConfig, chain_group=None, event_group=None,
) -> Callable[..., tuple[ChainState, dict[str, torch.Tensor]]]:
    """The single-step transition ``step(model, state, z=None, flip_u=None,
    u_acc=None)``. ``z`` ([C, K] fixed proposal, [C, P] adaptive),
    ``flip_u [C, P]`` and ``u_acc [C]`` inject the proposal normals, the flip
    uniforms and the accept uniforms; by default they are drawn from
    ``state.generator``. The throw matrix's refresh follows the step
    (:func:`refresh_throw_matrix`).

    ``chain_group`` / ``event_group``: the process groups of a step on a
    (chains x events) mesh (``distributed/shard_step.py``): the pooled
    adaptive moments are averaged over the chain shards, the partial
    histograms summed over the event shards. Each rank's generator is its
    chain row's (``distributed/mesh.chain_state_sharding``). ``None`` (the
    default) is the single-device step."""
    block_mask = _BlockMasks(config.adaption_blocks)

    def step_fn(model: FitModel, state: ChainState, z=None, flip_u=None, u_acc=None):
        n_chains = state.theta.shape[0]
        tracing.stamp("propose")
        if state.adaptive is None:
            proposed = propose_step_batch(model.flat, state.theta, state.generator,
                                          z=z, flip_u=flip_u)
        else:
            proposed = adaptive_propose(model.flat, state.adaptive, state.theta,
                                        state.generator, z=z, flip_u=flip_u)
        nll_prop, prior_parts, sample_parts = model.total_nll_batch_parts(
            proposed, event_group=event_group)

        tracing.stamp("accept")
        log_acc = state.nll - nll_prop
        if config.anneal_temp is not None:
            log_acc = log_acc / torch.exp(-state.step.to(ATYPE) / config.anneal_temp)
        acc_prob = torch.exp(log_acc.clamp(max=0.0))
        if u_acc is None:
            u_acc = torch.rand((n_chains,), generator=state.generator, dtype=ATYPE,
                               device=state.theta.device)
        accept = (nll_prop < LARGE_LOGL) & (u_acc < acc_prob)

        theta = torch.where(accept[:, None], proposed, state.theta)
        nll = torch.where(accept, nll_prop, state.nll)
        step = state.step + 1
        adaptive = state.adaptive
        if adaptive is not None:
            tracing.stamp("adapt")
            adaptive = _update_adaptive(adaptive, theta, step, config, acc_prob,
                                        block_mask(model), chain_group)
        new_state = ChainState(theta=theta, nll=nll, generator=state.generator, step=step,
                               n_accepted=state.n_accepted + accept.to(torch.int32),
                               adaptive=adaptive)
        outputs = {"theta": theta, "nll": nll, "acc_prob": acc_prob, "accepted": accept}
        if config.record_breakdown:
            outputs["prior_nll_parts"] = prior_parts
            outputs["sample_nll_parts"] = sample_parts
        return new_state, outputs

    return step_fn


def _model_fingerprint(model: FitModel) -> tuple:
    """What a captured graph fixes of a model: the object, its tensors'
    addresses and its modules' plain settings (a sample's histogram form,
    say, which picks the kernel a step launches)."""
    settings = tuple((name, k, v) for name, mod in model.named_modules()
                     for k, v in vars(mod).items()
                     if not k.startswith("_") and isinstance(v, (bool, int, float, str)))
    return (id(model), tuple(b.data_ptr() for b in model.buffers()), settings)


def _generator_copies(state):
    """``state`` with each of its generators (nested dataclasses walked)
    replaced by a new generator in the same state."""
    changes = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if isinstance(v, torch.Generator):
            changes[f.name] = torch.Generator(device=v.device)
            changes[f.name].set_state(v.get_state())
        elif dataclasses.is_dataclass(v):
            changes[f.name] = _generator_copies(v)
    return dataclasses.replace(state, **changes)


class GraphChunk:
    """A ``state -> state`` function captured once as a CUDA graph,
    replayed ``n <= chunk`` times a chunk (the counterpart of the JAX
    package's compiled ``lax.scan``): a sampler's step, or a part of one
    (``hmc.SegmentedStep``). The state is any dataclass whose tensors the
    function reads and whose generators it draws from, nested dataclasses
    included (:class:`ChainState`, ``tempering.PTState``,
    ``ensemble.EnsembleState``, ``hmc.HMCState``).

    ``step_fn(model, state) -> (new state, outputs)``. The graph reads and
    writes the static state ``self.state`` in place and writes each
    replay's outputs (if any) into ``self.outputs[k]`` [chunk, ...] at the
    device index ``self.index``. The state's generators are registered
    with the graph, so a replay draws what the eager function would from
    the same generator state. The counts seen while capturing (those of
    every entry of the tracing registry: the kernel launches of
    ``reweight.LAUNCHES``, a fitter's evaluations) are the counts of one
    replay: each replay adds them. The graph holds its layers' device
    stamps (``self.stamps``, ``core.tracing``) as event-record nodes;
    ``name`` names it in the traces (``runner.replay.<name>``). The model is
    fixed for the graph's life (``check_model``). A capture that fails (a
    host sync inside the step, for one) raises."""

    #: The captured layers' stamps (None: nothing stamped).
    stamps: tracing.Stamps | None = None

    @tracing.setup_span("graph.capture")
    def __init__(self, step_fn, model: FitModel, state, chunk: int, name: str = "step"):
        self._fingerprint = _model_fingerprint(model)
        self.state = state
        self.name = name
        self._replay_span = f"runner.replay.{name}"
        dev = model.flat.prefit.device
        # Warm up on a copy (libraries, handles, lazily built kernels, the
        # autograd engine), on a side stream as capture wants; the chains
        # do not move.
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            _, out = step_fn(model, _generator_copies(state))
        torch.cuda.current_stream(dev).wait_stream(side)
        self.outputs = {k: torch.empty((chunk,) + tuple(v.shape), dtype=v.dtype, device=dev)
                        for k, v in out.items()}
        self.index = torch.zeros(1, dtype=torch.long, device=dev)
        self.graph = torch.cuda.CUDAGraph()
        leaves = state_leaves(state)
        generators = [v for v in leaves.values() if isinstance(v, torch.Generator)]
        for gen in generators:
            self.graph.register_generator_state(gen)
        static = {k: v for k, v in leaves.items() if isinstance(v, torch.Tensor)}
        self._seen = tracing.CaptureCounts()
        # A dead reference cycle holding CUDA objects (an earlier fitter and
        # its graphs, streams and events) must not be collected while this
        # graph captures: releasing them there invalidates the capture.
        # Collect now and keep the cyclic collector off until the capture
        # ends (torch's capture no longer collects first).
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(self.graph), tracing.stamping(name, external=True) as stamps:
                new, out = step_fn(model, state)
                tracing.stamp("write")
                for k, v in state_leaves(new).items():
                    if k in static:
                        static[k].copy_(v)
                for k, v in out.items():
                    self.outputs[k].index_copy_(0, self.index, v.unsqueeze(0))
                if out:
                    self.index.add_(1)
        except RuntimeError as err:
            # The failed capture ended before it released the generators it
            # registered (the state's and the device's default one): they
            # are still marked as capturing, and an eager draw would raise.
            # Each gets a fresh copy of its state, which is not.
            default = torch.cuda.default_generators[
                dev.index if dev.index is not None else torch.cuda.current_device()]
            for gen in generators + [default]:
                gen.graphsafe_set_state(gen.clone_state())
            raise RuntimeError(
                "capturing the sampler's step as a CUDA graph failed (a host sync or an "
                "operation a graph cannot hold inside the step); construct the fitter with "
                "graph=False to run the eager loop") from err
        finally:
            if collecting:
                gc.enable()
            self._seen.close()
        self.stamps = stamps
        self.launches = self._seen.of(reweight.LAUNCHES)
        tracing.count("graph_captures")

    def check_model(self, model: FitModel) -> None:
        """Refuse a model other than the one captured (the graph holds its
        tensors' addresses)."""
        if _model_fingerprint(model) != self._fingerprint:
            raise ValueError(
                "this chunk runner captured its model in a CUDA graph; a different model (or "
                "one moved, rebuilt or set up otherwise since) was passed. Rebuild the fitter "
                "for the model as it is now.")

    def adopt(self, state):
        """Copy ``state`` into the static state, its generators' states
        included (a no-op for the static state itself), and return the
        static state."""
        if state is not self.state:
            static = state_leaves(self.state)
            for k, v in state_leaves(state).items():
                if isinstance(v, torch.Tensor):
                    static[k].copy_(v)
                elif isinstance(v, torch.Generator):
                    static[k].set_state(v.get_state())
        return self.state

    def replay(self) -> None:
        with tracing.span(self._replay_span):
            self.graph.replay()
        tracing.count("graph_replays")
        self._seen.replay()

    def stamp_sets(self) -> list:
        """The stamps of the graph (none without any)."""
        return [] if self.stamps is None else [self.stamps]


class ChunkedSampler:
    """The chunk loop of the samplers (MR2T2, DelayedMR2T2, parallel
    tempering, the ensemble sampler, HMC; ``MCMCBase::RunMCMC``,
    ``Fitters/MCMCBase.cpp:32-123``). A subclass sets ``self.model``,
    ``self.config`` (its ``chunk_size``), ``self.state`` (a state dataclass
    with a device ``step`` counter and a ``generator``), ``self._step``
    (``step(model, state) -> (state, outputs)``) and ``self.graph``: on the
    card each chunk replays the step captured by :meth:`_capture` (one CUDA
    graph, :class:`GraphChunk`); ``graph=False`` and the CPU run the eager
    loop. :meth:`_after_step` runs between steps in both loops, outside the
    graph. While tracing is on (``core.tracing``), each chunk leaves a
    record with the layers' device ms of its last step."""

    model: FitModel
    _graph: GraphChunk | None = None
    _eager_stamps: tracing.Stamps | None = None

    @property
    def _graph_name(self) -> str:
        return f"{type(self).__name__.lower()}.step"

    def _use_graph(self, graph: bool | None) -> bool:
        device = self.model.flat.prefit.device
        use = device.type == "cuda" if graph is None else graph
        if use and device.type != "cuda":
            raise ValueError(f"graph=True needs a CUDA device; the model is on {device}")
        return use

    def _after_step(self, step: int) -> None:
        """What follows the step that brings the counter to ``step`` (host
        code between steps; nothing by default)."""

    def _eager_chunk(self, n: int, step0: int, keep: bool) -> dict | None:
        outs = []
        stamped = tracing.is_on() and self.model.flat.prefit.device.type == "cuda"
        for i in range(n):
            if stamped:
                with tracing.stamping(self._graph_name) as self._eager_stamps:
                    self.state, out = self._step(self.model, self.state)
            else:
                self.state, out = self._step(self.model, self.state)
            self._after_step(step0 + i + 1)
            if keep:
                outs.append(out)
        return {k: torch.stack([o[k] for o in outs]) for k in outs[0]} if keep else None

    def _capture(self):
        """The captured step: a :class:`GraphChunk` of ``self._step`` (a
        subclass may return another object with its interface)."""
        return GraphChunk(self._step, self.model, self.state, self.config.chunk_size,
                          self._graph_name)

    def _graph_chunk(self, n: int, step0: int, keep: bool) -> dict | None:
        if self._graph is None:
            self._graph = self._capture()
        g = self._graph
        g.check_model(self.model)
        self.state = g.adopt(self.state)
        g.index.zero_()
        for i in range(n):
            g.replay()
            self._after_step(step0 + i + 1)
        return {k: v[:n] for k, v in g.outputs.items()} if keep else None

    def _layer_ms(self) -> dict:
        """{graph name: {layer: device ms}} of the last replay of each
        captured graph, or of the last eager step on the card (after a read
        that waited for them)."""
        if self.graph:
            sets = self._graph.stamp_sets() if self._graph is not None else []
        else:
            sets = [self._eager_stamps] if self._eager_stamps is not None else []
        return {s.name: s.layer_ms() for s in sets}

    def run(
        self, n_steps: int | None = None, callback=None, collect: bool = True
    ) -> dict[str, np.ndarray]:
        """Run the chains; returns the step's outputs as host arrays [S, ...]
        (MR2T2's theta [S, C, P], nll [S, C], acc_prob [S, C], accepted
        [S, C]) and step_time [S] (per-step wall seconds, averaged over each
        chunk).

        callback(done, state, chunk) sees each chunk's host arrays and the
        state at its end (the live state: save what it needs before
        returning). collect=False streams: chunks go to ``callback`` only and
        run() returns {}; with no callback either, no draw leaves the
        device. A non-positive step count runs nothing and returns {}."""
        n_steps = n_steps or self.config.n_steps
        if n_steps <= 0:
            return {}
        chunks: list[dict[str, np.ndarray]] = []
        keep = collect or callback is not None
        step_host = None  # the host's mirror of the step counter: refresh schedule
        run_chunk = self._graph_chunk if self.graph else self._eager_chunk
        done = 0
        with torch.no_grad():
            while done < n_steps:
                n = min(self.config.chunk_size, n_steps - done)
                tracing.poll()
                with tracing.chunk() as record:
                    if step_host is None:
                        step_host = tracing.read_int(self.state.step)
                    t0 = time.perf_counter()
                    outs = run_chunk(n, step_host, keep)
                    step_host += n
                    done += n
                    if record is not None:
                        record.steps = n
                    if not keep:
                        continue
                    with tracing.span("runner.collect"):
                        host = {k: tracing.to_host(v) for k, v in outs.items()}
                    host["step_time"] = np.full(n, (time.perf_counter() - t0) / n)
                    if record is not None:
                        record.layers = self._layer_ms()
                    if collect:
                        chunks.append(host)
                    if callback is not None:
                        with tracing.span("runner.callback"):
                            callback(done, self.state, host)
        if not chunks:
            return {}
        return {k: np.concatenate([c[k] for c in chunks], axis=0) for k in chunks[0]}

    @property
    def acceptance_rate(self) -> np.ndarray:
        return self.state.n_accepted.cpu().numpy() / max(int(self.state.step), 1)


class MR2T2(ChunkedSampler):
    """Chunked MCMC runner with host-side chain storage. The model and
    ``init_theta`` decide the device; the generator lives there too.
    ``graph`` (default: on a CUDA device) runs each chunk as replays of a
    captured CUDA graph; ``graph=False`` runs the eager loop."""

    def __init__(self, model: FitModel, config: MCMCConfig, init_theta, seed: int = 0,
                 graph: bool | None = None):
        self.model = model
        self.config = config
        self._step = make_step_fn_args(config)
        device = model.flat.prefit.device
        self.graph = self._use_graph(graph)
        theta0 = torch.as_tensor(np.asarray(init_theta), dtype=ATYPE, device=device)
        n_chains, n_params = theta0.shape
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)

        adaptive = None
        if config.adaptive and any(p.chol.shape[0] != p.chol.shape[1] for p in model.priors):
            raise ValueError(
                "Adaptive covariance on a PCA-reduced proposal basis is not supported: "
                "adaptation learns in full parameter space and would re-introduce the dropped "
                "directions. Use PCA or adaptive, not both.")
        if config.adaptive:
            # Moments seeded with the prior covariance scaled like the
            # initial throw; the first factor carries the 2.38²/d scaling.
            cov0 = self._initial_cov()
            scale0 = config.target_scale if config.target_scale is not None else (
                HAARIO_SCALE / n_params)
            chol0 = np.linalg.cholesky(scale0 * cov0 + 1e-12 * np.eye(n_params))

            def t(x):
                return torch.as_tensor(x, dtype=ATYPE, device=device)

            if config.adaption_mode == "per_chain":
                adaptive = AdaptiveState(
                    mean=t(np.zeros((n_chains, n_params))),
                    cov=t(np.tile(cov0, (n_chains, 1, 1))),
                    chol=t(np.tile(chol0, (n_chains, 1, 1))),
                    n_updates=torch.zeros((), dtype=torch.int32, device=device),
                    log_scale=t(np.zeros(n_chains)))
            elif config.adaption_mode == "pooled":
                adaptive = AdaptiveState(
                    mean=t(np.zeros(n_params)), cov=t(cov0), chol=t(chol0),
                    n_updates=torch.zeros((), dtype=torch.int32, device=device),
                    log_scale=t(0.0))
            else:
                raise ValueError(f"adaption_mode must be 'pooled' or 'per_chain', got "
                                 f"{config.adaption_mode!r}")

        with torch.no_grad():
            nll0 = model.total_nll_batch(theta0)
        n_oob = int((nll0 >= LARGE_LOGL).sum())
        if n_oob:
            # A chain at the sentinel may never repair itself (accept needs
            # an in-bounds proposal; narrow priors make that rare).
            _log.warning(
                "%d/%d initial chains are OUT OF BOUNDS (nll at the LARGE_LOGL "
                "sentinel) — they will likely stay stuck; clip the initial "
                "throws into the parameter bounds", n_oob, n_chains,
            )
        self.state = ChainState(
            theta=theta0, nll=nll0, generator=generator,
            step=torch.zeros((), dtype=torch.int32, device=device),
            n_accepted=torch.zeros(n_chains, dtype=torch.int32, device=device),
            adaptive=adaptive,
        )

    def _initial_cov(self) -> np.ndarray:
        """Block-diagonal prior covariance scaled by the per-param step scales."""
        blocks = []
        for prior in self.model.priors:
            c = prior.chol.cpu().numpy() * prior.step_scale.cpu().numpy()[:, None]
            blocks.append(c @ c.T)
        total = sum(b.shape[0] for b in blocks)
        cov = np.zeros((total, total))
        at = 0
        for b in blocks:
            cov[at:at + b.shape[0], at:at + b.shape[0]] = b
            at += b.shape[0]
        return cov

    def _after_step(self, step: int) -> None:
        refresh_throw_matrix(self.state.adaptive, self.config, step)

    def online_rhat(self, recent: dict[str, np.ndarray]) -> np.ndarray:
        """Split R-hat over the chains of a chunk's draws: online convergence
        telemetry between autosaves."""
        from ..diagnostics.rhat import split_rhat

        return split_rhat(recent["theta"])

