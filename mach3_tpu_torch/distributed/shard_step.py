"""The sharded MR2T2 chunk loop on a (chains x events) mesh (port of
``mach3_tpu/distributed/shard_step.py``).

Each rank runs the step on its own block: its chain row's chains against its
event column's events (``mesh.shard_fit_model`` / ``mesh.chain_state_sharding``),
with the reweight kernels on its events. The collectives are explicit
(``fitters/mcmc.make_step_fn_args(chain_group=..., event_group=...)``): the
partial histograms of every sample are summed over the event group in one
all-reduce before the statistics, and the pooled adaptive moments and the
Robbins-Monro acceptance averaged over the chain group in another. Chain rows
draw from independent generators (``mesh.row_seed``).

The loop is the port's chunk loop (``fitters/mcmc.ChunkedSampler``). On the
card with NCCL each chunk replays one step captured as a CUDA graph, its
all-reduces included: the eager warm-up before the capture
(``GraphChunk``) initialises the communicators, and every rank captures and
replays the same collectives in the same order. Gloo cannot be captured, so
a gloo group needs ``graph=False``; ``graph=True`` there raises.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..core.logging import get_logger
from ..fitters.mcmc import ChainState, ChunkedSampler, MCMCConfig, make_step_fn_args
from ..fitters.mcmc import refresh_throw_matrix
from .mesh import mesh_groups

_log = get_logger("distributed")


def _uses_gloo(*groups) -> bool:
    return any(dist.get_backend(g) == dist.Backend.GLOO for g in groups)


class ShardedMR2T2(ChunkedSampler):
    """MR2T2's chunk loop over one rank's block of a mesh: ``model`` this
    rank's event shard, ``state`` its chain row's state. ``graph`` (default:
    on the card with NCCL) replays the step as a CUDA graph; a gloo group
    needs ``graph=False``."""

    def __init__(self, mesh, config: MCMCConfig, model, state: ChainState,
                 graph: bool | None = None):
        self.model, self.config, self.state = model, config, state
        chain_group, event_group = mesh_groups(mesh)
        on_card = model.flat.prefit.device.type == "cuda"
        if _uses_gloo(chain_group, event_group) and (graph or (graph is None and on_card)):
            raise ValueError("a gloo group cannot be captured in a CUDA graph: pass graph=False "
                             "for the eager loop (or use NCCL)")
        self.graph = self._use_graph(graph)
        self._step = make_step_fn_args(config, chain_group=chain_group, event_group=event_group)
        _log.info("sharded step: %d chain-shards x %d event-shards%s", mesh.size(0),
                  mesh.size(1), " as CUDA graphs" if self.graph else "")

    def _after_step(self, step: int) -> None:
        refresh_throw_matrix(self.state.adaptive, self.config, step)


def make_sharded_chunk_runner(mesh, config: MCMCConfig, model, state: ChainState,
                              graph: bool | None = None):
    """``run(model, state, n_steps) -> (state, outputs)``: ``n_steps`` steps
    of this rank's block on the chunk loop (:class:`ShardedMR2T2`).
    ``outputs`` are this rank's chains' host arrays [S, C_row, ...] and
    ``step_time`` [S]; :func:`gather_chains` gives the global [S, C, ...].
    The model is the one the runner was made for (a graph holds it)."""
    sampler = ShardedMR2T2(mesh, config, model, state, graph=graph)

    def run(mdl, st: ChainState, n_steps: int):
        if mdl is not sampler.model:
            raise ValueError("run() takes the model its runner was made for")
        sampler.state = st
        out = sampler.run(n_steps=n_steps)
        return sampler.state, out

    run.sampler = sampler
    return run


def gather_chains(outputs: dict[str, np.ndarray], mesh) -> dict[str, np.ndarray]:
    """A rank's chunk-loop outputs gathered over its chain group: every
    [S, C_row, ...] array becomes the global [S, C, ...] (chain rows in
    order), on every rank; ``step_time`` [S] stays this rank's."""
    group, _ = mesh_groups(mesh)
    device = torch.device("cuda", torch.cuda.current_device()) if (
        dist.get_backend(group) == dist.Backend.NCCL) else torch.device("cpu")
    out = {}
    for k, v in outputs.items():
        if v.ndim < 2:
            out[k] = v
            continue
        t = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        as_bool = t.dtype == torch.bool
        if as_bool:
            t = t.to(torch.uint8)
        parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t, group=group)
        g = torch.cat(parts, dim=1)
        out[k] = (g.bool() if as_bool else g).cpu().numpy()
    return out
