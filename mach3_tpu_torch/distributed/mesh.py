"""Device meshes and the sharding of a fit (port of
``mach3_tpu/distributed/mesh.py``).

A fit is split over a 2-D mesh of processes, one process per card (PyTorch's
idiom; the JAX package puts every chip of a host in one process):

* ``chains`` — the data-parallel axis: each chain row owns a contiguous
  slice of the chain batch (θ, NLL, acceptance counts, per-chain adaptive
  moments) and its own random stream. The pooled adaptive moments and the
  Robbins-Monro acceptance are averaged over this axis.
* ``events`` — the model-parallel axis: each event column holds a contiguous
  slice of every sample's events, laid out and planned for its own kernel;
  the partial Σw/Σw² histograms are summed over this axis before the test
  statistic.

The mesh is ``torch.distributed.device_mesh.init_device_mesh`` over the
world; its process groups carry the step's all-reduces
(``fitters/mcmc.make_step_fn_args(chain_group=..., event_group=...)``).
Everything without an event axis (the data histogram, priors, oscillation
grids, binnings) is replicated. The JAX package's field → partition-spec
map becomes :data:`SAMPLE_EVENT_AXES`, a table of the port's
``SampleModel`` buffers and their event axis, by which
:func:`shard_fit_model` slices.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Any

import torch
import torch.distributed as dist

from ..core.logging import get_logger

_log = get_logger("distributed")

CHAIN_AXIS = "chains"
EVENT_AXIS = "events"

#: Every event-sized buffer of a ``SampleModel`` (dotted name within the
#: sample) and its event axis. Buffers not named here have no event axis
#: and are replicated; :data:`PLAN_BUFFERS` are rebuilt for each shard.
SAMPLE_EVENT_AXES = {
    "kin": 1,  # [V, E]
    "mc_weight": 0,  # [E]
    "norm_idx": 0,  # [E, W]
    "norm_s": 1,  # [NA+1, E] match counts
    "static_bins": 0,  # [E]
    "shift_static_base": 0,  # [E]
    "weight_mask": 1,  # [Nw, E]
    "event_perm": 0,  # [E]
    "event_pad": 0,  # [E]
    "spline_table.coeffs": 2,  # dense [P, K*4, E]
    "spline_table.event_splines": 0,  # sparse [E, W]
    "osc.event_grid_idx": 0,  # beam [E]
    "osc.event_channel": 0,
    "osc.flat_idx": 0,
    "osc.event_flat_idx": 0,  # atmospheric [E]
    "osc.nc_mask": 0,
    "tf1_table.slope": 1,  # [Pt, E]
    "tf1_table.intercept": 1,
}
#: The per-tile event layout's plan: laid out for a sample's own events, so
#: each shard plans anew (``samples/events.assemble_sample``).
PLAN_BUFFERS = ("hist_tile_start", "hist_tile_width", "hist_plan_ptr", "hist_plan_idx")


def make_mesh(n_chain_shards: int | None = None, n_event_shards: int = 1):
    """The (chains, events) ``DeviceMesh`` over the world of the initialised
    process group (``multihost.initialise``). ``n_chain_shards`` defaults to
    the world over ``n_event_shards``; a shape that does not cover the world
    raises ``ValueError``. The mesh's device type is ``"cuda"`` for an NCCL
    group and ``"cpu"`` for gloo (also when gloo carries CUDA tensors)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_chain_shards is None:
        n_chain_shards = world // n_event_shards
    if n_chain_shards * n_event_shards != world:
        raise ValueError(f"{n_chain_shards} x {n_event_shards} != {world} processes")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(distributed.multihost.initialise)")
    device_type = "cuda" if dist.get_backend() == dist.Backend.NCCL else "cpu"
    _log.info("Mesh: %d chain-shards x %d event-shards", n_chain_shards, n_event_shards)
    return init_device_mesh(device_type, (n_chain_shards, n_event_shards),
                            mesh_dim_names=(CHAIN_AXIS, EVENT_AXIS))


def mesh_coordinate(mesh) -> tuple[int, int]:
    """This rank's (chain row, event column)."""
    coord = mesh.get_coordinate()
    return int(coord[0]), int(coord[1])


def mesh_groups(mesh) -> tuple[Any, Any]:
    """The (chain, event) process groups of this rank."""
    return mesh.get_group(CHAIN_AXIS), mesh.get_group(EVENT_AXIS)


def even_slice(n: int, parts: int, k: int) -> slice:
    """The ``k``-th of ``parts`` contiguous slices of ``range(n)``; sizes
    differ by at most one (ragged slices are fine: a laid-out sample pads
    its own events)."""
    return slice(k * n // parts, (k + 1) * n // parts)


# ------------------------------------------------------------------ samples
def _take(sample, sel: torch.Tensor | None):
    """A host copy of ``sample`` holding the events ``sel`` (indices into
    its event axis; None: all) of every buffer of :data:`SAMPLE_EVENT_AXES`,
    with the per-tile plan dropped and every other buffer replicated."""
    memo: dict = {}
    for name, buf in sample.named_buffers():
        if name in PLAN_BUFFERS:
            memo[id(buf)] = None
        elif name in SAMPLE_EVENT_AXES and sel is not None:
            memo[id(buf)] = buf.index_select(SAMPLE_EVENT_AXES[name], sel.to(buf.device)).cpu()
        else:
            memo[id(buf)] = buf.cpu()
    return copy.deepcopy(sample, memo)


def _builder_order(sample) -> torch.Tensor:
    """Indices of a sample's events (pads dropped) in the builder's order."""
    keep = torch.nonzero(~sample.event_pad.cpu()).squeeze(1)
    return keep[torch.argsort(sample.event_perm.cpu()[keep])]


def prepare_sample(sample):
    """A sample's events back in the builder's order, on the host: pads of
    its layout dropped, the per-tile plan dropped, on the plain route (a
    sample with no layout is not a kernel's input). ``event_perm`` then
    counts 0..E-1; the route keeps the caller's original request, which
    :func:`shard_sample` routes again."""
    from ..samples.routing import KernelRoute

    if sample.event_perm is None:  # never laid out: already the builder's order
        out = _take(sample, None)
        out.event_perm = torch.arange(sample.n_events)
        out.event_pad = torch.zeros(sample.n_events, dtype=torch.bool)
    else:
        out = _take(sample, _builder_order(sample))
    out.hist_nbl = None
    route = sample.kernel_route
    out.kernel_route = KernelRoute(False, "xla", reason="the builder's order, readied for "
                                   "sharding", requested=route.requested)
    return out


def shard_sample(sample, k: int, n: int):
    """Event shard ``k`` of ``n`` of a sample readied by
    :func:`prepare_sample`: the builder-order slice :func:`even_slice`,
    assembled as a sample of its own (``samples/events.assemble_sample``:
    its bin map, its route from the original request, its own event layout
    and activity plan). ``event_perm`` holds the events' builder indices in
    the whole sample."""
    from ..samples.events import assemble_sample

    sl = even_slice(sample.n_events, n, k)
    part = _take(sample, torch.arange(sl.start, sl.stop))

    def host(x):
        return None if x is None else x.numpy()

    arrays = dict(kin=host(part.kin), mc_weight=host(part.mc_weight),
                  norm_idx=host(part.norm_idx), norm_s=host(part.norm_s),
                  weight_mask=host(part.weight_mask), spline_table=part.spline_table,
                  osc=part.osc, tf1_table=part.tf1_table, event_perm=host(part.event_perm),
                  event_pad=host(part.event_pad))
    return assemble_sample(
        sample.name, arrays, part.binning.cpu(), shifts=sample.shifts,
        weight_fns=sample.weight_fns, norm_applied=host(part.norm_applied),
        data=host(part.data), test_statistic=sample.test_statistic,
        stat_dtype=sample.stat_dtype, use_kernel=sample.kernel_route.requested)


def _rebuild(model, samples):
    from ..fitters.model import FitModel

    priors = [copy.deepcopy(p).cpu() for p in model.priors]
    return FitModel(priors, samples, model.slices, flat=copy.deepcopy(model.flat).cpu(),
                    osc_groups=model.osc_groups)


def prepare_model_for_shard_map(model):
    """Ready a ``FitModel`` for :func:`shard_fit_model`: a host copy with
    every sample in the builder's order (:func:`prepare_sample`). It runs, on
    the plain route. The JAX package's counterpart drops its one-hot norm
    form (the port has none) and pads each sample to a multiple of the
    event shards with zero-weight events; here a shard is assembled as a
    sample of its own, whose layout pads its own events, so ragged slices
    need no padding."""
    return _rebuild(model, [prepare_sample(s) for s in model.samples])


def shard_fit_model(mesh, model):
    """This rank's shard of a ``FitModel``: every sample's contiguous slice
    of events for this rank's event column (in the builder's order, reached
    through ``event_perm``), each assembled with its own layout and activity
    plan; everything without an event axis replicated. Returned on the
    model's device. The shards' partial histograms are summed over the
    event group in the step (``fitters/model.total_nll_batch_parts``)."""
    device = model.flat.prefit.device
    _, k = mesh_coordinate(mesh)
    n = mesh.size(1)
    readied = prepare_model_for_shard_map(model)
    samples = [shard_sample(s, k, n) for s in readied.samples]
    _log.info("event shard %d of %d: %s", k, n,
              ", ".join(f"{s.name} {int((~s.event_pad).sum())} events" for s in samples))
    return _rebuild(readied, samples).to(device)


def model_pspecs(model) -> dict[str, str | None]:
    """{buffer name of the model: ``EVENT_AXIS`` or None}: the buffers an
    event shard slices (the counterpart of the JAX package's partition
    specs; a ``SampleModel``'s event axis is in :data:`SAMPLE_EVENT_AXES`)."""
    out = {}
    for name, _ in model.named_buffers():
        head, _, rest = name.partition(".")
        inner = rest.partition(".")[2] if head == "samples" else None
        out[name] = EVENT_AXIS if inner in SAMPLE_EVENT_AXES else None
    return out


# ------------------------------------------------------------------- chains
#: SplitMix64's increment: the seed step between chain rows' generators.
ROW_SEED_STEP = 0x9E3779B97F4A7C15


def row_seed(seed: int, row: int) -> int:
    """The seed of chain row ``row``'s generator: ``(seed + row ·
    0x9E3779B97F4A7C15) mod 2^64``. Row 0 keeps ``seed``, so a 1 x 1 mesh
    draws what the unsharded sampler draws; other rows get independent
    Philox streams (the JAX package folds the row into its key)."""
    return (int(seed) + int(row) * ROW_SEED_STEP) % 2**64


def state_pspecs(state) -> dict[str, str | None]:
    """{state leaf: ``CHAIN_AXIS`` or None}: θ, NLL, acceptance counts and
    per-chain adaptive moments are sliced by chain row; the step counter and
    the pooled moments are replicated (the generator is the row's own)."""
    from ..fitters.mcmc import state_leaves

    per_chain = state.adaptive is not None and state.adaptive.per_chain
    chain_leaves = {"theta", "nll", "n_accepted"}
    if per_chain:
        chain_leaves |= {"adaptive.mean", "adaptive.cov", "adaptive.chol",
                         "adaptive.log_scale"}
    return {k: CHAIN_AXIS if k in chain_leaves else None
            for k, v in state_leaves(state).items() if isinstance(v, torch.Tensor)}


def chain_state_sharding(mesh, state, model=None):
    """This rank's part of an unsharded ``ChainState`` that has not stepped:
    its chain row's contiguous slice of the chain-batch leaves
    (:func:`state_pspecs`), the other leaves copied, and a new generator on
    the state's device seeded :func:`row_seed` ``(seed, row)``, ``seed``
    the state generator's initial seed: ranks of one chain row
    draw identical numbers, rows independent ones. With ``model`` (the
    event shard, :func:`shard_fit_model`) the slice's NLLs are evaluated
    anew over the event group. The chain count must divide by the rows."""
    row, _ = mesh_coordinate(mesh)
    rows = mesh.size(0)
    n_chains = state.theta.shape[0]
    if n_chains % rows:
        raise ValueError(f"{n_chains} chains do not divide into {rows} chain rows")
    sl = even_slice(n_chains, rows, row)
    specs = state_pspecs(state)

    def part(prefix, obj):
        fields = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            key = prefix + f.name
            if dataclasses.is_dataclass(v):
                fields[f.name] = part(key + ".", v)
            elif isinstance(v, torch.Tensor):
                fields[f.name] = (v[sl] if specs[key] == CHAIN_AXIS else v).clone()
            else:
                fields[f.name] = v
        return dataclasses.replace(obj, **fields)

    out = part("", state)
    gen = torch.Generator(device=state.theta.device)
    gen.manual_seed(row_seed(state.generator.initial_seed(), row))
    out.generator = gen
    if model is not None:
        with torch.no_grad():
            out.nll = sharded_total_nll(mesh, model, out.theta)
    return out


def sharded_total_nll(mesh, model, thetas: torch.Tensor) -> torch.Tensor:
    """[C, NP] -> [C] total -logL of an event shard's model, its partial
    histograms summed over the mesh's event group."""
    return model.total_nll_batch_parts(thetas, event_group=mesh.get_group(EVENT_AXIS))[0]

