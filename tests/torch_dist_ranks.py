"""Rank bodies of ``test_torch_distributed.py``: each runs in a spawned
process of a gloo world on the CPU, imports no jax, and writes what it saw
to ``<out>/<name>_rank<r>.npz`` for the test process to hold against the
unsharded port and the JAX package. Not a test module (no ``test_`` prefix).
"""
from __future__ import annotations

import os

import numpy as np
import torch

TOY = dict(n_events=512, seed=3, e_grid_size=32)
LARGE = dict(n_numu=4000, n_nue=1500, n_atmo=3000, e_grid_size=40, atmo_e_grid_size=20,
             atmo_cosz_grid_size=8)
N_CHAINS = 8
#: Moments from step 1; the throw matrix refreshed at step 6, after the last
#: proposal: a factor of 8 chains' scatter in 16 parameters (some fixed) is
#: singular, and its Cholesky magnifies the moments' last bits. Robbins-Monro
#: held: it reads the acceptance probabilities, which the event shards' f32
#: partial sums move in their last bits (``LOCKSTEP_RM`` runs it).
LOCKSTEP = dict(adaptive=True, adaption_mode="pooled", adaption_start_update=1,
                adaption_start_throw=6, adaption_update_step=100, chunk_size=4,
                robbins_monro=False)
LOCKSTEP_RM = dict(LOCKSTEP, robbins_monro=True)


def toy_thetas(model, n_chains: int = N_CHAINS, seed: int = 0) -> torch.Tensor:
    """Prefit + 1e-3 jitter, clipped inside the bounds: the chains of every
    check."""
    rng = np.random.default_rng(seed)
    prefit = model.prefit_vector().numpy()
    lo, hi = model.flat.low_bound.numpy(), model.flat.up_bound.numpy()
    eps = 1e-6 * (hi - lo)
    theta = prefit + 1e-3 * rng.normal(size=(n_chains, len(prefit)))
    return torch.as_tensor(np.clip(theta, lo + eps, hi - eps))


def lockstep_draws(n_params: int, n_steps: int = 6, n_chains: int = N_CHAINS) -> dict:
    """The injected draws of the lockstep check: normals, flip and accept
    uniforms for each step."""
    rng = np.random.default_rng(17)
    return dict(z=rng.normal(size=(n_steps, n_chains, n_params)),
                flip_u=rng.uniform(size=(n_steps, n_chains, n_params)),
                u_acc=rng.uniform(size=(n_steps, n_chains)))


def run_lockstep(model, state, config, draws: dict, chains: slice, **groups) -> dict:
    """Steps of ``make_step_fn_args(config, **groups)`` with the draws of
    ``chains`` injected, the throw matrix refreshed between steps; returns
    the accept decisions [S, C] and θ [S, C, P]."""
    from mach3_tpu_torch.fitters.mcmc import make_step_fn_args, refresh_throw_matrix

    step = make_step_fn_args(config, **groups)
    outs = []
    with torch.no_grad():
        for i in range(draws["z"].shape[0]):
            state, out = step(model, state,
                              **{k: torch.as_tensor(v[i][chains]) for k, v in draws.items()})
            refresh_throw_matrix(state.adaptive, config, i + 1)
            outs.append(out)
    ad = state.adaptive
    return dict(**{k: np.stack([o[k].numpy() for o in outs])
                   for k in ("accepted", "theta", "acc_prob")},
                log_scale=ad.log_scale.numpy(), mean=ad.mean.numpy(), cov=ad.cov.numpy())


def _init(rank: int, world: int, rdzv: str) -> None:
    from mach3_tpu_torch.distributed.multihost import initialise

    torch.set_num_threads(1)
    initialise(f"file://{rdzv}", world, rank, device="cpu")


def toy_2x2(rank: int, world: int, rdzv: str, out: str) -> None:
    """The toy on a 2 x 2 mesh: the sharded NLL, six lockstep steps of the
    pooled adaptive step with injected draws, a free-running chunk loop,
    the mesh's refusals."""
    import torch.distributed as dist

    from mach3_tpu_torch.distributed import chain_state_sharding, make_mesh, shard_fit_model
    from mach3_tpu_torch.distributed.mesh import (
        even_slice,
        mesh_coordinate,
        mesh_groups,
        sharded_total_nll,
    )
    from mach3_tpu_torch.distributed.shard_step import gather_chains, make_sharded_chunk_runner
    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
    from mach3_tpu_torch.tutorial.toy import build_toy

    _init(rank, world, rdzv)
    res = {}
    try:
        make_mesh(3, 3)
    except ValueError:
        res["mesh_refused"] = True
    mesh = make_mesh(2, 2)
    row, col = mesh_coordinate(mesh)
    model = build_toy(**TOY, device="cpu").model
    shard = shard_fit_model(mesh, model)
    thetas = toy_thetas(model)
    with torch.no_grad():
        res["nll"] = sharded_total_nll(mesh, shard, thetas).numpy()
    res["events"] = np.concatenate(
        [np.sort(s.event_perm[~s.event_pad].numpy()) for s in shard.samples])
    res["n_events"] = np.array([int((~s.event_pad).sum()) for s in shard.samples])

    # Lockstep: the pooled adaptive step, this row's chains of the draws.
    chain_group, event_group = mesh_groups(mesh)
    rows = even_slice(N_CHAINS, 2, row)
    for tag, cfg in (("lock", LOCKSTEP), ("lock_rm", LOCKSTEP_RM)):
        config = MCMCConfig(**cfg)
        full = MR2T2(model, config, thetas.numpy(), seed=0, graph=False).state
        lock = run_lockstep(shard, chain_state_sharding(mesh, full), config,
                            lockstep_draws(model.n_params), rows,
                            chain_group=chain_group, event_group=event_group)
        res.update({f"{tag}_{k}": v for k, v in lock.items()})

    # Free-running chunk loop from one θ for every chain: chain rows must
    # throw independently, the event shards of a row identically.
    same = thetas[:1].repeat(N_CHAINS, 1).numpy()
    plain = MR2T2(model, MCMCConfig(chunk_size=3), same, seed=5, graph=False).state
    st = chain_state_sharding(mesh, plain, model=shard)
    try:
        make_sharded_chunk_runner(mesh, MCMCConfig(), shard, st, graph=True)
    except ValueError as err:
        res["graph_refused"] = "gloo" in str(err)
    run = make_sharded_chunk_runner(mesh, MCMCConfig(chunk_size=3), shard, st)
    st, outs = run(shard, st, 7)
    res["free_acc_prob"] = outs["acc_prob"]
    res["free_theta"] = outs["theta"]
    res["free_gathered"] = gather_chains(outs, mesh)["acc_prob"]
    res["free_step"] = np.array(int(st.step))
    res["coord"] = np.array([row, col])
    dist.barrier()
    np.savez(os.path.join(out, f"toy_rank{rank}.npz"), **res)
    dist.destroy_process_group()


def large_and_files(rank: int, world: int, rdzv: str, out: str) -> None:
    """Two ranks: the large fixture on a 1 x 2 mesh (the shared and shifted
    routes' plain versions on each shard: NLLs and a few steps), then the
    toy on a 2 x 1 mesh writing one chain file per chain row."""
    import torch.distributed as dist

    from mach3_tpu_torch.distributed import chain_state_sharding, make_mesh, shard_fit_model
    from mach3_tpu_torch.distributed.mesh import sharded_total_nll
    from mach3_tpu_torch.distributed.multihost import local_chain_slice, save_host_shard
    from mach3_tpu_torch.distributed.shard_step import make_sharded_chunk_runner
    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
    from mach3_tpu_torch.tutorial.large import build_large
    from mach3_tpu_torch.tutorial.toy import build_toy

    _init(rank, world, rdzv)
    res = {}
    mesh = make_mesh(1, 2)
    large = build_large(**LARGE, low_memory=True, device="cpu").model
    shard = shard_fit_model(mesh, large)
    res["routes"] = np.array([s.kernel_route.variant for s in shard.samples])
    thetas = toy_thetas(large, 4, seed=1)
    with torch.no_grad():
        res["nll"] = sharded_total_nll(mesh, shard, thetas).numpy()
        res["nll_unsharded"] = large.total_nll_batch(thetas).numpy()
        _, prior, parts = shard.total_nll_batch_parts(thetas,
                                                      event_group=mesh.get_group("events"))
        res["from_parts"] = (prior.sum(1) + parts.sum(1)).numpy()
    state = chain_state_sharding(
        mesh, MR2T2(large, MCMCConfig(), thetas.numpy(), seed=2, graph=False).state, model=shard)
    run = make_sharded_chunk_runner(mesh, MCMCConfig(chunk_size=2), shard, state)
    state, outs = run(shard, state, 3)
    res["large_steps_nll"] = outs["nll"]
    with torch.no_grad():
        res["large_state_anew"] = sharded_total_nll(mesh, shard, state.theta).numpy()
    res["large_state_nll"] = state.nll.numpy()

    mesh = make_mesh(2, 1)
    toy = build_toy(**TOY, device="cpu")
    thetas = toy_thetas(toy.model)
    state = chain_state_sharding(
        mesh, MR2T2(toy.model, MCMCConfig(), thetas.numpy(), seed=4, graph=False).state)
    res["chain_slice"] = np.array([local_chain_slice(N_CHAINS, mesh).start,
                                   local_chain_slice(N_CHAINS, mesh).stop])
    run = make_sharded_chunk_runner(mesh, MCMCConfig(chunk_size=5), shard_fit_model(mesh, toy.model),
                                    state)
    _, outs = run(run.sampler.model, state, 10)
    path = save_host_shard(os.path.join(out, "shard{host}.npz"),
                           {k: outs[k] for k in ("theta", "nll", "accepted")}, toy.names, "cfg",
                           mesh=mesh)
    res["path"] = np.array(path)
    dist.barrier()
    np.savez(os.path.join(out, f"large_rank{rank}.npz"), **res)
    dist.destroy_process_group()
