"""The sharded step on the card: one NCCL rank, a 1 x 1 mesh, the step with
its all-reduces captured as a CUDA graph and replayed, against the same
step as the eager loop and against the unsharded model.

Needs a CUDA device and nvcc, and skips without one; imports no jax. K1's
float atomics move the NLLs in their last bits from run to run, so graph
and eager may decide one chain differently (``test_torch_graph.py``).
"""
import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from mach3_tpu_torch.distributed import chain_state_sharding, make_mesh, shard_fit_model
from mach3_tpu_torch.distributed.mesh import sharded_total_nll
from mach3_tpu_torch.distributed.multihost import initialise
from mach3_tpu_torch.distributed.shard_step import ShardedMR2T2
from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
from mach3_tpu_torch.kernels.launch import LAUNCHES
from mach3_tpu_torch.tutorial.toy import build_toy

N_CHAINS = 32
CONFIG = MCMCConfig(chunk_size=10, adaptive=True, adaption_start_update=1,
                    adaption_start_throw=5, adaption_update_step=5, robbins_monro=False)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (NCCL and CUDA graphs have no CPU mode)")
    initialise(f"tcp://localhost:{_free_port()}", world_size=1, rank=0, device="cuda")
    yield make_mesh(1, 1)
    dist.destroy_process_group()


def _copy(state):
    def one(v):
        if isinstance(v, torch.Tensor):
            return v.clone()
        if isinstance(v, torch.Generator):
            gen = torch.Generator(device=v.device)
            gen.set_state(v.get_state())
            return gen
        if dataclasses.is_dataclass(v):
            return dataclasses.replace(v, **{f.name: one(getattr(v, f.name))
                                             for f in dataclasses.fields(v)})
        return v

    return one(state)


@pytest.mark.cuda
def test_graph_captures_the_all_reduces(mesh):
    model = build_toy(n_events=4000, seed=3, e_grid_size=40, device="cuda").model
    shard = shard_fit_model(mesh, model)
    flat = model.flat
    sig = torch.sqrt(torch.diag(flat.chol @ flat.chol.T)).cpu().numpy()
    init = np.clip(flat.prefit.cpu().numpy() + 0.05 * sig * np.random.default_rng(0).normal(
        size=(N_CHAINS, len(sig))), flat.low_bound.cpu().numpy() + 1e-6,
        flat.up_bound.cpu().numpy() - 1e-6)
    state = chain_state_sharding(mesh, MR2T2(model, CONFIG, init, seed=1).state, model=shard)
    with torch.no_grad():
        ref = model.total_nll_batch(state.theta)
    torch.testing.assert_close(state.nll, ref, rtol=1e-6, atol=1e-4)

    runs = {}
    for graph in (True, False):
        fit = ShardedMR2T2(mesh, CONFIG, shard, _copy(state), graph=graph)
        assert fit.graph == graph
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        out = fit.run(n_steps=30)
        assert LAUNCHES["reweight_shifted"] == 2 * (30 + (1 if graph else 0))
        runs[graph] = (fit, out)
    (fg, g), (fe, e) = runs[True], runs[False]
    assert torch.equal(fg.state.generator.get_state(), fe.state.generator.get_state())
    diverged = (g["accepted"] != e["accepted"]).any(0)
    assert diverged.sum() <= 1
    np.testing.assert_allclose(g["nll"][:, ~diverged], e["nll"][:, ~diverged], rtol=1e-6,
                               atol=1e-4)
    with torch.no_grad():
        anew = sharded_total_nll(mesh, shard, fg.state.theta)
    torch.testing.assert_close(fg.state.nll, anew, rtol=1e-6, atol=1e-4)
    assert 0 < g["accepted"].mean() < 1
