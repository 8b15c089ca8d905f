"""The sharded fit (``mach3_tpu_torch/distributed``) on the CPU: gloo worlds
of spawned processes (``torch_dist_ranks.py``), each rank one block of a
(chains x events) mesh, against the unsharded port and the JAX package.

* NLL parity on the toy at 2 x 2: the sharded NLL against the port's
  unsharded one to 1e-6 relative (f32 partial histograms summed in another
  order), against JAX's ``total_nll_batch`` and against JAX's ``shard_map``
  NLL at a (4, 2) mesh within the held budget 5e-3 + 1e-3·|NLL| (ROADMAP
  Queue 3: the port's f32 responses against JAX's bf16).
* Six lockstep steps of the pooled adaptive step with injected draws, each
  rank its chain rows: the same decisions as the unsharded step, θ to 1e-12,
  the pooled moments averaged over the chain rows equal (the covariance to
  1e-9 of its largest entry: its recursion cancels ~6 digits here); with
  Robbins-Monro on, the log-scale within γ_t times the pooled acceptance's
  difference.
* Chain rows throw independently, the event shards of a row identically.
* The event-axis table covers every event-sized buffer.
* The large fixture at the CPU size of ``tests/test_shard_step.py`` on a
  1 x 2 mesh; chain files of a 2 x 1 mesh merged by either package.
"""
import multiprocessing as mp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_dist_ranks as ranks
from jax.sharding import PartitionSpec as P

from mach3_tpu.diagnostics.chain_io import load_chain as jload_chain
from mach3_tpu.diagnostics.chain_io import save_chain as jsave_chain
from mach3_tpu.distributed.mesh import make_mesh as jmake_mesh
from mach3_tpu.distributed.multihost import merge_host_shards as jmerge
from mach3_tpu.distributed.shard_step import (
    _CHECK_KW,
    model_pspecs as jmodel_pspecs,
    prepare_model_for_shard_map as jprepare,
    shard_map,
)
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.core.exceptions import MaCh3Error
from mach3_tpu_torch.diagnostics.chain_io import load_chain, save_chain
from mach3_tpu_torch.distributed.mesh import (
    SAMPLE_EVENT_AXES,
    model_pspecs,
    prepare_model_for_shard_map,
    row_seed,
    shard_sample,
)
from mach3_tpu_torch.distributed.multihost import merge_host_shards
from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig
from mach3_tpu_torch.tutorial.large import build_large
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

NLL_RTOL = 1e-6
PROD_ATOL, PROD_RTOL = 5e-3, 1e-3


def _spawn(fn, world: int, out) -> list[dict]:
    """Run ``fn(rank, world, rendezvous, out)`` in ``world`` spawned
    processes; every rank must exit 0. Returns each rank's results."""
    ctx = mp.get_context("spawn")
    rdzv = os.path.join(out, "rendezvous")
    procs = [ctx.Process(target=fn, args=(r, world, rdzv, str(out))) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * world
    name = fn.__name__.split("_")[0]
    return [dict(np.load(os.path.join(out, f"{name}_rank{r}.npz"))) for r in range(world)]


@pytest.fixture(scope="module")
def toy_ranks(tmp_path_factory):
    return _spawn(ranks.toy_2x2, 4, tmp_path_factory.mktemp("toy2x2"))


@pytest.fixture(scope="module")
def large_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("large")
    return _spawn(ranks.large_and_files, 2, out), out


@pytest.fixture(scope="module")
def ttoy():
    return build_toy(**ranks.TOY, device="cpu")


@pytest.fixture(scope="module")
def jtoy():
    return jbuild_toy(**ranks.TOY)


def test_mesh_refuses_bad_shape_and_gloo_graph(toy_ranks):
    assert all(r["mesh_refused"] for r in toy_ranks)
    assert all(r["graph_refused"] for r in toy_ranks)
    assert sorted(tuple(r["coord"]) for r in toy_ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_sharded_nll_matches_unsharded(toy_ranks, ttoy):
    thetas = ranks.toy_thetas(ttoy.model)
    with torch.no_grad():
        ref = ttoy.model.total_nll_batch(thetas).numpy()
    for r in toy_ranks:
        np.testing.assert_allclose(r["nll"], ref, rtol=NLL_RTOL)
    # The two event columns hold every event of every sample exactly once.
    col = {tuple(r["coord"]): r for r in toy_ranks}
    counts = [s.n_events - int(s.event_pad.sum()) for s in ttoy.model.samples]
    for row in (0, 1):
        a, b = col[(row, 0)], col[(row, 1)]
        assert list(a["n_events"] + b["n_events"]) == counts
        assert abs(int(a["n_events"][0]) - int(b["n_events"][0])) <= 1
    ev = np.concatenate([col[(0, 0)]["events"], col[(0, 1)]["events"]])
    assert len(ev) == sum(counts) and len(np.unique(ev)) == max(counts)


def test_sharded_nll_matches_jax(toy_ranks, jtoy):
    thetas = ranks.toy_thetas(build_toy(**ranks.TOY, device="cpu").model)
    th = jnp.asarray(thetas.numpy())
    ref = np.asarray(jax.jit(lambda m, t: m.total_nll_batch(t))(jtoy.model, th))
    mesh = jmake_mesh(4, 2)
    model = jprepare(jtoy.model, n_event_shards=2)
    sharded = shard_map(
        lambda m, t: m.total_nll_batch_parts(t, event_axis="events")[0], mesh=mesh,
        in_specs=(jmodel_pspecs(model), P("chains", None)), out_specs=P("chains"),
        **{_CHECK_KW: False})
    jsh = np.asarray(jax.jit(sharded)(model, th))
    for r in toy_ranks:
        for other in (ref, jsh):
            assert np.all(np.abs(r["nll"] - other) <= PROD_ATOL + PROD_RTOL * np.abs(other))


def _unsharded_lockstep(ttoy, cfg: dict) -> dict:
    model = ttoy.model
    config = MCMCConfig(**cfg)
    state = MR2T2(model, config, ranks.toy_thetas(model).numpy(), seed=0, graph=False).state
    return ranks.run_lockstep(model, state, config, ranks.lockstep_draws(model.n_params),
                              slice(None))


def test_lockstep_pooled_adaptive(toy_ranks, ttoy):
    ref = _unsharded_lockstep(ttoy, ranks.LOCKSTEP)
    assert 0 < ref["accepted"].sum() < ref["accepted"].size
    for r in toy_ranks:
        rows = slice(4 * r["coord"][0], 4 * r["coord"][0] + 4)
        np.testing.assert_array_equal(r["lock_accepted"], ref["accepted"][:, rows])
        np.testing.assert_allclose(r["lock_theta"], ref["theta"][:, rows], rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(r["lock_mean"], ref["mean"], rtol=1e-12)
        # The covariance recursion cancels ~6 digits (θ ~ 1, spread ~1e-3).
        np.testing.assert_allclose(r["lock_cov"], ref["cov"], rtol=0,
                                   atol=1e-9 * np.abs(ref["cov"]).max())


def test_lockstep_robbins_monro_pools_the_acceptance(toy_ranks, ttoy):
    """Robbins-Monro on: the same decisions, and the shared log-scale moved
    by the acceptance averaged over both chain rows: it differs from the
    unsharded one by at most Σ_t γ_t |Δ mean acceptance_t| (the event
    shards' f32 partial sums move the acceptance probabilities)."""
    ref = _unsharded_lockstep(ttoy, ranks.LOCKSTEP_RM)
    col = {tuple(r["coord"]): r for r in toy_ranks}
    sharded = np.concatenate([col[(0, 0)]["lock_rm_acc_prob"], col[(1, 0)]["lock_rm_acc_prob"]],
                             axis=1)
    gamma = 2.0 / np.arange(1, sharded.shape[0] + 1) ** 0.66
    bound = np.sum(gamma * np.abs(sharded.mean(1) - ref["acc_prob"].mean(1))) + 1e-14
    for r in toy_ranks:
        rows = slice(4 * r["coord"][0], 4 * r["coord"][0] + 4)
        np.testing.assert_array_equal(r["lock_rm_accepted"], ref["accepted"][:, rows])
        assert abs(float(r["lock_rm_log_scale"] - ref["log_scale"])) <= bound
    assert ref["log_scale"] != 0.0


def test_chain_rows_throw_independently(toy_ranks):
    col = {tuple(r["coord"]): r for r in toy_ranks}
    for row in (0, 1):
        a, b = col[(row, 0)], col[(row, 1)]
        np.testing.assert_array_equal(a["free_theta"], b["free_theta"])
        assert int(a["free_step"]) == 7
    r0, r1 = col[(0, 0)]["free_acc_prob"], col[(1, 0)]["free_acc_prob"]
    assert r0.shape == (7, 4)
    assert not np.allclose(r0, r1)
    assert not np.allclose(r0[:, 0], r0[:, 1])
    gathered = np.concatenate([r0, r1], axis=1)
    for r in toy_ranks:
        np.testing.assert_array_equal(r["free_gathered"], gathered)
    assert row_seed(5, 0) == 5 and row_seed(5, 1) != 5


def test_event_axis_table_covers_every_buffer(ttoy):
    large = build_large(**ranks.LARGE, low_memory=True, device="cpu").model
    for model in (ttoy.model, large, prepare_model_for_shard_map(large)):
        specs = model_pspecs(model)
        for i, s in enumerate(model.samples):
            missing = [name for name, buf in s.named_buffers()
                       if s.n_events in buf.shape and name not in SAMPLE_EVENT_AXES]
            assert not missing, (s.name, missing)
            for name, axis in SAMPLE_EVENT_AXES.items():
                buf = s.get_buffer(name) if name in dict(s.named_buffers()) else None
                if buf is not None:
                    assert buf.shape[axis] == s.n_events, (s.name, name)
                    assert specs[f"samples.{i}.{name}"] == "events"


@pytest.mark.parametrize("dense", [True, False], ids=["laid out", "sparse, not laid out"])
def test_prepared_and_sharded_samples(dense):
    """A model back in the builder's order runs on the plain route with the
    same NLLs; two event shards' histograms add up to the whole sample's."""
    model = build_toy(**ranks.TOY, dense_splines=dense, device="cpu").model
    thetas = ranks.toy_thetas(model)
    prepared = prepare_model_for_shard_map(model)
    for s in prepared.samples:
        assert not s.kernel_route.use_kernel and s.kernel_route.requested == "auto"
        np.testing.assert_array_equal(s.event_perm.numpy(), np.arange(s.n_events))
        assert s.hist_plan_ptr is None
    with torch.no_grad():
        np.testing.assert_allclose(prepared.total_nll_batch(thetas).numpy(),
                                   model.total_nll_batch(thetas).numpy(), rtol=NLL_RTOL)
        for s, full in zip(prepared.samples, model.samples):
            halves = [shard_sample(s, k, 2) for k in range(2)]
            assert [h.kernel_route.variant for h in halves] == [full.kernel_route.variant] * 2
            mc, w2 = full.reweight_batch(thetas)
            parts = [h.reweight_batch(thetas) for h in halves]
            for i, ref in enumerate((mc, w2)):
                np.testing.assert_allclose((parts[0][i] + parts[1][i]).numpy(), ref.numpy(),
                                           rtol=1e-5, atol=1e-6 * float(ref.abs().max()))


def test_large_fixture_on_two_event_shards(large_ranks):
    res, _ = large_ranks
    for r in res:
        assert list(r["routes"]) == ["shared", "shifted", "shared"]
        np.testing.assert_allclose(r["nll"], r["nll_unsharded"], rtol=NLL_RTOL)
        np.testing.assert_allclose(r["from_parts"], r["nll"], rtol=1e-12)
        assert np.isfinite(r["large_steps_nll"]).all()
        np.testing.assert_allclose(r["large_state_nll"], r["large_state_anew"], rtol=1e-12)
    np.testing.assert_array_equal(res[0]["large_steps_nll"], res[1]["large_steps_nll"])


def test_host_shards_merge_both_ways(large_ranks, tmp_path):
    res, out = large_ranks
    paths = [str(res[0]["path"]), str(res[1]["path"])]
    assert sorted(tuple(r["chain_slice"]) for r in res) == [(0, 4), (4, 8)]
    for merge, load in ((merge_host_shards, load_chain), (jmerge, jload_chain)):
        dst = str(tmp_path / f"merged_{merge.__module__.split('.')[0]}.npz")
        merge(paths, dst)
        draws, meta, _ = load(dst)
        assert draws["theta"].shape[:2] == (10, 8) and meta["merged_hosts"] == 2
        np.testing.assert_array_equal(draws["theta"][:, :4], load_chain(paths[0])[0]["theta"])
    # JAX's shards through the port's merge.
    rng = np.random.default_rng(0)
    jpaths = []
    for host in range(3):
        p = str(tmp_path / f"jshard{host}.npz")
        jsave_chain(p, {"theta": rng.normal(size=(40, 2, 3))}, ["a", "b", "c"], "cfg",
                    extra_meta={"host": host, "n_hosts": 3})
        jpaths.append(p)
    merge_host_shards(jpaths, str(tmp_path / "jmerged.npz"))
    draws, meta, _ = load_chain(str(tmp_path / "jmerged.npz"))
    assert draws["theta"].shape == (40, 6, 3) and meta["merged_hosts"] == 3
    with pytest.raises(MaCh3Error, match="Incomplete"):
        merge_host_shards(jpaths[:2], str(tmp_path / "bad.npz"))
    with pytest.raises(MaCh3Error, match="Incomplete"):
        merge_host_shards(paths[1:], str(tmp_path / "bad2.npz"))
    save_chain(str(tmp_path / "other.npz"), {"theta": np.zeros((10, 4, 16))}, ["x"] * 16,
               "other cfg", extra_meta={"host": 1, "n_hosts": 2})
    with pytest.raises(MaCh3Error, match="mismatch"):
        merge_host_shards([paths[0], str(tmp_path / "other.npz")], str(tmp_path / "bad3.npz"))
