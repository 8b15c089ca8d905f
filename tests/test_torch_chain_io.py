"""The port's chain files, shards and checkpoints (``diagnostics/chain_io.py``)
against the JAX package's format, and an exact resume on the CPU."""
import os

import numpy as np
import pytest
import torch

from mach3_tpu.diagnostics.chain_io import load_chain as jload_chain
from mach3_tpu_torch.core.exceptions import MaCh3Error
from mach3_tpu_torch.diagnostics.chain_io import (
    ChainShardWriter,
    combine_chains,
    iter_chain_shards,
    load_chain,
    load_checkpoint,
    save_chain,
    save_checkpoint,
)
from mach3_tpu_torch.fitters.delayed import DelayedConfig, DelayedMR2T2
from mach3_tpu_torch.fitters.hmc import HMC, HMCConfig
from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig, state_leaves
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

NAMES = ["a", "b", "c"]


def _draws(rng, steps=6, chains=4):
    return {"theta": rng.normal(size=(steps, chains, 3)), "nll": rng.normal(size=(steps, chains)),
            "accepted": rng.uniform(size=(steps, chains)) < 0.5}


def test_round_trip_and_the_jax_reader(tmp_path):
    rng = np.random.default_rng(0)
    draws = _draws(rng)
    path = str(tmp_path / "c.npz")
    save_chain(path, draws, NAMES, config_yaml="General: {}\n", extra_meta={"prefit": [0, 1, 2]},
               state={"theta": draws["theta"][-1]})
    for load in (load_chain, jload_chain):
        got, meta, state = load(path)
        assert set(got) == set(draws)
        for k in draws:
            np.testing.assert_array_equal(got[k], draws[k])
        assert meta["names"] == NAMES and meta["config"] == "General: {}\n"
        assert meta["prefit"] == [0, 1, 2]
        np.testing.assert_array_equal(state["theta"], draws["theta"][-1])
    assert not [p for p in os.listdir(tmp_path) if p.endswith(".tmp")]


def test_combine_chains_merges_and_refuses(tmp_path):
    rng = np.random.default_rng(1)
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    save_chain(a, _draws(rng), NAMES, "cfg")
    save_chain(b, _draws(rng, steps=3), NAMES, "cfg")
    out = str(tmp_path / "ab.npz")
    combine_chains([a, b], out)
    merged, meta, _ = load_chain(out)
    assert merged["theta"].shape == (9, 4, 3) and meta["combined_from"] == [a, b]
    for bad, kw, what in ((str(tmp_path / "cfg.npz"), dict(config_yaml="other"), "Config"),
                          (str(tmp_path / "nm.npz"), dict(names=["x", "y", "z"]), "name"),
                          (str(tmp_path / "ver.npz"), dict(extra_meta={"version": "9"}),
                           "Version")):
        save_chain(bad, _draws(rng), kw.get("names", NAMES), kw.get("config_yaml", "cfg"),
                   extra_meta=kw.get("extra_meta"))
        with pytest.raises(MaCh3Error, match=what):
            combine_chains([a, bad], str(tmp_path / "x.npz"))
        combine_chains([a, bad], str(tmp_path / "x.npz"), check=False)
    with pytest.raises(MaCh3Error):
        combine_chains([], out)


def test_shard_writer_bounds_numbering_and_truncate(tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "s.npz")
    w = ChainShardWriter(path, NAMES, "cfg", extra_meta={"k": 1})
    chunks = [_draws(rng, steps=s) for s in (5, 5, 4)]
    for c in chunks:
        w.append(c)
    assert w.parts == ["part-00000.npz", "part-00001.npz", "part-00002.npz"]
    assert w.n_steps == 14 and w.disk_bytes > 0
    assert w.max_resident_bytes == max(sum(v.nbytes for v in c.values()) for c in chunks)
    w.finalize(state={"step": np.asarray(14)})
    draws, meta, state = load_chain(path)
    assert meta["n_steps"] == 14 and meta["k"] == 1 and int(state["step"]) == 14
    np.testing.assert_array_equal(draws["theta"],
                                  np.concatenate([c["theta"] for c in chunks]))
    assert [p["theta"].shape[0] for p in iter_chain_shards(path)] == [5, 5, 4]
    jdraws, _, _ = jload_chain(path)  # the JAX package reads the sharded chain
    np.testing.assert_array_equal(jdraws["nll"], draws["nll"])

    again = ChainShardWriter(path, NAMES, "cfg")  # a resumed run continues the numbering
    assert again.n_steps == 14 and len(again.parts) == 3
    again.truncate(7)  # mid-shard: the second part keeps 2 steps, the third goes
    assert again.n_steps == 7 and again.parts == ["part-00000.npz", "part-00001.npz"]
    again.append(_draws(rng, steps=3))
    assert again.parts[-1] == "part-00002.npz" and again.n_steps == 10
    again.finalize()
    draws, _, _ = load_chain(path)
    assert draws["theta"].shape[0] == 10
    np.testing.assert_array_equal(draws["theta"][:7],
                                  np.concatenate([c["theta"] for c in chunks])[:7])
    again.truncate(20)  # beyond the end: nothing to drop
    assert again.n_steps == 10


def _jitter(model, n_chains):
    """Prefit + 5% prior-sigma jitter, clipped inside the bounds."""
    flat = model.flat
    sig = torch.sqrt(torch.diag(flat.chol @ flat.chol.T)).numpy()
    lo, hi = flat.low_bound.numpy(), flat.up_bound.numpy()
    th = flat.prefit.numpy() + 0.05 * sig * np.random.default_rng(0).normal(
        size=(n_chains, len(sig)))
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))


@pytest.fixture(scope="module")
def small_toy():
    return build_toy(n_events=600, seed=5, e_grid_size=30, device="cpu")


RESUME = {
    "pooled": (MR2T2, MCMCConfig(chunk_size=8, adaptive=True, adaption_start_update=2,
                                 adaption_start_throw=6, adaption_update_step=4)),
    "per_chain": (MR2T2, MCMCConfig(chunk_size=8, adaptive=True, adaption_mode="per_chain",
                                    adaption_start_update=2, adaption_start_throw=6,
                                    adaption_update_step=4, anneal_temp=50.0)),
    "delayed": (DelayedMR2T2, DelayedConfig(chunk_size=8, adaptive=True,
                                            adaption_start_update=2, adaption_start_throw=6,
                                            adaption_update_step=4, max_rejections=1)),
}


@pytest.mark.parametrize("case", list(RESUME))
def test_exact_resume_on_the_cpu(small_toy, tmp_path, case):
    """Two chunks in one run equal one chunk, a checkpoint, a new fitter
    that loads it and one more chunk: bit for bit, adaptive state
    included (the refresh at step 14 falls in the resumed chunk)."""
    make, cfg = RESUME[case]
    model = small_toy.model
    init = _jitter(model, 4)
    whole = make(model, cfg, init, seed=11)
    out_whole = whole.run(16)

    first = make(model, cfg, init, seed=11)
    out1 = first.run(8)
    ckpt = str(tmp_path / "c.ckpt")
    save_checkpoint(ckpt, first, small_toy.names, "cfg")
    resumed = make(model, cfg, init, seed=99)  # another seed: all of it comes from the file
    load_checkpoint(ckpt, resumed)
    assert int(resumed.state.step) == 8
    out2 = resumed.run(8)
    for k in ("theta", "nll", "accepted", "acc_prob"):
        np.testing.assert_array_equal(np.concatenate([out1[k], out2[k]]), out_whole[k], err_msg=k)
    for k, v in state_leaves(whole.state).items():
        w = state_leaves(resumed.state)[k]
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, w), k
    assert torch.equal(whole.state.generator.get_state(), resumed.state.generator.get_state())
    assert out_whole["accepted"].any()


def test_checkpoint_of_another_configuration_is_refused(small_toy, tmp_path):
    model = small_toy.model
    init = np.tile(model.prefit_vector().numpy(), (2, 1))
    adaptive = MR2T2(model, MCMCConfig(adaptive=True), init)
    ckpt = str(tmp_path / "a.ckpt")
    save_checkpoint(ckpt, adaptive, small_toy.names)
    with pytest.raises(KeyError, match="adaptive"):
        load_checkpoint(ckpt, MR2T2(model, MCMCConfig(), init))
    with pytest.raises(KeyError, match="shape"):
        load_checkpoint(ckpt, MR2T2(model, MCMCConfig(adaptive=True), np.tile(init, (2, 1))))


def test_hmc_checkpoint_round_trip(small_toy, tmp_path):
    """The checkpoint walks any state dataclass: HMC's host numbers (step,
    mass count) and tensors come back as they were."""
    model = small_toy.model
    init = np.tile(model.prefit_vector().numpy(), (2, 1))
    cfg = HMCConfig(n_leapfrog=2, step_size=1e-3, chunk_size=3, adapt_steps=4)
    fit = HMC(model, cfg, init, seed=3)
    fit.run(3)
    ckpt = str(tmp_path / "h.ckpt")
    save_checkpoint(ckpt, fit, small_toy.names)
    other = HMC(model, cfg, init, seed=4)
    load_checkpoint(ckpt, other)
    for k, v in state_leaves(fit.state).items():
        w = state_leaves(other.state)[k]
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, w), k
        elif isinstance(v, torch.Generator):
            assert torch.equal(v.get_state(), w.get_state())
        else:
            assert v == w and type(v) is type(w), k
    assert other.state.step == 3
