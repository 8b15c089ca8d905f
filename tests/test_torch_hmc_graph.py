"""HMC in device form (``mach3_tpu_torch/fitters/hmc.py``): its step against
the JAX package's ``step_fn`` (``mach3_tpu/fitters/hmc.py``) on injected
draws, and its chunk runner's plumbing, on the CPU.

* Lockstep at 1e-10: the toy's parameter sets with no sample, so that both
  packages differentiate the same f64 Gaussian prior and any gap is the
  sampler's own (the toy's full likelihood carries the f32 NLL gap of
  ``tests/test_torch_hmc.py``, whose budget is 3e-5 prior widths). JAX's
  key splits are injected into the port's step; 10 steps cross a mass
  refresh (steps 2 and 4), the end of the adaptation window (step 6:
  the averaged step size and trajectory time) and ChEES's Adam steps.
  θ within 1e-10 of each prior width, logp 1e-10, the adaptation state
  (log ε, its average, h̄, the inverse mass, the Welford moments and count,
  log T, its average and Adam's moments) within 1e-10 relative, the same
  decisions.
* ``_halton2`` on a device integer equals JAX's for steps 0-4095.
* A gradient evaluation reads nothing on the host and sorts no index (the
  toy, the large fixture and the YAML experiment, small): outside the
  kernels' plain versions, which stand in for the CUDA kernels here, its
  forward and backward run no ``item`` (a host read), ``nonzero`` or
  advanced-index backward (``_index_put_impl_``, which sorts its indices on
  the card), so a CUDA graph can hold it.
* The graph runner without a card: ``GraphChunk`` replaced by a stand-in
  that runs the captured function eagerly into the static state, as a
  replay writes it. A run through it (the whole step as one "graph";
  ChEES with the dynamic bound as the three parts of ``SegmentedStep``)
  equals the eager loop bit for bit, chunk by chunk, and counts each
  replay's evaluations.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import profile, record_function

from mach3_tpu.fitters import hmc as jhmc
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.bridge import from_jax_model
from mach3_tpu_torch.fitters import hmc as thmc
from mach3_tpu_torch.fitters import mcmc as tmcmc
from mach3_tpu_torch.fitters.hmc import HMC, HMCConfig
from mach3_tpu_torch.fitters.mcmc import GraphChunk, state_leaves
from mach3_tpu_torch.splines import grad, reweight
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

N_CHAINS, N_STEPS = 6, 10
LOCKSTEP_TOL = 1e-10
BASE = dict(step_size=0.2, chunk_size=1, adapt_steps=6, mass_start_update=0,
            mass_update_every=2)
MODES = {
    "jittered": dict(n_leapfrog=4, jitter_trajectory=True),
    "fixed": dict(n_leapfrog=3, jitter_trajectory=False),
    "mala": dict(n_leapfrog=1, jitter_trajectory=False, target_accept=0.574),
    "chees": dict(adapt_trajectory=True, max_leapfrog=8, initial_traj_length=0.6),
    "chees_static": dict(adapt_trajectory=True, max_leapfrog=8, initial_traj_length=0.6,
                         chees_static_bound=True),
}
ADAPT_FIELDS = ("log_eps", "log_eps_bar", "h_bar", "minv", "mass_mean", "mass_m2", "mass_n",
                "log_traj", "log_traj_bar", "traj_m", "traj_v")


@pytest.fixture(scope="module")
def prior_models():
    """(JAX toy model without its samples, the port's bridged from it, prior
    widths [NP])."""
    jm = jbuild_toy(n_events=500, seed=11, e_grid_size=20).model.replace(
        samples=(), osc_groups=())
    tm = from_jax_model(jm)
    chol = np.asarray(jm._flat().chol)
    return jm, tm, np.sqrt(np.diag(chol @ chol.T))


def _start(jm, n_chains, seed, frac=0.3):
    flat = jm._flat()
    chol = np.asarray(flat.chol)
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = np.asarray(flat.low_bound), np.asarray(flat.up_bound)
    th = np.asarray(flat.prefit) + frac * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    return np.clip(th, lo + 1e-3 * (hi - lo), hi - 1e-3 * (hi - lo))


@pytest.mark.parametrize("mode", list(MODES))
def test_device_step_lockstep_with_jax(prior_models, mode):
    jm, tm, sig = prior_models
    kw = dict(BASE, **MODES[mode])
    th = _start(jm, N_CHAINS, seed=3)
    jfit = jhmc.HMC(jm, jhmc.HMCConfig(**kw), th, seed=7)
    tfit = HMC(tm, HMCConfig(**kw), th)
    assert tfit.state.step.dtype == torch.int32 and tfit.state.mass_n.dim() == 0
    n_max = kw.get("n_leapfrog", 16)
    for step in range(N_STEPS):
        _, k_mom, k_acc, k_len = jax.random.split(jfit.state.key, 4)
        z = np.array(jax.random.normal(k_mom, th.shape, jnp.float64))
        u = np.array(jax.random.uniform(k_acc, (N_CHAINS,), jnp.float64))
        n_len = np.array(jax.random.randint(k_len, (N_CHAINS,), 1, n_max + 1))
        jfit.run(n_steps=1, collect=False)
        tfit.state, out = tfit.step(
            tfit.state, z=torch.from_numpy(z), u=torch.from_numpy(u),
            n_active=torch.from_numpy(n_len) if mode == "jittered" else None)
        js, ts = jfit.state, tfit.state
        msg = f"{mode} step {step}"
        assert int(ts.step) == int(js.step) == step + 1
        np.testing.assert_array_equal(ts.n_accepted.numpy(), np.asarray(js.n_accepted),
                                      err_msg=msg)
        gap = np.abs(ts.theta.numpy() - np.asarray(js.theta)) / sig
        assert gap.max() <= LOCKSTEP_TOL, f"{msg}: θ gap {gap.max():.3e} prior widths"
        np.testing.assert_allclose(ts.logp.numpy(), np.asarray(js.logp), rtol=0,
                                   atol=LOCKSTEP_TOL, err_msg=msg)
        for name in ADAPT_FIELDS:
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                       rtol=LOCKSTEP_TOL, atol=1e-300, err_msg=f"{msg} {name}")
    assert 0 < int(tfit.state.n_accepted.sum()) < N_CHAINS * N_STEPS
    assert not np.allclose(tfit.state.minv.numpy(), sig**2)  # the mass was refreshed
    assert tfit.state.log_eps == tfit.state.log_eps_bar  # frozen at the average
    if mode.startswith("chees"):
        assert tfit.state.log_traj == tfit.state.log_traj_bar
        assert float(tfit.state.traj_v) > 0  # Adam moved


def test_halton2_equals_jax():
    steps = np.arange(4096, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(jhmc._halton2))(jnp.asarray(steps)))
    got = np.array([float(thmc._halton2(torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps])
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0 and got[1] == 0.5 and got[3] == 0.75


class _EagerChunk(GraphChunk):
    """``GraphChunk``'s interface without a card: the warm-up call as the
    real one makes it, then each replay runs the function eagerly and
    writes the new state into the static state and the outputs at the
    index, as a replay of the captured graph writes them."""

    def __init__(self, step_fn, model, state, chunk, counters=()):
        self._fn, self._model, self.state = step_fn, model, state
        _, out = step_fn(model, tmcmc._generator_copies(state))
        self.outputs = {k: torch.empty((chunk,) + tuple(v.shape), dtype=v.dtype)
                        for k, v in out.items()}
        self.index = torch.zeros(1, dtype=torch.long)
        self.launches = {}

    def check_model(self, model):
        assert model is self._model

    def replay(self):
        if int(self.index) == 0:  # on the card a chunk's host copy is a copy, not a view
            for k, v in self.outputs.items():
                self.outputs[k] = torch.empty_like(v)
        new, out = self._fn(self._model, self.state)
        static = state_leaves(self.state)
        for k, v in state_leaves(new).items():
            if isinstance(v, torch.Tensor):
                static[k].copy_(v)
        for k, v in out.items():
            self.outputs[k].index_copy_(0, self.index, v.unsqueeze(0))
        if out:
            self.index.add_(1)


@pytest.fixture(scope="module")
def toy():
    return build_toy(n_events=1500, seed=5, e_grid_size=20, device="cpu")


@pytest.mark.parametrize("mode", ["jittered", "mala", "chees", "chees_static"])
def test_graph_runner_equals_eager_loop(toy, mode, monkeypatch):
    """The runner's contract through the captured path: chunks of 3 over 7
    steps (a last chunk shorter than the captured length), outputs, the
    state's fields and the generators bit-identical to the eager loop's;
    each replay counts its evaluations (the warm-up before a capture is
    one real call of the captured function)."""
    monkeypatch.setattr(thmc, "GraphChunk", _EagerChunk)
    th = _start_model(toy.model, 5)
    cfg = HMCConfig(**dict(BASE, **MODES[mode], step_size=0.02, chunk_size=3))
    runs, seen = {}, {}
    for graph in (True, False):
        fit = HMC(toy.model, cfg, th, seed=4, graph=False)
        fit.graph = graph
        chunks = []
        out = fit.run(n_steps=7, callback=lambda d, s, c: chunks.append((d, c["theta"].shape)))
        runs[graph], seen[graph] = (fit, out), chunks
    (fg, g), (fe, e) = runs[True], runs[False]
    assert seen[True] == seen[False] == [(3, (3, 5, 16)), (6, (3, 5, 16)), (7, (1, 5, 16))]
    segmented = mode == "chees"
    assert isinstance(fg._graph, thmc.SegmentedStep if segmented else _EagerChunk)
    assert fg.state is (fg._graph.static.state if segmented else fg._graph.state)
    assert g.keys() == e.keys() == {"theta", "logp", "accepted", "accept_prob", "n_leapfrog",
                                    "step_time"}
    for k in g:
        if k != "step_time":
            np.testing.assert_array_equal(g[k], e[k], err_msg=k)
    for k, v in state_leaves(fe.state).items():
        w = state_leaves(fg.state)[k]
        if isinstance(v, torch.Generator):
            assert torch.equal(v.get_state(), w.get_state())
        else:
            assert torch.equal(v, w), k
    # The warm-up before a capture: the whole step's iterations, or one.
    per_step = [int(n[0]) + 1 for n in e["n_leapfrog"]] if segmented else [fe._iterations] * 7
    assert fe.n_grad_evals == sum(per_step)
    assert fg.n_grad_evals == fe.n_grad_evals + (1 if segmented else fe._iterations)
    assert e["accepted"].any()


def _start_model(model, n_chains, frac=0.05):
    flat = model.flat
    sig = torch.sqrt(torch.diag(flat.chol @ flat.chol.T)).numpy()
    lo, hi = flat.low_bound.numpy(), flat.up_bound.numpy()
    th = flat.prefit.numpy() + frac * sig * np.random.default_rng(1).normal(
        size=(n_chains, len(sig)))
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))


def test_segmented_parts_equal_the_step(toy):
    """ChEES's three parts, run by hand as the segmented graphs run them
    (prologue, the length read once, length + 1 iterations, epilogue), give
    the single eager step's state and outputs bit for bit."""
    th = _start_model(toy.model, 4)
    cfg = HMCConfig(**dict(BASE, **MODES["chees"], step_size=0.02))
    a, b = (HMC(toy.model, cfg, th, seed=9, graph=False) for _ in range(2))
    for _ in range(3):
        a.state, out_a = a.step(a.state)
        traj = b.prologue(b.state)
        n = int(traj.n_shared)
        for _ in range(n + 1):
            traj = b.iterate(b.state, traj)
        assert int(traj.i) == n + 1 and (traj.n_active == n).all()
        b.state, out_b = b.epilogue(b.state, traj)
        for k in out_a:
            assert torch.equal(out_a[k], out_b[k]), k
    for k, v in state_leaves(a.state).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, state_leaves(b.state)[k]), k
    assert a.n_grad_evals == b.n_grad_evals


PLAIN = "a kernel's plain version"
HOST_READS = {"aten::_local_scalar_dense", "aten::item", "aten::nonzero", "aten::is_nonzero",
              "aten::_index_put_impl_"}


def _small_model(name, tmp_path):
    if name == "toy":
        return build_toy(n_events=1500, seed=5, e_grid_size=20, device="cpu").model
    if name == "large":
        from mach3_tpu_torch.tutorial.large import build_large

        return build_large(n_numu=3000, n_nue=1000, n_atmo=2000, e_grid_size=30,
                           atmo_e_grid_size=15, atmo_cosz_grid_size=6, device="cpu").model
    from mach3_tpu_torch.core.config import Config
    from mach3_tpu_torch.samples.experiment import build_experiment
    from mach3_tpu_torch.tutorial.experiment_files import write_experiment

    path = write_experiment(str(tmp_path), n_events=2000)
    return build_experiment(Config.from_file(str(path)), device="cpu").model


@pytest.mark.parametrize("name", ["toy", "large", "experiment"])
def test_gradient_evaluation_reads_nothing_on_the_host(name, tmp_path, monkeypatch):
    for mod, fns in ((reweight, ("fused_reweight_histogram_shifted_ref",
                                 "fused_reweight_histogram_shared_ref",
                                 "fused_reweight_histogram_ref")),
                     (grad, ("reweight_backward_ref",))):
        for fn in fns:
            def scoped(*a, _fn=getattr(mod, fn), **kw):
                with record_function(PLAIN):
                    return _fn(*a, **kw)
            monkeypatch.setattr(mod, fn, scoped)
    model = _small_model(name, tmp_path)
    fit = HMC(model, HMCConfig(), _start_model(model, 3), graph=False)
    with profile() as prof:
        _, g = fit.value_grad_batch(fit.state.theta)

    def in_plain(e):
        while e is not None and e.name != PLAIN:
            e = e.cpu_parent
        return e is not None

    events = prof.events()
    assert any(e.name == PLAIN for e in events)  # the kernels' stand-ins ran
    assert sorted({e.name for e in events if e.name in HOST_READS and not in_plain(e)}) == []
    assert torch.isfinite(g).all() and (g != 0).any()


@pytest.mark.parametrize("zeros", [False, True])
def test_graph_safe_gather_and_product(zeros):
    """``core.device.take`` equals advanced indexing, forward and backward;
    ``prod_last`` equals ``prod(-1)`` and, without a zero factor, its
    gradient bit for bit (with zeros, the product of the other factors)."""
    from mach3_tpu_torch.core.device import prod_last, take

    gen = torch.Generator().manual_seed(3)
    x = torch.randn(4, 6, 3, generator=gen)
    if zeros:
        x[0, 1, 2] = x[1, 2, 0] = x[1, 2, 1] = 0.0
    idx = torch.tensor([[2, 0], [5, 5], [1, 3]])
    a, b = (x.clone().requires_grad_(True) for _ in range(2))
    assert torch.equal(take(a, 1, idx), b[:, idx])
    g = torch.randn(4, 3, 2, 3, generator=gen)
    assert torch.equal(torch.autograd.grad(take(a, 1, idx), a, g)[0],
                       torch.autograd.grad(b[:, idx], b, g)[0])
    g = torch.randn(4, 6, generator=gen)
    assert torch.equal(prod_last(a), b.prod(-1))
    got, want = (torch.autograd.grad(f, t, g)[0] for f, t in ((prod_last(a), a), (b.prod(-1), b)))
    if zeros:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    else:
        assert torch.equal(got, want)
    assert torch.autograd.gradcheck(prod_last, (x.double().requires_grad_(True),))
