"""The port's gradient fitters (``fitters/hmc.py``, ``fitters/minimize.py``)
vs the JAX package's, on the toy at test size.

Both sides differentiate the same function: JAX's samples take its XLA route
with the f32-oracle spline eval (``eval_dense(exact=True)``, patched into
its ``sample`` module for the test), the port's samples its fused route (the
kernels' plain versions forward, the two backward passes of
``splines/grad.py``), bridged from the same JAX model. Their gradients agree
to ≤ 2e-3 of the largest component (``tests/test_torch_grad.py``).

* HMC in lockstep: the draws of JAX's key splits (``hmc.py:216``) are
  injected into the port's step; fixed-length, jittered and ChEES
  trajectories, 5 steps each across the end of every adaptation window.
  θ within 3e-5 of each prior width, logp within 2e-4, log ε, the inverse
  mass and log T within 1e-4 relative, and the same accept decisions.
* The minimiser: with the oscillation parameters fixed, JAX's L-BFGS-B and
  the port's reach the same χ² (1e-4), the same best fit within 1e-3 of
  each prior width (measured 3.0e-4: the two stop at different points of
  the valley, one stepping in x, one in prior widths) and the same Hesse
  errors within 1e-3 relative (measured 1.7e-5). With them free, JAX's stops at its
  start (its first step along −g is 1/|g| long, and the Δm² gradients are
  ~1e4), the port's, which steps in prior-width units, reaches the Asimov
  minimum once the energy scale, whose χ² is a staircase with no gradient,
  is held at its prefit value (``shift_params``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.fitters import hmc as jhmc
from mach3_tpu.fitters.minimize import run_minimizer as jrun_minimizer
from mach3_tpu.samples import sample as jsample
from mach3_tpu.splines.eval import eval_dense as jeval_dense
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.bridge import from_jax_model
from mach3_tpu_torch.fitters.hmc import HMC, HMCConfig
from mach3_tpu_torch.fitters.minimize import bounds_of, run_minimizer, shift_params
from mach3_tpu_torch.kernels.launch import LAUNCHES

torch.set_num_threads(1)

TOY = dict(n_events=1500, seed=11, e_grid_size=30, flip_hierarchy=True)
N_CHAINS, N_STEPS = 4, 5
# Measured over the three cases' 5 steps: θ 6.3e-6 prior widths, logp
# 4.2e-5, adaptation state 1.7e-5 relative (the f32 likelihood's gradient
# gap, integrated by the leapfrog and fed back through the adaptation).
THETA_ATOL = 3e-5  # x each parameter's prior width
LOGP_ATOL = 2e-4
ADAPT_RTOL = 1e-4


@pytest.fixture(scope="module")
def models():
    """(JAX model on its XLA route with the f32-oracle spline eval, the
    port's model bridged from it, prior widths [NP])."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jsample, "eval_dense",
               lambda table, params: jeval_dense(table, params, exact=True))
    mp.setattr(jsample.SampleModel, "_diff_route", lambda self: None)
    jm = jbuild_toy(**TOY, use_pallas=True).model
    tm = from_jax_model(jm)
    assert [s._diff_route() for s in tm.samples] == ["shifted", "shifted"]
    chol = np.asarray(jm._flat().chol)
    yield jm, tm, np.sqrt(np.diag(chol @ chol.T))
    mp.undo()


def _start(jm, n_chains, seed, frac=0.05):
    flat = jm._flat()
    chol = np.asarray(flat.chol)
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = np.asarray(flat.low_bound), np.asarray(flat.up_bound)
    th = np.asarray(flat.prefit) + frac * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))


HMC_CASES = {
    "fixed": dict(n_leapfrog=3, jitter_trajectory=False),
    "jittered": dict(n_leapfrog=4, jitter_trajectory=True),
    "chees": dict(adapt_trajectory=True, max_leapfrog=6, initial_traj_length=0.1),
}


@pytest.mark.parametrize("case", list(HMC_CASES))
def test_hmc_lockstep(models, case):
    jm, tm, sig = models
    kw = dict(step_size=0.03, chunk_size=1, adapt_steps=3, mass_start_update=0,
              mass_update_every=2, **HMC_CASES[case])
    th = _start(jm, N_CHAINS, seed=2)
    jfit = jhmc.HMC(jm, jhmc.HMCConfig(**kw), th, seed=7)
    before = dict(LAUNCHES)
    tfit = HMC(tm, HMCConfig(**kw), th)
    np.testing.assert_allclose(tfit.state.logp.numpy(), np.asarray(jfit.state.logp),
                               atol=LOGP_ATOL, rtol=0)
    n_grad = 0
    for step in range(N_STEPS):
        _, k_mom, k_acc, k_len = jax.random.split(jfit.state.key, 4)
        z = np.array(jax.random.normal(k_mom, th.shape, jnp.float64))
        u = np.array(jax.random.uniform(k_acc, (N_CHAINS,), jnp.float64))
        n_len = np.array(jax.random.randint(k_len, (N_CHAINS,), 1, kw.get("n_leapfrog", 16) + 1))
        jfit.run(n_steps=1, collect=False)
        grads = tfit.n_grad_evals
        tfit.state, out = tfit.step(
            tfit.state, z=torch.from_numpy(z), u=torch.from_numpy(u),
            n_active=torch.from_numpy(n_len) if case == "jittered" else None)
        n_grad += tfit.n_grad_evals - grads
        js, ts = jfit.state, tfit.state
        np.testing.assert_array_equal(ts.n_accepted.numpy(), np.asarray(js.n_accepted),
                                      err_msg=f"step {step}")
        gap = np.abs(ts.theta.numpy() - np.asarray(js.theta)) / sig
        assert gap.max() <= THETA_ATOL, f"step {step}: θ gap {gap.max():.3e} prior widths"
        np.testing.assert_allclose(ts.logp.numpy(), np.asarray(js.logp), atol=LOGP_ATOL, rtol=0)
        for name in ("log_eps", "log_eps_bar", "minv", "log_traj"):
            np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                       rtol=ADAPT_RTOL, err_msg=f"step {step} {name}")
        if case == "chees":  # one shared length per step
            assert (out["n_leapfrog"] == out["n_leapfrog"][0]).all()
    assert int(tfit.state.n_accepted.sum()) > 0
    assert not np.allclose(tfit.state.minv.numpy(), sig**2)  # the mass was refreshed
    assert tfit.n_logp_evals == 1 and LAUNCHES == before  # CPU: no launches
    if case == "fixed":
        assert n_grad == N_STEPS * (kw["n_leapfrog"] + 1)


def test_hmc_run_collects_chunks(models):
    jm, tm, _ = models
    th = _start(jm, 3, seed=4)
    fit = HMC(tm, HMCConfig(n_leapfrog=2, step_size=0.02, chunk_size=2, adapt_steps=2), th,
              seed=3)
    out = fit.run(n_steps=5)
    assert out["theta"].shape == (5, 3, th.shape[1]) and out["step_time"].shape == (5,)
    assert np.isfinite(out["logp"]).all() and fit.state.step == 5
    np.testing.assert_allclose(out["theta"][-1], fit.state.theta.numpy())
    assert fit.n_grad_evals == sum(int(n.max()) + 1 for n in out["n_leapfrog"])


def test_chees_static_bound_runs_the_same_transition(models):
    """``chees_static_bound`` integrates max_leapfrog + 1 masked iterations
    instead of the step's own n + 1: the same transition, exactly, for more
    gradient evaluations."""
    jm, tm, _ = models
    th = _start(jm, N_CHAINS, seed=6)
    gen = torch.Generator().manual_seed(5)
    draws = [(torch.randn(th.shape, generator=gen, dtype=torch.float64),
              torch.rand(N_CHAINS, generator=gen, dtype=torch.float64)) for _ in range(2)]
    fits = []
    for static in (False, True):
        fit = HMC(tm, HMCConfig(step_size=0.03, adapt_trajectory=True, max_leapfrog=6,
                                initial_traj_length=0.1, adapt_steps=3,
                                chees_static_bound=static), th)
        lengths = []
        for z, u in draws:
            fit.state, out = fit.step(fit.state, z=z, u=u)
            lengths.append(int(out["n_leapfrog"][0]))
        fits.append((fit, lengths))
    (dyn, len_d), (sta, len_s) = fits
    assert torch.equal(dyn.state.theta, sta.state.theta)
    assert torch.equal(dyn.state.logp, sta.state.logp)
    assert torch.equal(dyn.state.log_traj, sta.state.log_traj)
    assert len_d == len_s and max(len_d) < 6
    assert dyn.n_grad_evals == sum(n + 1 for n in len_d) and sta.n_grad_evals == 2 * (6 + 1)


OSC = slice(10, 16)


def _jax_hesse_errors(jm, x, free):
    """JAX's Hesse errors at ``x``: 2 H⁻¹ of ``jax.hessian`` of its χ²
    (``minimize._chi2_of``) over the free parameters — what its
    ``run_minimizer`` inverts, without the fixed rows it drops."""
    from mach3_tpu.fitters.minimize import _chi2_of

    xj, idx = jnp.asarray(x), np.flatnonzero(free)
    h = jax.jit(jax.hessian(lambda xf: _chi2_of(jm, xj.at[idx].set(xf))))(xj[idx])
    return np.sqrt(np.diag(2.0 * np.linalg.inv(np.asarray(h))))


def test_minimizer_matches_jax_with_osc_fixed(models):
    jm, tm, sig = models
    x0 = _start(jm, 1, seed=21, frac=0.5)[0]
    fixed = np.zeros(len(x0), bool)
    fixed[OSC] = True
    want = jrun_minimizer(jm, x0=x0, fixed=fixed, run_hesse=False)
    got = run_minimizer(tm, x0=x0, fixed=fixed)
    assert got.success and want.success
    assert got.chi2 == pytest.approx(want.chi2, abs=1e-4)
    np.testing.assert_array_equal(got.x[OSC], x0[OSC])
    assert (np.abs(got.x - want.x) <= 1e-3 * sig).all()
    np.testing.assert_allclose(got.errors[~fixed], _jax_hesse_errors(jm, want.x, ~fixed),
                               rtol=1e-3)
    assert (got.errors[OSC] == 0).all()
    lo, hi = np.asarray(bounds_of(tm)).T
    assert ((got.x >= lo) & (got.x <= hi)).all()


def test_minimizer_converges_where_jax_stalls(models):
    jm, tm, sig = models
    x0 = _start(jm, 1, seed=21, frac=0.5)[0]
    stalled = jrun_minimizer(jm, x0=x0, run_hesse=False)
    assert stalled.n_evaluations <= 5 and np.allclose(stalled.x, x0)
    prefit = tm.prefit_vector().numpy()
    shifts = shift_params(tm)
    assert [tm.samples[0].shifts[0].param_index] == shifts == [9]  # the energy scale
    fixed = np.zeros(len(x0), bool)
    fixed[shifts] = True
    x0[fixed] = prefit[fixed]  # its χ² is a staircase with no gradient
    got = run_minimizer(tm, x0=x0, fixed=fixed)
    assert got.success and got.chi2 < 1e-4 < stalled.chi2
    assert (np.abs(got.x - prefit) <= 1e-3 * sig).all()  # the Asimov minimum
    assert got.covariance is not None and np.isfinite(got.errors).all()
    assert (got.errors[fixed] == 0).all()
    free = ~fixed
    cov = got.covariance[np.ix_(free, free)]
    assert (np.linalg.eigvalsh(cov) > 0).all()  # a positive-definite Hessian
