"""The port's single-chain surface, the complex PMNS forms and the toy's
octant and override options against the JAX package.

* ``FitModel.propose`` / ``prior_nll`` / ``sample_nll`` /
  ``sample_nll_breakdown`` / ``total_nll`` / ``parameter_names`` on the toy
  at 1,500 events against JAX's single-chain methods (its XLA route): the
  prior is the same f64 arithmetic (1e-12), the sample NLLs within the
  production budget 5e-3 + 1e-3·|NLL| (JAX evaluates responses with bf16
  deviations, the port in f32), an out-of-bounds θ gives the sentinel
  exactly. Proposals with JAX's draws injected agree within 1e-12.
* ``params.state``'s ``propose_step``, ``count_out_of_bounds`` and
  ``get_likelihood`` on the same numpy inputs: equal, or within 1e-12.
* ``pmns_matrix``, ``mass_matrix`` and ``hamiltonian_per_km`` in complex128:
  atol 1e-12.
* ``build_toy``'s options and ``build_octant_toy`` (NH, IH) at 3,000 events:
  the same events (through the port's event layout) and priors as JAX's,
  Asimov data within the histogram budget 2e-3 (+1e-6 of the largest bin).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.osc import pmns as jpmns
from mach3_tpu.params import state as jstate
from mach3_tpu.samples.teststats import TestStatistic as JTestStatistic
from mach3_tpu.tutorial.toy import build_octant_toy as jbuild_octant_toy
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.core.precision import LARGE_LOGL
from mach3_tpu_torch.osc import pmns
from mach3_tpu_torch.params import state
from mach3_tpu_torch.samples.teststats import TestStatistic
from mach3_tpu_torch.tutorial.toy import build_octant_toy, build_toy

torch.set_num_threads(1)

TOY = dict(n_events=1500, seed=11, e_grid_size=30, flip_hierarchy=True)
HIST_BUDGET = 2e-3
NLL_ATOL, NLL_RTOL = 5e-3, 1e-3
PRIOR_FIELDS = ("prefit", "inv_cov", "chol", "step_scale", "low_bound", "up_bound",
                "flat_prior", "fixed", "circ_mask", "circ_low", "circ_high", "flip_mask",
                "flip_point")


@pytest.fixture(scope="module")
def jtoy():
    return jbuild_toy(**TOY, use_pallas=False)


@pytest.fixture(scope="module")
def ttoy():
    return build_toy(**TOY, device="cpu")


def _points(model, rng):
    """Prefit, two jittered points inside the bounds, and one with two
    parameters out of bounds (a norm below 0, sin²θ23 above 0.7)."""
    flat = model._flat() if hasattr(model, "_flat") else model.flat
    chol = np.asarray(flat.chol)
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = np.asarray(flat.low_bound), np.asarray(flat.up_bound)
    prefit = np.array(flat.prefit)
    pts = [prefit]
    for _ in range(2):
        pts.append(np.clip(prefit + 0.3 * sig * rng.normal(size=len(sig)), lo + 1e-9, hi - 1e-9))
    oob = prefit.copy()
    oob[0], oob[12] = -0.2, 0.75
    pts.append(oob)
    return pts


def _jitted(name):
    return jax.jit(lambda m, t: getattr(m, name)(t))


def test_single_chain_methods_match_jax(jtoy, ttoy):
    jm, tm = jtoy.model, ttoy.model
    j = {n: _jitted(n) for n in ("prior_nll", "sample_nll_breakdown", "sample_nll", "total_nll",
                                 "prior_nll_breakdown")}
    for i, th in enumerate(_points(jm, np.random.default_rng(4))):
        jt, tt = jnp.asarray(th), torch.from_numpy(th)
        j_prior, t_prior = float(j["prior_nll"](jm, jt)), float(tm.prior_nll(tt))
        assert t_prior == pytest.approx(j_prior, rel=1e-12, abs=1e-12)
        j_parts = np.asarray(j["sample_nll_breakdown"](jm, jt))
        t_parts = tm.sample_nll_breakdown(tt).numpy()
        np.testing.assert_allclose(t_parts, j_parts, rtol=NLL_RTOL, atol=NLL_ATOL)
        assert float(tm.sample_nll(tt)) == pytest.approx(t_parts.sum(), rel=1e-14)
        assert float(tm.sample_nll(tt)) == pytest.approx(float(j["sample_nll"](jm, jt)),
                                                         rel=NLL_RTOL, abs=2 * NLL_ATOL)
        j_total, t_total = float(j["total_nll"](jm, jt)), float(tm.total_nll(tt))
        if i == 3:  # out of bounds: two parameters in two handlers, two samples
            assert t_prior == j_prior == 2 * LARGE_LOGL
            assert t_total == j_total == 2 * LARGE_LOGL + 2 * LARGE_LOGL
        else:
            assert t_prior < LARGE_LOGL
            assert t_total == pytest.approx(j_total, rel=NLL_RTOL, abs=2 * NLL_ATOL)
        np.testing.assert_allclose(tm.prior_nll_breakdown(tt).numpy(),
                                   np.asarray(j["prior_nll_breakdown"](jm, jt)), rtol=1e-12,
                                   atol=1e-12)
    assert tm.parameter_names([ttoy.xsec, ttoy.osc]) == jm.parameter_names([jtoy.xsec, jtoy.osc])


def test_single_chain_is_the_batch_at_one_chain(ttoy):
    tm = ttoy.model
    th = torch.from_numpy(np.stack(_points(tm, np.random.default_rng(2))))
    total, prior, samples = tm.total_nll_batch_parts(th)
    for c in range(th.shape[0]):
        assert float(tm.total_nll(th[c])) == float(total[c])
        assert float(tm.prior_nll(th[c])) == float(prior[c].sum())
        assert torch.equal(tm.sample_nll_breakdown(th[c]), samples[c])
        for s in range(len(tm.samples)):
            assert float(tm.samples[s].log_likelihood(th[c])) == float(samples[c, s])


def _jax_proposal_draws(key, n_cols, n_params):
    """The draws of JAX's ``propose_step`` from ``key`` (state.py:135-151)."""
    key_n, key_f = jax.random.split(key)
    z = np.array(jax.random.normal(key_n, (n_cols,), dtype=jnp.float64))
    flip_u = np.array(jax.random.uniform(key_f, (n_params,)))
    return z, flip_u


def test_propose_matches_jax(jtoy, ttoy):
    jm, tm = jtoy.model, ttoy.model
    flat = jm._flat()
    n_cols, n_params = np.asarray(flat.chol).shape[1], tm.n_params
    flipped = 0
    pts = _points(jm, np.random.default_rng(6))[:3]
    for i in range(8):
        th = pts[i % 3]
        key = jax.random.key(100 + i)
        z, flip_u = _jax_proposal_draws(key, n_cols, n_params)
        want = np.asarray(jax.jit(lambda m, t, k: m.propose(t, k))(jm, jnp.asarray(th), key))
        got = tm.propose(torch.from_numpy(th), z=torch.from_numpy(z),
                         flip_u=torch.from_numpy(flip_u)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        flipped += int(np.sign(got[-1]) != np.sign(th[-1]))
        gen = torch.Generator().manual_seed(i)
        drawn = tm.propose(torch.from_numpy(th), generator=gen)
        assert drawn.shape == (n_params,) and torch.isfinite(drawn).all()
    assert flipped > 0  # the mass-ordering flip was exercised


def test_state_helpers_match_jax(jtoy, ttoy):
    jflat, tflat = jtoy.model._flat(), ttoy.model.flat
    rng = np.random.default_rng(9)
    pts = np.stack(_points(jtoy.model, rng))
    pts[2, 5:9] = 5.0  # four spline parameters above their +3 bound
    for th in pts:
        jt, tt = jnp.asarray(th), torch.from_numpy(th)
        assert int(state.count_out_of_bounds(tflat, tt)) == int(
            jstate.count_out_of_bounds(jflat, jt))
        assert float(state.get_likelihood(tflat, tt)) == pytest.approx(
            float(jstate.get_likelihood(jflat, jt)), rel=1e-12, abs=1e-12)
        z, flip_u = _jax_proposal_draws(jax.random.key(3), np.asarray(jflat.chol).shape[1],
                                        len(th))
        want = np.asarray(jstate.propose_step(jflat, jt, jax.random.key(3), z=jnp.asarray(z)))
        got = state.propose_step(tflat, tt, z=torch.from_numpy(z),
                                 flip_u=torch.from_numpy(flip_u)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    counts = state.count_out_of_bounds(tflat, torch.from_numpy(pts))
    assert counts.dtype == torch.int32 and counts.tolist() == [0, 0, 4, 2]


def test_propose_step_batch_per_chain_scale(ttoy):
    """``scale [C]`` multiplies each chain's step, as JAX's ``scale=``."""
    flat = ttoy.model.flat
    th = flat.prefit[None].repeat(3, 1)
    z = torch.from_numpy(np.random.default_rng(1).normal(size=(3, flat.chol.shape[1])))
    flip_u = torch.ones(3, flat.n_params)  # no flips
    one = state.propose_step_batch(flat, th, z=z, flip_u=flip_u)
    scaled = state.propose_step_batch(flat, th, z=z, flip_u=flip_u,
                                      scale=torch.tensor([1.0, 2.0, 0.5], dtype=torch.float64))
    free = ~(flat.circ_mask | flat.fixed)
    d1, ds = (one - th)[:, free], (scaled - th)[:, free]
    torch.testing.assert_close(ds, d1 * torch.tensor([[1.0], [2.0], [0.5]], dtype=torch.float64),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("angles", [(0.58, 0.15, 0.84, -1.6), (0.0, 0.0, 0.0, 0.0),
                                    (1.2, 0.3, 0.2, 2.9)])
@pytest.mark.parametrize("anti", [False, True], ids=["nu", "antinu"])
def test_complex_pmns_matches_jax(angles, anti):
    u_j = np.asarray(jpmns.pmns_matrix(*angles))
    u_t = pmns.pmns_matrix(*angles)
    assert u_t.dtype == torch.complex128
    np.testing.assert_allclose(u_t.numpy(), u_j, rtol=0, atol=1e-12)
    energy = np.geomspace(0.2, 20.0, 7)
    rho = np.linspace(0.0, 4.0, 7)
    m_j = np.asarray(jpmns.mass_matrix(jnp.asarray(u_j), 7.42e-5, -2.5e-3, jnp.asarray(energy),
                                       jnp.asarray(rho), antineutrino=anti))
    m_t = pmns.mass_matrix(u_t, 7.42e-5, -2.5e-3, torch.from_numpy(energy),
                           torch.from_numpy(rho), antineutrino=anti)
    np.testing.assert_allclose(m_t.numpy(), m_j, rtol=0, atol=1e-12 * np.abs(m_j).max())
    h_j = np.asarray(jpmns.hamiltonian_per_km(jnp.asarray(m_j), jnp.asarray(energy)))
    h_t = pmns.hamiltonian_per_km(m_t, torch.from_numpy(energy))
    np.testing.assert_allclose(h_t.numpy(), h_j, rtol=0, atol=1e-12 * np.abs(h_j).max())
    # The real-pair form agrees with the complex one.
    ur, ui = pmns.pmns_matrix_real(*angles)
    np.testing.assert_allclose(ur.numpy() + 1j * ui.numpy(), u_j, rtol=0, atol=1e-12)


def _same_build(jt, tt):
    """Events (through the port's layout), priors and test statistic equal;
    the Asimov data within the histogram budget."""
    jf, tf = jt.model._flat(), tt.model.flat
    for f in PRIOR_FIELDS:
        assert np.array_equal(np.asarray(getattr(jf, f)), getattr(tf, f).numpy()), f
    assert tt.names == jt.names
    for js, ts in zip(jt.samples, tt.samples):
        perm, pad = ts.event_perm.numpy(), ts.event_pad.numpy()
        assert np.array_equal(np.sort(perm[~pad]), np.arange(js.n_events))
        assert np.array_equal(np.asarray(js.kin)[:, perm], ts.kin.numpy())
        assert np.array_equal(np.where(pad, 0.0, np.asarray(js.mc_weight)[perm]).astype(np.float32),
                              ts.mc_weight.numpy())
        for f in ("e_grid", "chan_alpha", "chan_beta"):
            assert np.array_equal(np.asarray(getattr(js.osc, f)), getattr(ts.osc, f).numpy()), f
        assert (ts.osc.baseline, ts.osc.density) == (js.osc.baseline, js.osc.density)
        assert ts.test_statistic.name == js.test_statistic.name
        data_j = np.asarray(js.data)
        np.testing.assert_allclose(ts.data.numpy(), data_j, rtol=HIST_BUDGET,
                                   atol=1e-6 * np.abs(data_j).max())


def test_build_toy_options_match_jax():
    kw = dict(n_events=3000, seed=5, e_grid_size=40, baseline=810.0, density=2.8,
              osc_entry_overrides={"sin2th23": {"ParameterBounds": [0.35, 0.65]},
                                   "delta_cp": {"Error": 0.5}},
              asimov_overrides={"osc_sin2th23": 0.48, "xsec_norm_ccqe": 1.1})
    jt = jbuild_toy(**kw, test_statistic=JTestStatistic.POISSON, use_pallas=False)
    tt = build_toy(**kw, test_statistic=TestStatistic.POISSON, device="cpu")
    _same_build(jt, tt)
    assert tt.samples[0].test_statistic == TestStatistic.POISSON
    assert float(tt.osc.low_bounds[2]) == 0.35
    # The Asimov truth moved the data: at the prefit point the NLL is not 0.
    assert float(tt.model.sample_nll(tt.model.prefit_vector())) > 1.0


@pytest.mark.parametrize("hierarchy", ["NH", "IH"])
def test_build_octant_toy_matches_jax(hierarchy):
    jt = jbuild_octant_toy(n_events=3000, hierarchy=hierarchy, use_pallas=False)
    tt = build_octant_toy(n_events=3000, hierarchy=hierarchy, device="cpu")
    _same_build(jt, tt)
    assert [s.kernel_route.variant for s in tt.samples] == ["shifted", "shifted"]
    i31 = tt.names.index("osc_dm2_31")
    lo, hi = float(tt.model.flat.low_bound[i31]), float(tt.model.flat.up_bound[i31])
    assert (lo > 0) if hierarchy == "NH" else (hi < 0)
    with pytest.raises(ValueError):
        build_octant_toy(n_events=100, hierarchy="XX", device="cpu")


def test_octant_toys_share_the_nh_data():
    """Both orderings fit the same Asimov data, made at the NH truth."""
    nh = build_octant_toy(n_events=3000, hierarchy="NH", device="cpu")
    ih = build_octant_toy(n_events=3000, hierarchy="IH", device="cpu")
    for a, b in zip(nh.samples, ih.samples):
        assert torch.equal(a.data, b.data)
