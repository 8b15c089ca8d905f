"""The port's auxiliary analysis modules against the JAX package's:
``core/modes.py``, ``params/tunes.py`` and ``samples/histograms.py`` (numpy
copies: results equal), ``poisson_fluctuate`` with a ``torch.Generator``
(checked in distribution: the JAX one takes a PRNG key), ``core/monitor.py``,
``samples/projection.py`` through the port's event layout (``event_perm``),
and two single-chain helpers, ``samples/sample.total_log_likelihood`` and
``osc/prob.evolution_operator``.

Tolerances: per-event weights within the response budget 2e-3 relative to
the largest weight (the port evaluates responses in f32, JAX production in
bf16), projections and rates within the histogram budget 2e-3, the total
-logL within 5e-3 + 1e-3·|NLL|, the evolution operator within 1e-12.
"""
import numpy as np
import pytest
import torch

from mach3_tpu.core.modes import MaCh3Modes as JMaCh3Modes
from mach3_tpu.params.tunes import ParameterTunes as JParameterTunes
from mach3_tpu.samples import histograms as jhist
from mach3_tpu.samples import projection as jproj
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.core import monitor
from mach3_tpu_torch.core.exceptions import ConfigError
from mach3_tpu_torch.core.modes import MaCh3Modes
from mach3_tpu_torch.params.parameterset import ParameterSet
from mach3_tpu_torch.params.tunes import ParameterTunes
from mach3_tpu_torch.samples import histograms as hist
from mach3_tpu_torch.samples import projection as proj
from mach3_tpu_torch.samples.sample import total_log_likelihood
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

BUDGET = 2e-3
NLL_ATOL, NLL_RTOL = 5e-3, 1e-3

MODES_CFG = {
    "Title": "Test modes",
    "GeneratorName": "NEUT",
    "Modes": [
        {"Name": "CCQE", "GeneratorMaping": [1], "PlotColor": 600, "SplineSuffix": "ccqe"},
        {"Name": "CCRES", "GeneratorMaping": [11, 12, 13]},
        {"Name": "NC", "GeneratorMaping": [31, 32], "IsNC": True},
    ],
}


def test_modes_match_jax():
    m, j = MaCh3Modes(MODES_CFG), JMaCh3Modes(MODES_CFG)
    assert m.n_modes == j.n_modes == 3
    assert [vars(x) for x in m.modes] == [vars(x) for x in j.modes]
    ids = np.array([1, 11, 13, 31, 99, -2, 0, 32])
    np.testing.assert_array_equal(m.mode_from_generator(ids), j.mode_from_generator(ids))
    assert list(m.mode_from_generator(ids[:6])) == [0, 1, 1, 2, 3, 3]
    assert m.nc_mode_indices() == j.nc_mode_indices() == [2]
    assert m.get_mode("CCQE").spline_suffix == "ccqe"
    with pytest.raises(ConfigError):
        m.get_mode("nope")
    dup = dict(MODES_CFG, Modes=[{"Name": "A", "GeneratorMaping": [1]},
                                 {"Name": "A", "GeneratorMaping": [2]}])
    with pytest.raises(ConfigError):
        MaCh3Modes(dup)


def test_tunes_match_jax():
    from mach3_tpu.params.parameterset import ParameterSet as JParameterSet

    cfg = {"Systematics": [
        {"Systematic": {"Names": {"FancyName": n}, "ParameterValues": {"PreFitValue": 1.0},
                        "StepScale": {"MCMC": 1.0}, "Error": 0.1, "ParameterBounds": [0, 2],
                        "Type": "Norm"}} for n in ["a", "b", "c"]]}
    tcfg = {"Tunes": [{"Name": "PostND", "Values": {"b": 1.3}},
                      {"Name": "Asimov", "Values": {"a": 0.9, "c": 1.1}}]}
    t, j = ParameterTunes(tcfg), JParameterTunes(tcfg)
    ps, jps = ParameterSet.from_config(cfg), JParameterSet.from_config(cfg)
    assert t.names() == j.names() == ["PostND", "Asimov"]
    for name in t.names():
        assert t.get_tune(name) == j.get_tune(name)
        np.testing.assert_array_equal(t.apply(ps, name), j.apply(jps, name))
        base = np.array([0.5, 0.6, 0.7])
        np.testing.assert_array_equal(t.apply(ps, name, base), j.apply(jps, name, base))
    with pytest.raises(ConfigError):
        t.get_tune("missing")
    with pytest.raises(ConfigError):
        ParameterTunes({"Tunes": [{"Name": "A", "Values": {}}, {"Name": "A", "Values": {}}]})


def test_histogram_helpers_match_jax():
    rng = np.random.default_rng(0)
    h2 = rng.gamma(2.0, 3.0, (3, 4))
    for axis in (0, 1):
        np.testing.assert_array_equal(hist.project(h2, axis), jhist.project(h2, axis))
    widths = (np.array([0.5, 1.0, 2.0]), np.array([1.0, 1.0, 0.5, 0.25]))
    assert hist.integral(h2) == jhist.integral(h2)
    assert hist.integral(h2, widths) == jhist.integral(h2, widths)
    np.testing.assert_array_equal(hist.normalise(h2), jhist.normalise(h2))
    num, den = np.array([2.0, 1.0, 3.0]), np.array([4.0, 0.0, 1.5])
    np.testing.assert_array_equal(hist.ratio(num, den), jhist.ratio(num, den))
    base = np.full(50, 100.0)
    np.testing.assert_array_equal(
        hist.poisson_fluctuate_by_sampling(base, np.random.default_rng(1)),
        jhist.poisson_fluctuate_by_sampling(base, np.random.default_rng(1)))
    throws = rng.poisson(50.0, size=(500, 10)).astype(float)
    a, b = hist.fill_violin(throws), jhist.fill_violin(throws)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    g = hist.th2poly_to_grid(h2, np.arange(4.0), np.arange(5.0))
    gj = jhist.th2poly_to_grid(h2, np.arange(4.0), np.arange(5.0))
    for k in g:
        np.testing.assert_array_equal(g[k], gj[k])


def test_poisson_fluctuate_with_a_generator():
    """Draws on the generator's device, f64, reproducible from its seed;
    mean and variance of Poisson(λ) per bin over 4,000 throws; negative
    contents count as 0."""
    lam = np.array([0.0, 0.5, 3.0, 20.0, 150.0, -4.0])
    gen = torch.Generator().manual_seed(7)
    draws = hist.poisson_fluctuate(np.tile(lam, (4000, 1)), gen)
    assert draws.dtype == torch.float64 and draws.device == gen.device
    again = hist.poisson_fluctuate(np.tile(lam, (4000, 1)), torch.Generator().manual_seed(7))
    assert torch.equal(draws, again)
    d = draws.numpy()
    want = np.maximum(lam, 0.0)
    assert np.all(d >= 0) and np.all(d == np.round(d))
    assert np.all(d[:, [0, 5]] == 0)
    se = np.sqrt(np.maximum(want, 1e-12) / 4000)
    assert np.all(np.abs(d.mean(0) - want) <= 5 * se + 1e-12)
    np.testing.assert_allclose(d.var(0)[1:5], want[1:5], rtol=0.1)
    # the JAX function on the same contents: the same distribution
    import jax

    dj = np.asarray(jax.vmap(lambda k: jhist.poisson_fluctuate(lam, k))(
        jax.random.split(jax.random.key(0), 4000)))
    assert np.all(np.abs(d.mean(0) - dj.mean(0)) <= 7 * se + 1e-12)


def test_monitor_on_the_cpu():
    assert "count" in monitor.get_cpu_info()
    info = monitor.get_device_info()
    if torch.cuda.is_available():
        assert info[0]["platform"] == "gpu" and info[0]["bytes_limit"] > 0
    else:
        assert info == []
    monitor.welcome()
    bar = monitor.ProgressBar(10, label="test", every=0.5)
    for i in range(1, 11):
        bar.update(i, acc=0.25)


@pytest.fixture(scope="module")
def toys():
    kw = dict(n_events=2000, seed=12, e_grid_size=40)
    return jbuild_toy(**kw), build_toy(**kw, device="cpu")


@pytest.mark.parametrize("shifted", [False, True], ids=["prefit", "moved"])
def test_projection_matches_jax_through_the_layout(toys, shifted):
    """Per-event weights in the builder's order, projections with a
    category split and a selection, and the rate table: the port's laid-out
    samples against JAX's."""
    jt, tt = toys
    theta = np.array(jt.model.prefit_vector())
    if shifted:
        theta[:9] += 0.05 * np.random.default_rng(0).normal(size=9)
    edges = np.linspace(0, 3, 16)
    for i, (js, ts) in enumerate(zip(jt.samples, tt.samples)):
        assert ts.event_perm is not None and ts.n_events > js.n_events  # laid out, padded
        wj = jproj.event_weights(js, theta)
        wt = proj.event_weights(ts, theta)
        assert wt.shape == wj.shape
        assert np.max(np.abs(wt - wj)) <= BUDGET * np.abs(wj).max()
        cat = jt.event_modes[i]
        select = np.arange(js.n_events) % 3 != 0
        pj = jproj.project(js, theta, 1, edges, category=cat, select=select)
        pt = proj.project(ts, theta, 1, edges, category=cat, select=select)
        np.testing.assert_array_equal(pt["edges"], pj["edges"])
        for a, b in [(pt["total"], pj["total"])] + [
                (pt["categories"][c], pj["categories"][c]) for c in pj["categories"]]:
            np.testing.assert_allclose(a, b, rtol=BUDGET, atol=1e-6 * np.abs(b).max())
        assert pt["categories"].keys() == pj["categories"].keys()
    rj = jproj.event_rate_table(jt.samples, theta, jt.event_modes)
    rt = proj.event_rate_table(tt.samples, theta, tt.event_modes)
    assert rt.keys() == rj.keys()
    for k in rj:
        assert rt[k].keys() == rj[k].keys()
        for c in rj[k]:
            assert rt[k][c] == pytest.approx(rj[k][c], rel=BUDGET)


def test_projection_of_the_asimov_total(toys):
    """The JAX test's property: the projection onto the binning variable at
    prefit holds the Asimov data's total."""
    _, tt = toys
    s0 = tt.samples[0]
    p = proj.project(s0, tt.model.prefit_vector(), 1, np.linspace(0, 3, 16))
    assert p["total"].sum() == pytest.approx(float(s0.data.sum()), rel=1e-5)


def test_builder_order_round_trip(toys):
    _, tt = toys
    s = tt.samples[1]
    x = np.arange((~s.event_pad).sum().item(), dtype=np.float64)
    np.testing.assert_array_equal(proj.builder_order(s, proj.laid_out(s, x)), x)


def test_total_log_likelihood_matches_jax(toys):
    from mach3_tpu.samples.sample import total_log_likelihood as jtotal

    jt, tt = toys
    theta = np.array(jt.model.prefit_vector())
    theta[:9] += 0.1 * np.random.default_rng(1).normal(size=9)
    ref = float(jtotal(jt.samples, theta))
    got = total_log_likelihood(tt.samples, torch.from_numpy(theta))
    assert got.dtype == torch.float64 and got.shape == ()
    assert abs(float(got) - ref) <= NLL_ATOL + NLL_RTOL * abs(ref)
    parts = tt.model.sample_nll_breakdown(torch.from_numpy(theta))
    assert float(got) == pytest.approx(float(parts.sum()), rel=1e-12)


def test_evolution_operator_matches_jax_and_eigh():
    """exp(-i H L) of the matter Hamiltonian at 12 energies against JAX's
    ``evolution_operator`` and an ``eigh`` reference (the JAX test's)."""
    import jax.numpy as jnp
    from mach3_tpu.osc.prob import evolution_operator as jevolve
    from mach3_tpu_torch.osc import pmns
    from mach3_tpu_torch.osc.prob import evolution_operator

    angles = (np.arcsin(np.sqrt(0.307)), np.arcsin(np.sqrt(0.022)), np.arcsin(np.sqrt(0.561)),
              -1.601)
    e = np.linspace(0.3, 5.0, 12)
    u = pmns.pmns_matrix(*angles)
    h = pmns.hamiltonian_per_km(pmns.mass_matrix(u, 7.42e-5, 2.51e-3, torch.from_numpy(e),
                                                 torch.tensor(2.8)), torch.from_numpy(e))
    got = evolution_operator(h, 810.0)
    assert got.dtype == torch.complex128 and got.shape == (12, 3, 3)
    # the same Hamiltonian into both (the complex PMNS forms are held in
    # test_torch_single_chain.py)
    np.testing.assert_allclose(got.numpy(), np.asarray(jevolve(jnp.asarray(h.numpy()), 810.0)),
                               rtol=0, atol=1e-12)
    lam, v = torch.linalg.eigh(h)
    ref = torch.einsum("eij,ej,ekj->eik", v, torch.exp(-1j * lam * 810.0), v.conj())
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-9)
