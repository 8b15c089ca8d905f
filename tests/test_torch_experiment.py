"""The YAML experiment path of the port (``samples/experiment.py``,
``tutorial/experiment_files.py``) vs the JAX package, both built from the
same files (``write_experiment`` at 3,000 events).

* Routes (generic, generic, shared with no parameter tile), parameter names,
  bin counts and ``NonUniformBinning.find_bins`` are the JAX package's
  exactly; JAX builds the hyper-rectangle sample with a placeholder binning
  and swaps it in (``with_binning``), the port builds it directly.
* TF1 responses (floored at 0) and the weight function's response within
  rtol 1e-6 (f32 arithmetic, same order); event weights within the
  production budget 2e-3 of ``tests/test_torch_toy.py`` (JAX's spline eval
  rounds response deviations to bf16).
* Asimov data within 2e-3 relative (the same budget). Per-sample NLLs at 8
  jittered chains, the port's kernel routes (the kernels' plain versions on
  the CPU) with JAX's data: within 5e-3 + 1e-3·|NLL| of JAX's XLA route
  (the toy's budget) and within 1e-4 + 1e-6·|NLL| of the f32 oracle (JAX pieces,
  ``eval_dense(exact=True)``, shifts formed with the f32 value as the port
  forms them). Measured: ≤ 1.5e-3 from the XLA route, ≤ 3.8e-6 from the
  oracle, at |NLL| up to ~1e3.
* The port's kernel routes (the shared and generic routes' layouts
  included) against its own plain route: rtol 1e-6, atol 1e-5.
* The generic samples' bin maps (their bins formed in the kernel), on the
  bridge's copy of JAX's samples, against JAX's
  ``binning.find_bins(_shifted_kinematics)`` per chain, through the layout's
  ``event_perm``: equal but for events whose shifted value lies within one
  f32 ulp of an edge (JAX shifts with the f64 value, the port with the f32
  one: ROADMAP Queue 3), which are counted and must be few. The laid-out
  generic samples' histograms through the kernel route within the
  production budget 2e-3 of JAX's XLA route.
* The gradient of the per-chain samples through ``fused_reweight_diff_perchain``
  (plain versions, hand-written backward) and of ``log_posterior_batch``
  against ``jax.grad`` of the f32 oracle above: 2e-3 of each chain's
  largest component, the scale of ``tests/test_torch_grad.py`` (f32 sums in
  another order); measured ≤ 1.4e-4 per sample and 3.0e-5 for the
  posterior. Chains start off the prefit point, where the gradient is ~0
  and has no scale.
* A single ``offset`` or ``scale_about_one`` shift takes the shifted route in
  both packages, and the port's NLL matches JAX's XLA route.
* The ``ConfigError`` cases, the bridge (TF1 tables and hyper-rectangle
  binnings cross; weight functions raise), ``with_binning`` rebuilding the
  shared layout, the card as the builders' default device, and no jax in a
  process that builds the experiment and imports ``chip_smoke``.
"""
import copy
import inspect
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mach3_tpu.core.config import Config as JConfig
from mach3_tpu.samples.binning import histogram as jhistogram
from mach3_tpu.samples.experiment import build_experiment as jbuild_experiment
from mach3_tpu.splines.eval import eval_dense as jeval_dense
from mach3_tpu_torch.core.config import Config
from mach3_tpu_torch.core.exceptions import ConfigError
from mach3_tpu_torch.samples.binning import NonUniformBinning
from mach3_tpu_torch.samples.experiment import build_experiment
from mach3_tpu_torch.splines.reweight import SHIFT_KINDS
from mach3_tpu_torch.tutorial.experiment_files import nue_bins, write_experiment

torch.set_num_threads(1)

N_EVENTS = 3000
PROD_BUDGET = 2e-3
NLL_PROD_ATOL, NLL_PROD_RTOL = 5e-3, 1e-3
NLL_ORACLE_ATOL, NLL_ORACLE_RTOL = 1e-4, 1e-6
GRAD_ORACLE = 2e-3
ROUTES = ["generic", "generic", "shared"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_experiment(tmp_path_factory.mktemp("exp"), n_events=N_EVENTS, seed=42)


@pytest.fixture(scope="module")
def jexp(files):
    return jbuild_experiment(JConfig.from_file(str(files)), use_pallas=True)


@pytest.fixture(scope="module")
def texp(files):
    return build_experiment(Config.from_file(str(files)), device="cpu")


@pytest.fixture(scope="module")
def tplain(files):
    return build_experiment(Config.from_file(str(files)), use_kernel=False, device="cpu")


def _chains(model, n_chains=8, seed=0, frac=0.05):
    """Prefit + frac x prior-sigma jitter inside the bounds; chain 0 at prefit."""
    flat = model.flat
    sig = torch.sqrt(torch.diag(flat.chol @ flat.chol.T)).numpy()
    lo, hi = flat.low_bound.numpy(), flat.up_bound.numpy()
    th = flat.prefit.numpy() + frac * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    th = np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
    th[0] = flat.prefit.numpy()
    return th


def _index(exp, name):
    return exp.param_sets[0].index_of(name)  # the xsec set comes first


def _with_jax_data(model, jm):
    model = copy.deepcopy(model)
    for s, js in zip(model.samples, jm.samples):
        s.set_data(np.array(js.data))
    return model


def test_same_routes_names_and_bins(jexp, texp):
    assert [s.kernel_route.variant for s in jexp.samples] == ROUTES
    assert [s.kernel_route.variant for s in texp.samples] == ROUTES
    assert jexp.samples[2].kernel_route.param_tile is None
    assert [ps.names for ps in texp.param_sets] == [ps.names for ps in jexp.param_sets]
    assert texp.model.n_params == jexp.model.n_params == 19
    assert [s.n_bins for s in texp.samples] == [s.n_bins for s in jexp.samples] == [240, 20, 30]
    assert texp.model.slices == jexp.model.slices
    assert texp.model.osc_groups == jexp.model.osc_groups == (0, 0, -1)
    for f in ("prefit", "inv_cov", "low_bound", "up_bound", "flat_prior"):
        assert np.array_equal(getattr(texp.model.flat, f).numpy(),
                              np.asarray(getattr(jexp.model._flat(), f)))


def test_nonuniform_find_bins_is_jax_s(jexp, texp):
    jb, tb = jexp.samples[1].binning, texp.samples[1].binning
    assert isinstance(tb, NonUniformBinning) and tb.n_bins == jb.n_bins == len(nue_bins())
    kin = np.asarray(jexp.samples[1].kin).copy()
    cells = np.asarray(jb.cell_edges)
    edges = [cells[a][np.isfinite(cells[a])] for a in range(2)]
    grid = np.stack(np.meshgrid(*edges, indexing="ij")).reshape(2, -1)  # every edge crossing
    kin[1:, : grid.shape[1]] = grid
    kin[1, grid.shape[1]:grid.shape[1] + 4] = [-1.0, 7.0, np.nan, np.inf]
    kin = kin.astype(np.float32)
    got = tb.find_bins(torch.from_numpy(kin)).numpy()
    assert np.array_equal(got, np.asarray(jb.find_bins(jnp.asarray(kin))))
    assert (got == tb.n_bins).any() and (got < tb.n_bins).any()
    assert tb.bin_name(0) == jb.bin_name(0) and tb.bin_name(99) == "underflow/overflow"


def test_tf1_and_weight_fn_responses_are_jax_s(jexp, tplain):
    th = _chains(tplain.model, seed=1)
    th[1, _index(tplain, "tf1_pion")] = -3.0  # at its bound: the steep responses reach 0
    th[2, _index(tplain, "eres_scale")] = 0.45  # near its bound
    jth, tth = jnp.asarray(th), torch.from_numpy(th)
    js, ts = jexp.samples[1], tplain.samples[1]
    got = ts.tf1_table.eval(tth).numpy()
    want = np.asarray(jax.vmap(js.tf1_table.eval)(jth))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)
    assert (got[1] == 0.0).any() and (want[1] == 0.0).any()  # floored at 0
    js, ts = jexp.samples[2], tplain.samples[2]
    got = ts._func_weights(tth).numpy()
    want = np.asarray(jax.vmap(js._func_weights)(jth))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0.0)
    mask = np.asarray(js.weight_fns[0].mask)
    assert np.array_equal(ts.weight_mask[0].numpy(), mask) and not mask.all()
    assert (got[:, ~mask] == 1.0).all() and (got[2, mask] != 1.0).all()
    tables = jexp.model._shared_osc_tables(jth)
    for idx, (js, ts) in enumerate(zip(jexp.samples, tplain.samples)):
        jw = jax.vmap(js.event_weights, in_axes=(0, 0 if tables[idx] is not None else None))(
            jth, tables[idx])[0]
        tw = ts.event_weights(tth, tplain.model._shared_osc_tables(tth)[idx])[0]
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=PROD_BUDGET,
                                   atol=1e-6 * float(np.abs(jw).max()), err_msg=ts.name)


def test_asimov_data_match_jax(jexp, texp):
    prefit = texp.model.prefit_vector()[None]
    assert float(texp.model.total_nll_batch_parts(prefit)[2].abs().max()) < 1e-8
    for js, ts in zip(jexp.samples, texp.samples):
        want = np.asarray(js.data)
        np.testing.assert_allclose(ts.data.numpy(), want, rtol=PROD_BUDGET,
                                   atol=1e-6 * np.abs(want).max(), err_msg=ts.name)


def _oracle_nll(js, thetas, grids):
    """f32-oracle sample NLL [C] from JAX pieces: exact spline eval, TF1 and
    weight functions, each shift formed with the f32 value."""

    def one(theta, g):
        w = (js.mc_weight * js._norm_weights(theta)
             * jeval_dense(js.spline_table, theta, exact=True) * js._osc_weights(theta, g))
        if js.tf1_table is not None:
            w = w * js.tf1_table.eval(theta)
        if js.weight_fns:
            w = w * js._func_weights(theta)
        if js.static_bins is not None:
            bins = js.static_bins
        else:
            kin = js.kin
            for sh in js.shifts:
                v = theta[sh.param_index].astype(jnp.float32)
                kin = kin.at[sh.var_row].set(sh.fn(v, kin[sh.var_row], kin).astype(jnp.float32))
            bins = js.binning.find_bins(kin)
        return js._stat_sum(*jhistogram(w, bins, js.n_bins))

    return jax.vmap(one, in_axes=(0, None if grids is None else 0))(thetas, grids)


def test_nlls_match_jax(jexp, texp):
    jm = jexp.model
    tm = _with_jax_data(texp.model, jm)
    th = _chains(tm, seed=2)
    jth = jnp.asarray(th)
    tables = jm._shared_osc_tables(jth)
    _, _, parts = tm.total_nll_batch_parts(torch.from_numpy(th))
    gaps = {}
    for i, (js, ts) in enumerate(zip(jm.samples, tm.samples)):
        got = parts[:, i].numpy()
        xla = np.asarray(js.log_likelihood_batch_xla(jth, tables[i]))
        oracle = np.asarray(_oracle_nll(js, jth, tables[i]))
        np.testing.assert_allclose(got, xla, rtol=NLL_PROD_RTOL, atol=NLL_PROD_ATOL,
                                   err_msg=ts.name)
        np.testing.assert_allclose(got, oracle, rtol=NLL_ORACLE_RTOL, atol=NLL_ORACLE_ATOL,
                                   err_msg=ts.name)
        gaps[ts.name] = (float(np.abs(got - xla).max()), float(np.abs(got - oracle).max()))
    print("NLL gaps (JAX XLA route, f32 oracle):", gaps)


def _jax_chain_bins(js, jth):
    return np.asarray(jax.vmap(lambda th: js.binning.find_bins(js._shifted_kinematics(th)))(jth))


@pytest.mark.parametrize("idx", [0, 1], ids=["numu_2d", "nue_nonuniform"])
def test_bin_map_bins_match_jax(jexp, texp, idx):
    from mach3_tpu_torch import bridge

    js = jexp.samples[idx]
    bs = bridge._sample(js)
    assert bs.bin_map is not None and bs.hist_plan_ptr is not None
    th = _chains(texp.model, n_chains=12, seed=8, frac=0.5)  # the same prior as JAX's
    p = bs.bin_map.param_index.numpy()
    th[1, p] = 0.0  # unshifted: JAX's and the port's values agree exactly
    want = _jax_chain_bins(js, jnp.asarray(th))
    got = bs.perchain_bins(torch.from_numpy(th)).bins(bs.n_bins).numpy()
    real = ~bs.event_pad.numpy()
    perm = bs.event_perm.numpy()[real]
    assert np.array_equal(np.sort(perm), np.arange(js.n_events))  # each event once
    mine = np.empty_like(want)
    mine[:, perm] = got[:, real]
    differ = np.argwhere(mine != want)
    # each difference: an event whose f32-shifted value is within an ulp of an edge
    kin = np.asarray(js.kin)
    for c, e in differ:
        near = False
        for a, (row, n_edges, _) in enumerate(bs.bin_map.axes):
            x = np.float32(kin[row, e])
            for j, (axis, kind) in enumerate(bs.bin_map.shifts):
                if axis == a:
                    v = np.float32(th[c, p[j]])
                    x = np.float32(SHIFT_KINDS[kind][1](torch.tensor([[v]]),
                                                        torch.tensor([[x]]))[0, 0])
            edges = bs.bin_map.edges[a, :n_edges].numpy()
            near |= bool(np.any(np.abs(edges - x) <= np.spacing(np.abs(edges))))
        assert near, (c, e)
    assert len(differ) <= 1e-3 * want.size, len(differ)
    assert not np.any(mine[1] != want[1])
    print(f"{js.name}: {len(differ)} of {want.size} (chain, event) bins differ, each within an "
          f"ulp of an edge")


def test_laid_out_generic_histograms_match_jax(jexp, texp):
    jm, tm = jexp.model, texp.model
    th = _chains(tm, seed=9)
    jth = jnp.asarray(th)
    jtables = jm._shared_osc_tables(jth)
    ttables = tm._shared_osc_tables(torch.from_numpy(th))
    for i in (0, 1):
        js, ts = jm.samples[i], tm.samples[i]
        assert ts.bin_map is not None and ts.n_events % 256 == 0 and ts.n_events > js.n_events
        mc, w2 = (v.numpy() for v in ts.reweight_batch(torch.from_numpy(th), ttables[i]))
        mc_j, w2_j = (np.asarray(v) for v in jax.vmap(
            js.reweight, in_axes=(0, 0 if jtables[i] is not None else None))(jth, jtables[i]))
        for got, want in ((mc, mc_j), (w2, w2_j)):
            np.testing.assert_allclose(got, want, rtol=PROD_BUDGET,
                                       atol=1e-6 * float(np.abs(want).max()), err_msg=ts.name)


def test_kernel_routes_match_own_plain_route(texp, tplain):
    assert [s.kernel_route.variant for s in tplain.samples] == ["xla"] * 3
    th = torch.from_numpy(_chains(texp.model, seed=3))
    a = texp.model.total_nll_batch_parts(th)[2]
    b = tplain.model.total_nll_batch_parts(th)[2]
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-5)
    nd = texp.samples[2]
    assert nd.n_events > tplain.samples[2].n_events  # laid out, with pad events
    assert nd.tf1_table is None and bool(nd.weight_mask[0][nd.mc_weight == 0].any()) is False


def test_gradients_match_jax(jexp, texp, monkeypatch):
    """Port: the fused routes (plain versions of K5, the shared kernel and
    K6a/K6b). JAX: ``jax.grad`` of its XLA route with the oracle's spline
    eval, oscillation free."""
    from mach3_tpu.samples import sample as jsample

    monkeypatch.setattr(jsample, "eval_dense",
                        lambda table, params: jeval_dense(table, params, exact=True))
    jm = jexp.model
    tm = _with_jax_data(texp.model, jm)
    assert [s._diff_route() for s in tm.samples] == ROUTES
    th = _chains(tm, n_chains=5, seed=4)[1:]  # at prefit the gradient is ~0: no scale

    flat = jm._flat()

    def nlls(t):
        """Each sample's NLL on the XLA route, and the log-posterior from
        them and the Gaussian prior (JAX's log_posterior_batch without its
        fused kernels)."""
        tables = jm._shared_osc_tables(t)
        per = [_oracle_nll(s, t, tables[i]) for i, s in enumerate(jm.samples)]
        d = jnp.where(flat.flat_prior[None, :], 0.0, t - flat.prefit[None, :])
        prior = 0.5 * jnp.sum(d * (d @ flat.inv_cov.T), axis=1)
        return jnp.stack(per + [-prior - sum(per)])

    jac = np.asarray(jax.jit(jax.jacrev(lambda t: nlls(t).sum(1)))(jnp.asarray(th)))
    t = torch.tensor(th, requires_grad=True)
    tables = tm._shared_osc_tables(t)
    gaps = {}
    for i, s in enumerate(tm.samples):
        g = torch.autograd.grad(s.log_likelihood_batch_diff(t, tables[i]).sum(), t,
                                retain_graph=True)[0].numpy()
        want = jac[i]
        gap = np.abs(g - want) / np.abs(want).max(-1, keepdims=True)
        gaps[s.name] = float(gap.max())
        assert gap.max() <= GRAD_ORACLE, (s.name, gap.max())
    g = torch.autograd.grad(tm.log_posterior_batch(t).sum(), t)[0].numpy()
    gap = np.abs(g - jac[-1]) / np.abs(jac[-1]).max(-1, keepdims=True)
    gaps["log_posterior_batch"] = float(gap.max())
    assert gap.max() <= GRAD_ORACLE and np.isfinite(g).all()
    for name in ("tf1_pion", "eres_scale"):  # TF1 and weight-function gradients flow
        assert (g[:, _index(texp, name)] != 0).all()
    print("gradient gaps (f32 oracle):", gaps)


@pytest.mark.parametrize("kind,var", [("offset", "cos_theta"), ("scale_about_one", "e_reco")])
def test_single_named_shift_takes_the_shifted_route(files, kind, var, tmp_path):
    cfg = yaml.safe_load(Path(files).read_text())
    sample = cfg["Experiment"]["Samples"][0]
    sample["Shifts"] = [{"Function": kind, "Parameter": "ctheta_offset", "Var": var}]
    cfg["Experiment"]["Samples"] = [sample]
    path = tmp_path / "one.yaml"
    path.write_text(yaml.safe_dump(cfg))
    js = jbuild_experiment(JConfig.from_file(str(path)), use_pallas=True).samples[0]
    tm = build_experiment(Config.from_file(str(path)), device="cpu").model
    ts = tm.samples[0]
    assert js.kernel_route.variant == ts.kernel_route.variant == "shifted"
    assert ts.kernel_shift[0] == kind
    # the port lays a shifted-route sample's events out: compare through the layout
    assert np.array_equal(ts.shift_static_base.numpy(),
                          np.asarray(js.shift_static_base)[ts.event_perm.numpy()])
    ts.set_data(np.array(js.data))
    th = _chains(tm, seed=5)
    th[1:, ts.shifts[0].param_index] = np.linspace(-0.15, 0.15, len(th) - 1)
    jth = jnp.asarray(th)
    grids = jax.vmap(js.osc_prob_grids)(jth)
    want = np.asarray(js.log_likelihood_batch_xla(jth, grids))
    got = tm.total_nll_batch_parts(torch.from_numpy(th))[2][:, 0].numpy()
    np.testing.assert_allclose(got, want, rtol=NLL_PROD_RTOL, atol=NLL_PROD_ATOL)


def _without_pdg(npz: str, fmt: str) -> str:
    """The MC of ``npz`` without its ``pdg`` column as a ``.csv`` or
    ``.m3evt`` file beside it (read through ``core/nativeio.py``)."""
    from mach3_tpu_torch.core import nativeio

    cols = {k: v for k, v in np.load(npz).items() if k != "pdg"}
    out = str(Path(npz).with_name(f"no_pdg.{fmt}"))
    if fmt == "m3evt":
        nativeio.write_events(out, {k: v.astype(np.int32) if v.dtype.kind == "i" else v
                                    for k, v in cols.items()})
    else:
        np.savetxt(out, np.stack([v.astype(np.float64) for v in cols.values()], axis=1),
                   fmt="%.17g", delimiter=",", header=",".join(cols), comments="")
    return out


CONFIG_ERRORS = {
    "unknown shift": (lambda s: s.update(Shifts=[{"Function": "nope", "Parameter": "escale",
                                                  "Var": "e_reco"}]), "Unknown shift"),
    "unknown weight fn": (lambda s: s["WeightFunctions"][0].update(Function="nope"),
                          "Unknown weight function"),
    "unknown weight param": (lambda s: s["WeightFunctions"][0].update(Parameter="nope"),
                             "unknown parameter"),
    "no binning": (lambda s: s.update(Binning={"Vars": ["e_reco"]}), "Binning needs"),
    "csv": (lambda s: s.update(MCFile=_without_pdg(s["MCFile"], "csv")),
            "missing required columns"),
    "m3evt": (lambda s: s.update(MCFile=_without_pdg(s["MCFile"], "m3evt")),
              "missing required columns"),
    "format": (lambda s: s.update(MCFile="events.root"), "Unknown MC file format"),
    "no datafile": (None, "requires DataFile"),
}


@pytest.mark.parametrize("case", list(CONFIG_ERRORS))
def test_config_errors(files, tmp_path, case):
    edit, match = CONFIG_ERRORS[case]
    cfg = yaml.safe_load(Path(files).read_text())
    sample = cfg["Experiment"]["Samples"][2]
    if edit is None:
        cfg["Experiment"]["Data"] = "Fake"
    else:
        edit(sample)
    cfg["Experiment"]["Samples"] = [sample]
    with pytest.raises(ConfigError, match=match):
        build_experiment(Config(cfg), device="cpu")


def test_missing_columns(files, tmp_path):
    cfg = yaml.safe_load(Path(files).read_text())
    sample = cfg["Experiment"]["Samples"][2]
    cols = dict(np.load(sample["MCFile"]))
    del cols["pdg"]
    np.savez(tmp_path / "mc.npz", **cols)
    sample["MCFile"] = str(tmp_path / "mc.npz")
    cfg["Experiment"]["Samples"] = [sample]
    with pytest.raises(ConfigError, match="missing required columns"):
        build_experiment(Config(cfg), device="cpu")


def test_bridge_carries_tf1_and_hyper_rectangles(jexp, texp):
    from mach3_tpu_torch import bridge

    ts, bs = texp.samples[1], bridge._sample(jexp.samples[1])
    assert bs.kernel_route.variant == "generic" and isinstance(bs.binning, NonUniformBinning)
    for f in ("cell_edges", "cell_to_bin"):
        assert torch.equal(getattr(bs.binning, f), getattr(ts.binning, f))
    for f in ("slope", "intercept", "param_index"):
        assert torch.equal(getattr(bs.tf1_table, f), getattr(ts.tf1_table, f))
    th = torch.from_numpy(_chains(texp.model, seed=6))
    np.testing.assert_allclose(bs.reweight_batch_plain(th)[0].numpy(),
                               ts.reweight_batch_plain(th)[0].numpy(), rtol=1e-6, atol=1e-6)
    assert bridge._sample(jexp.samples[0]).shifts[1].kind == "offset"
    with pytest.raises(NotImplementedError, match="build_experiment"):
        bridge._sample(jexp.samples[2])  # a weight function: a JAX closure


def test_with_binning_rebuilds_the_layout(texp, tplain):
    nd = texp.samples[2]
    hr = NonUniformBinning.build([[[0.0, 0.5]], [[0.5, 1.0]], [[1.0, 3.0]]], [1])
    swapped = nd.with_binning(hr)
    assert swapped.kernel_route.variant == "shared" and swapped.n_bins == 3
    assert swapped.hist_nbl <= 3 and swapped.hist_tile_start.shape[0] * 256 == swapped.n_events
    plain = tplain.samples[2].with_binning(hr)
    assert plain.kernel_route.variant == "xla" and plain.hist_nbl is None
    th = torch.from_numpy(_chains(texp.model, seed=7))
    a, b = swapped.reweight_batch(th), plain.reweight_batch(th)
    for x, y in zip(a, b):  # f32 sums in another order
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=2e-5, atol=0.0)
    assert nd.n_bins == 30  # the original is untouched


def test_builders_default_to_the_card(files, monkeypatch):
    from mach3_tpu_torch.tutorial.large import build_large
    from mach3_tpu_torch.tutorial.toy import build_toy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (build_toy, build_large, build_experiment):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_toy(n_events=200)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_large(n_numu=100, n_nue=100, n_atmo=100)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_experiment(Config.from_file(str(files)))


_NO_JAX = """
import sys
sys.modules["jax"] = None
sys.path.insert(0, {root!r})
import tempfile
import chip_smoke
from mach3_tpu_torch.core.config import Config
from mach3_tpu_torch.samples.experiment import build_experiment
from mach3_tpu_torch.tutorial.experiment_files import write_experiment
with tempfile.TemporaryDirectory() as d:
    exp = build_experiment(Config.from_file(str(write_experiment(d, n_events=300))), device="cpu")
assert [s.kernel_route.variant for s in exp.samples] == ["generic", "generic", "shared"]
bad = [k for k, m in sys.modules.items() if m is not None
       and (k in ("jax", "mach3_tpu") or k.startswith(("jax.", "mach3_tpu.")))]
assert not bad, bad
print("ok")
"""


def test_experiment_and_smoke_load_no_jax():
    root = str(Path(__file__).resolve().parent.parent)
    out = subprocess.run([sys.executable, "-c", _NO_JAX.format(root=root)], capture_output=True,
                         text=True, cwd=root, timeout=300)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]
