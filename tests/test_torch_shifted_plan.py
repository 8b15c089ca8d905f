"""The shifted route's event layout and activity plan (``plan.shifted_layout``,
``events.apply_shifted_layout``) and the kernels' tile core, vs the JAX
package and vs the port's own plain versions.

* Layout: a permutation of the events plus zero-weight pads, each activity
  group padded to ``EVENT_TILE``; every (tile, parameter) pair missing from
  the CSR list is the identity on every event of the tile; table rows start
  on 16-byte boundaries.
* A laid-out shifted sample (the toy's two, ``build_large``'s nue_beam at the
  test size) against JAX's ``fused_reweight_histogram_shifted`` in Pallas
  interpret mode: histograms within 2e-3 (+1e-6·max; JAX rounds response
  deviations to bf16), NLLs within 5e-3 + 1e-3·|NLL|; against the f32 oracle
  (``eval_dense(exact=True)``): histograms within 1e-5 relative (+1e-6·max;
  f32 sums in another order).
* The plain version ignores the plan: real and trivial plan bit for bit.
* ``with_binning`` and the bridge rebuild the layout of a shifted sample.
* The gradient through the laid-out nue_beam (forward and backward under
  the plan) vs the plain route, as ``test_torch_grad.py`` holds it.

The ``cuda``-marked tests hold both CUDA kernels (``csrc/reweight_shifted.cu``,
``csrc/reweight_shared.cu``) to their plain versions on the tile core's edge
cases; they import no jax and run with ``--noconftest`` where a card is.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from mach3_tpu_torch.kernels.launch import LAUNCHES
from mach3_tpu_torch.samples.binning import SampleBinning
from mach3_tpu_torch.splines import plan, reweight
from mach3_tpu_torch.splines.eval import find_segments
from mach3_tpu_torch.splines.monolith import (
    DenseSplineTable,
    SplineParamSpec,
    build_dense_table,
    dense_table_activity,
)

torch.set_num_threads(1)

TOY = dict(n_events=1500, seed=11, e_grid_size=30, flip_hierarchy=True)
SIZE = dict(n_numu=4000, n_nue=1500, n_atmo=3000, e_grid_size=40, atmo_e_grid_size=20,
            atmo_cosz_grid_size=8, low_memory=True, seed=7)
PROD_BUDGET = 2e-3
ORACLE_RTOL, ATOL_FRAC = 1e-5, 1e-6
NLL_PROD_ATOL, NLL_PROD_RTOL = 5e-3, 1e-3
GRAD_SELF = 3e-4  # test_torch_grad.py: the fused route vs the plain route
K_RTOL = 2e-5  # CUDA kernel vs plain version: f32 sums in another order
SIGMA = np.array([-3.0, -1.0, 0.0, 1.0, 3.0])
N_AXIS, N_OTHER = 12, 3


# ------------------------------------------------------------ synthetic inputs


def _inputs(n_chains=5, n_events=1500, n_params=12, seed=0, bf16=False, norm=True,
            spread=False):
    """numpy inputs of the shifted kernel in file order: each parameter acts
    on the events of one of 4 modes (as the large fixture's do); ``spread``
    puts the chains of parameter 0 into three segments."""
    rng = np.random.default_rng(seed)
    modes = rng.integers(0, 4, n_events)
    specs = []
    for p in range(n_params):
        ev = np.flatnonzero(modes == p % 4)
        slope = 0.06 * (1.0 + 0.3 * rng.normal(size=(len(ev), 1)))
        curv = 0.008 * rng.normal(size=(len(ev), 1))
        y = np.clip(1.0 + slope * SIGMA + curv * SIGMA**2, 0.0, None)
        y[:, 2] = 1.0
        specs.append(dict(name=f"s{p}", param_index=p, x_knots=SIGMA, event_ids=ev, y_knots=y))
    params = rng.normal(scale=0.3, size=(n_chains, n_params))
    if spread:
        params[:, 0] = np.resize([-2.0, 0.5, 2.2], n_chains)
    edges = np.linspace(0.0, 3.0, N_AXIS + 1).astype(np.float32)
    norm_ext = norm_s = None
    if norm:
        norm_ext = np.ones((n_chains, 4), np.float32)
        norm_ext[:, :3] = rng.uniform(0.7, 1.3, size=(n_chains, 3))
        norm_ext[-1, 0] = -0.8
        norm_s = np.zeros((4, n_events), np.float32)
        norm_s[0] = rng.integers(0, 3, size=n_events)
        norm_s[1:3] = rng.integers(0, 2, size=(2, n_events))
        norm_s[3] = 1.0
    static = rng.integers(0, N_OTHER, size=n_events).astype(np.int32) * N_AXIS
    static[rng.choice(n_events, size=min(12, n_events // 2), replace=False)] = -1
    return types.SimpleNamespace(
        specs=specs, params=params, edges=edges, norm_ext=norm_ext, norm_s=norm_s,
        static=static, x_nom=rng.uniform(-0.2, 3.2, size=n_events).astype(np.float32),
        base=rng.uniform(0.5, 2.0, size=(n_chains, n_events)).astype(np.float32),
        shift=rng.normal(scale=0.05, size=n_chains).astype(np.float32),
        bins=rng.integers(0, 40, n_events).astype(np.int32), n_events=n_events, bf16=bf16)


def _table(d):
    return build_dense_table([SplineParamSpec(**s) for s in d.specs], d.n_events,
                             low_memory=d.bf16)


def _dev(a, device, dtype=None):
    return None if a is None else torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                                  device=device)


def _shifted_args(d, device="cpu", shift_kind="scale", extra_pad_tile=False):
    """(args, kwargs with the real plan, kwargs with a trivial plan) of the
    shifted wrapper on the laid-out events (``extra_pad_tile``: one more tile
    of nothing but pads, which no parameter acts on)."""
    table = _table(d)
    lay = plan.shifted_layout(dense_table_activity(table))
    perm, pad, ptr, idx = lay.event_perm, lay.pad_mask, lay.plan_ptr, lay.plan_idx
    if extra_pad_tile:
        perm = np.concatenate([perm, np.full(plan.EVENT_TILE, perm[-1])])
        pad = np.concatenate([pad, np.ones(plan.EVENT_TILE, bool)])
        ptr = np.concatenate([ptr, ptr[-1:]])
    tp, te = torch.from_numpy(lay.param_perm), torch.from_numpy(perm)
    table = DenseSplineTable(table.coeffs.index_select(0, tp).index_select(2, te),
                             table.knots_x[tp], table.n_knots[tp], table.param_index[tp])
    table = table.to(device)
    params = torch.as_tensor(d.params, device=device)
    seg, t = find_segments(table.knots_x, table.n_knots, params[:, table.param_index])
    base = d.base[:, perm].copy()
    base[:, pad] = 0.0
    args = (seg, t, table.coeffs, _dev(base, device), _dev(d.shift, device),
            _dev(d.x_nom[perm], device), _dev(d.static[perm], device), _dev(d.edges, device))
    common = dict(n_bins=N_AXIS * N_OTHER, shift_kind=shift_kind, stride_j=1, n_axis_j=N_AXIS,
                  norm_ext=_dev(d.norm_ext, device),
                  norm_s=None if d.norm_s is None else _dev(d.norm_s[:, perm], device))
    t_ptr, t_idx = plan.trivial_active(len(perm), table.n_spline_params)
    real = dict(common, plan_ptr=_dev(ptr, device), plan_idx=_dev(idx, device))
    trivial = dict(common, plan_ptr=_dev(t_ptr, device), plan_idx=_dev(t_idx, device))
    return args, real, trivial, types.SimpleNamespace(lay=lay, table=table, pad=pad)


# --------------------------------------------------------------------- layout


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_shifted_layout_is_a_padded_permutation_with_an_exact_plan(bf16):
    d = _inputs(n_events=3000, n_params=20, bf16=bf16)
    _, real, _, x = _shifted_args(d)
    lay = x.lay
    e2 = len(lay.event_perm)
    assert e2 % plan.EVENT_TILE == 0 and e2 >= d.n_events
    assert np.array_equal(np.sort(lay.event_perm[~lay.pad_mask]), np.arange(d.n_events))
    assert lay.tile_start is None and lay.tile_width is None and lay.nbl is None
    assert lay.n_tiles == e2 // plan.EVENT_TILE == len(lay.plan_ptr) - 1
    # events keep their file order within an activity group (no bin sort)
    act = dense_table_activity(_table(d))[lay.param_perm]
    gid = plan.event_groups(act)[lay.event_perm]
    assert (np.diff(gid) >= 0).all() and lay.n_groups == len(np.unique(gid)) == 4
    real_pos = np.flatnonzero(~lay.pad_mask)
    same = gid[real_pos][1:] == gid[real_pos][:-1]
    assert (np.diff(lay.event_perm[real_pos])[same] > 0).all()
    # a tile holds one group; a pair missing from its list is the identity on all its events
    laid = dense_table_activity(x.table)
    ptr, idx = lay.plan_ptr, lay.plan_idx
    for t in range(lay.n_tiles):
        cols = slice(t * plan.EVENT_TILE, (t + 1) * plan.EVENT_TILE)
        assert len(np.unique(gid[cols])) == 1
        listed = np.zeros(laid.shape[0], bool)
        listed[idx[ptr[t]:ptr[t + 1]]] = True
        assert not laid[~listed, cols].any()
        live = laid[:, cols] & ~lay.pad_mask[cols]
        assert np.array_equal(listed, live.any(1))
    assert 0 < lay.mean_active() < laid.shape[0]
    # rows start on 16-byte boundaries: the kernels' asynchronous copies
    coeffs = x.table.coeffs
    assert coeffs.is_contiguous() and coeffs.data_ptr() % reweight.ROW_ALIGN == 0
    assert (coeffs.shape[2] * coeffs.element_size()) % reweight.ROW_ALIGN == 0


def test_layouts_share_their_helpers():
    """The shared layout's CSR lists are ``tile_active``'s, and a trivial
    plan's are ``trivial_active``'s."""
    d = _inputs(n_events=2000, n_params=8)
    act = dense_table_activity(_table(d))
    lay = plan.shared_layout(act, d.bins.astype(np.int64), 40)
    laid = act[lay.param_perm][:, lay.event_perm] & ~lay.pad_mask
    ptr, idx = plan.tile_active(laid)
    assert np.array_equal(ptr, lay.plan_ptr) and np.array_equal(idx, lay.plan_idx)
    assert lay.n_tiles == len(lay.tile_start) and lay.nbl >= 1
    t_ptr, t_idx = plan.trivial_active(2000, 8)
    wide = plan.trivial_plan(2000, 8, 40)
    assert np.array_equal(wide[2], t_ptr) and np.array_equal(wide[3], t_idx)
    assert len(t_ptr) == 9 and len(t_idx) == 64
    empty = plan.shifted_layout(np.zeros((3, 0), bool))
    assert empty.n_tiles == 0 and len(empty.event_perm) == 0


@pytest.mark.parametrize("case", ["norm", "bf16", "three_segments", "pad_tile"])
def test_plain_version_ignores_the_plan(case):
    """The plain version under the real plan, under a trivial plan and under
    none: bit for bit (a skipped pair multiplies by exactly 1.0)."""
    d = _inputs(bf16=case == "bf16", spread=case == "three_segments")
    args, real, trivial, x = _shifted_args(d, extra_pad_tile=case == "pad_tile")
    if case == "three_segments":
        seg = args[0][:, x.table.param_index.tolist().index(0)]
        assert len(torch.unique(seg)) == 3
    call = reweight.fused_reweight_histogram_shifted
    none = dict(real, plan_ptr=None, plan_idx=None)
    a, b, c = call(*args, **real), call(*args, **trivial), call(*args, **none)
    for x1, x2, x3 in zip(a, b, c):
        assert torch.equal(x1, x2) and torch.equal(x1, x3)
    # and it is the file-order result: the layout moves weight nowhere
    table = _table(d)
    seg, t = find_segments(table.knots_x, table.n_knots,
                           torch.as_tensor(d.params)[:, table.param_index])
    want = reweight.fused_reweight_histogram_shifted_ref(
        seg, t, table.coeffs, _dev(d.base, "cpu"), _dev(d.shift, "cpu"), _dev(d.x_nom, "cpu"),
        _dev(d.static, "cpu"), _dev(d.edges, "cpu"),
        **{k: v for k, v in real.items() if k not in ("norm_s", "plan_ptr", "plan_idx")},
        norm_s=_dev(d.norm_s, "cpu"))
    for got, ref in zip(a, want):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=K_RTOL,
                                   atol=ATOL_FRAC * float(ref.abs().max()))


def test_wrapper_checks_the_plan():
    args, real, _, _ = _shifted_args(_inputs(n_events=600, n_params=6))
    call = reweight.fused_reweight_histogram_shifted
    with pytest.raises(ValueError, match="come together"):
        call(*args, **dict(real, plan_idx=None))
    with pytest.raises(ValueError, match="plan_ptr must be"):
        call(*args, **dict(real, plan_ptr=real["plan_ptr"][:-1]))
    with pytest.raises(TypeError):
        call(*args, **dict(real, plan_idx=real["plan_idx"].long()))
    wide = torch.zeros((2, 4 * (reweight.MAX_KNOTS + 1), args[2].shape[2]))
    with pytest.raises(ValueError, match="knots"):
        call(args[0][:, :2].contiguous(), args[1][:, :2].contiguous(), wide, *args[3:],
             **dict(real, plan_ptr=None, plan_idx=None))
    before = dict(LAUNCHES)
    call(*args, **real)
    assert LAUNCHES == before  # the plain version is not a launch
    assert reweight.tile_core_smem(args[2], 4) < reweight.MAX_SMEM


# ------------------------------------------------- laid-out samples vs JAX


@pytest.fixture()
def jx(monkeypatch):
    """The JAX package's pieces, with every ``pallas_call`` in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from mach3_tpu.samples.binning import histogram as jhistogram
    from mach3_tpu.splines import pallas_reweight
    from mach3_tpu.splines.eval import eval_dense as jeval_dense

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)
    pallas_reweight.fused_reweight_histogram_shifted.clear_cache()
    yield types.SimpleNamespace(jax=jax, jnp=jnp, histogram=jhistogram, eval_dense=jeval_dense)
    pallas_reweight.fused_reweight_histogram_shifted.clear_cache()


def _chains(flat, n_chains, seed):
    chol = np.asarray(flat.chol)
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = np.asarray(flat.low_bound), np.asarray(flat.up_bound)
    th = np.asarray(flat.prefit) + 0.05 * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    th = np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
    th[0] = np.asarray(flat.prefit)
    return th


def _jax_histograms(jx, js, th, grids):
    """(production (mc, w2) through the shifted Pallas kernel, f32-oracle
    (mc, w2)) [C, B] of one JAX sample."""
    jax, jnp = jx.jax, jx.jnp
    row = js.shifts[0].var_row

    def oracle(theta, g):
        w = (js.mc_weight * js._norm_weights(theta)
             * jx.eval_dense(js.spline_table, theta, exact=True) * js._osc_weights(theta, g))
        v = theta[js.shifts[0].param_index].astype(jnp.float32)
        kin = js.kin.at[row].set(js.kin[row] * (1.0 + v))
        return jx.histogram(w, js.binning.find_bins(kin), js.n_bins)

    prod = jax.jit(lambda s, t, g: s.reweight_batch(t, g))(js, jnp.asarray(th), grids)
    orc = jax.jit(jax.vmap(oracle))(jnp.asarray(th), grids)
    return [np.asarray(a) for a in prod], [np.asarray(a) for a in orc]


def _hold_sample_to_jax(jx, js, ts, th, grids, tables):
    assert js.kernel_route.variant == ts.kernel_route.variant == "shifted"
    assert ts.hist_plan_ptr is not None and ts.n_events % plan.EVENT_TILE == 0
    prod, orc = _jax_histograms(jx, js, th, grids)
    ts.set_data(np.array(js.data))
    got = ts.reweight_batch(torch.from_numpy(th), tables)
    for g, p, o in zip(got, prod, orc):
        np.testing.assert_allclose(g.numpy(), p, rtol=PROD_BUDGET, atol=ATOL_FRAC * np.abs(p).max())
        np.testing.assert_allclose(g.numpy(), o, rtol=ORACLE_RTOL, atol=ATOL_FRAC * np.abs(o).max())
    nll = ts._stat_sum(*got).numpy()
    want = np.asarray(js._stat_sum(jx.jnp.asarray(prod[0]), jx.jnp.asarray(prod[1])))
    np.testing.assert_allclose(nll, want, rtol=NLL_PROD_RTOL, atol=NLL_PROD_ATOL)


@pytest.mark.parametrize("i", [0, 1], ids=["numu", "nue"])
def test_laid_out_toy_sample_matches_jax(jx, i):
    from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
    from mach3_tpu_torch.tutorial.toy import build_toy

    jm = jbuild_toy(**TOY, use_pallas=True).model
    tm = build_toy(**TOY, device="cpu").model
    th = _chains(tm.flat, 5, seed=2)
    grids = jx.jax.vmap(jm.samples[i].osc_prob_grids)(jx.jnp.asarray(th))
    tables = tm._shared_osc_tables(torch.from_numpy(th))
    _hold_sample_to_jax(jx, jm.samples[i], tm.samples[i], th, grids, tables[i])


def test_laid_out_nue_beam_matches_jax(jx):
    from mach3_tpu.tutorial.large import build_large as jbuild_large
    from mach3_tpu_torch.tutorial.large import build_large

    tm = build_large(**SIZE, device="cpu").model
    ts = tm.samples[1]
    js = jbuild_large(**SIZE, use_pallas=True, asimov=False).samples[1].with_data(ts.data.numpy())
    assert ts.name == js.name == "nue_beam" and ts.spline_table.n_spline_params == 43
    # the plan skips most of the table: ~11 of 43 parameters act on an event
    n_act = float(ts.hist_plan_ptr.diff().float().mean())
    assert 5 < n_act < 20
    th = _chains(tm.flat, 4, seed=4)
    grids = jx.jax.vmap(js.osc_prob_grids)(jx.jnp.asarray(th))
    tables = tm._shared_osc_tables(torch.from_numpy(th))
    _hold_sample_to_jax(jx, js, ts, th, grids, tables[1])


# ------------------------------------------------- with_binning, the bridge


@pytest.fixture(scope="module")
def ttoy():
    from mach3_tpu_torch.tutorial.toy import build_toy

    return build_toy(**TOY, device="cpu")


def _layout_fields(s):
    return {f: getattr(s, f) for f in ("event_perm", "event_pad", "hist_plan_ptr",
                                       "hist_plan_idx", "mc_weight", "shift_static_base")}


@pytest.mark.parametrize("i", [0, 1], ids=["numu", "nue"])
def test_built_sample_is_laid_out(ttoy, i):
    from mach3_tpu_torch.tutorial.toy import build_toy

    s = ttoy.model.samples[i]
    p = build_toy(**TOY, use_kernel=False, device="cpu").model.samples[i]
    assert p.event_perm is None and p.hist_plan_ptr is None
    perm, pad = s.event_perm.numpy(), s.event_pad.numpy()
    assert s.n_events % plan.EVENT_TILE == 0 and s.hist_tile_start is None and s.hist_nbl is None
    assert np.array_equal(np.sort(perm[~pad]), np.arange(p.n_events))
    assert torch.equal(s.kin, p.kin[:, s.event_perm])
    assert torch.equal(s.mc_weight, torch.where(s.event_pad, 0.0, p.mc_weight[s.event_perm]))
    assert torch.equal(s.norm_idx, p.norm_idx[s.event_perm])
    assert torch.equal(s.norm_s, p.norm_s[:, s.event_perm])
    assert torch.equal(s.shift_static_base, p.shift_static_base[s.event_perm])
    assert torch.equal(s.osc.flat_idx, p.osc.flat_idx[s.event_perm])
    order = s.spline_table.param_index.argsort()
    assert torch.equal(s.spline_table.coeffs[order], p.spline_table.coeffs[:, :, s.event_perm])
    th = torch.from_numpy(_chains(ttoy.model.flat, 4, seed=1))
    np.testing.assert_allclose(s.log_likelihood_batch(th).numpy(),
                               p.log_likelihood_batch(th).numpy(), rtol=1e-6, atol=1e-5)


def test_with_binning_rebuilds_the_shifted_layout(ttoy):
    s = ttoy.model.samples[0]
    coarse = SampleBinning.build([np.linspace(0.0, 3.0, 7)], [int(s.binning.axis_vars[0])])
    swapped = s.with_binning(coarse)
    assert swapped.kernel_route.variant == "shifted" and swapped.n_bins == 6
    assert swapped.n_events % plan.EVENT_TILE == 0 and swapped.n_events >= s.n_events
    assert swapped.hist_plan_ptr.shape[0] == swapped.n_events // plan.EVENT_TILE + 1
    assert swapped.shift_static_base.shape == (swapped.n_events,)
    # where its events came from, through both layouts: pads stay pads
    first_pads = int(s.event_pad.sum())
    assert int(swapped.event_pad.sum()) >= first_pads
    real = ~swapped.event_pad.numpy()
    n_file = int((~s.event_pad).sum())
    assert np.array_equal(np.sort(swapped.event_perm.numpy()[real]), np.arange(n_file))
    plain = s.with_binning(coarse)
    plain.kernel_route = type(s.kernel_route)(False, "xla", reason="test")
    th = torch.from_numpy(_chains(ttoy.model.flat, 4, seed=6))
    a, b = swapped.reweight_batch(th), plain.reweight_batch(th)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(y.abs().max()))
    assert float(a[0].sum()) > 0


def test_bridge_lays_a_shifted_sample_out(ttoy):
    from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
    from mach3_tpu_torch.bridge import from_jax_model

    tm = from_jax_model(jbuild_toy(**TOY, use_pallas=True).model)
    for b, s in zip(tm.samples, ttoy.model.samples):
        assert b.kernel_route.variant == "shifted"
        for f, v in _layout_fields(s).items():
            assert torch.equal(getattr(b, f), v), f
        assert torch.equal(b.spline_table.coeffs, s.spline_table.coeffs)


# ------------------------------------------------------------------ gradient


def test_gradient_through_the_laid_out_nue_beam_matches_the_plain_route():
    from mach3_tpu_torch.tutorial.large import build_large

    tm = build_large(**SIZE, device="cpu").model
    s = tm.samples[1]
    assert s._diff_route() == "shifted" and s.hist_plan_ptr is not None
    args, kwargs = s.diff_kernel_args(tm.prefit_vector()[None])
    assert kwargs["plan_ptr"] is s.hist_plan_ptr and kwargs["plan_idx"] is s.hist_plan_idx
    th = _chains(tm.flat, 4, seed=5)[1:]  # not the prefit point: the Asimov gradient is 0 there
    t = torch.tensor(th, requires_grad=True)
    tables = tm._shared_osc_tables(t)
    diff = s.log_likelihood_batch_diff(t, tables[1])
    plain = s.log_likelihood_batch_plain(t, tables[1])
    g_diff, g_plain = (torch.autograd.grad(v.sum(), t, retain_graph=True)[0].numpy()
                       for v in (diff, plain))
    np.testing.assert_allclose(diff.detach().numpy(), plain.detach().numpy(), rtol=1e-6, atol=1e-5)
    gap = np.abs(g_diff - g_plain) / np.abs(g_plain).max(-1, keepdims=True)
    assert gap.max() <= GRAD_SELF and np.isfinite(g_diff).all() and (g_diff != 0).any()


# ------------------------------------------------------------------- the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


def _close_on_card(got, want, what):
    for g, w, h in zip(got, want, ("mc", "w2")):
        assert torch.isfinite(g).all(), f"{what} {h}"
        tol = K_RTOL * w.abs() + ATOL_FRAC * float(w.abs().max()) + 1e-30  # an empty histogram
        worst = float(((g - w).abs() / tol).max())
        assert worst <= 1.0, f"{what} {h}: {worst:.2f}x the tolerance"


SHIFTED_CARD_CASES = {
    # name: (inputs, shift kind, a last tile of nothing but pads)
    "odd_chains_f32": (dict(n_chains=21, n_events=5000, n_params=20), "scale", False),
    "partial_chain_tile_bf16": (dict(n_chains=7, n_events=3000, bf16=True), "scale", False),
    "pad_tile": (dict(n_chains=19, n_events=2000), "scale", True),
    "three_segments": (dict(n_chains=33, n_events=4000, spread=True), "scale", False),
    "three_segments_bf16": (dict(n_chains=17, n_events=4000, spread=True, bf16=True), "scale",
                            False),
    "no_norm": (dict(n_chains=16, n_events=3000, norm=False), "scale", False),
    "offset": (dict(n_chains=9, n_events=3000), "offset", False),
    "scale_about_one": (dict(n_chains=9, n_events=3000, bf16=True), "scale_about_one", False),
    "one_event": (dict(n_chains=3, n_events=1, n_params=4), "scale", False),
    "p256": (dict(n_chains=5, n_events=600, n_params=256), "scale", False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHIFTED_CARD_CASES))
def test_cuda_shifted_kernel_under_real_and_trivial_plan(cuda_device, case):
    """The shifted kernel under the real plan, under a trivial plan and with
    no plan, each against the plain version on the same arguments."""
    kw, kind, pad_tile = SHIFTED_CARD_CASES[case]
    args, real, trivial, _ = _shifted_args(_inputs(**kw), cuda_device, kind, pad_tile)
    call = reweight.fused_reweight_histogram_shifted
    want = reweight.fused_reweight_histogram_shifted_ref(*args, **real)
    before = LAUNCHES["reweight_shifted"]
    for what, kwargs in (("plan", real), ("trivial plan", trivial),
                         ("no plan", dict(real, plan_ptr=None, plan_idx=None))):
        got = call(*args, **kwargs)
        torch.cuda.synchronize()
        _close_on_card(got, want, f"{case} {what}")
    assert LAUNCHES["reweight_shifted"] == before + 3


SHARED_CARD_CASES = {
    "odd_chains_f32": dict(n_chains=21, n_events=5000, n_params=20),
    "partial_chain_tile_bf16": dict(n_chains=7, n_events=3000, bf16=True),
    "three_segments": dict(n_chains=33, n_events=4000, spread=True),
    "three_segments_bf16": dict(n_chains=17, n_events=4000, spread=True, bf16=True),
    "no_norm": dict(n_chains=16, n_events=3000, norm=False),
    "pad_tile": dict(n_chains=19, n_events=2000),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(SHARED_CARD_CASES))
def test_cuda_shared_kernel_tile_core(cuda_device, case):
    """The shared kernel on the same edge cases, under its real plan (with,
    for ``pad_tile``, a last tile of nothing but pads and an empty list) and
    a trivial plan."""
    d = _inputs(**SHARED_CARD_CASES[case])
    table = _table(d)
    n_bins = 40
    lay = plan.shared_layout(dense_table_activity(table), d.bins.astype(np.int64), n_bins)
    if case == "pad_tile":
        lay = dataclasses.replace(
            lay, event_perm=np.concatenate([lay.event_perm,
                                            np.full(plan.EVENT_TILE, lay.event_perm[-1])]),
            pad_mask=np.concatenate([lay.pad_mask, np.ones(plan.EVENT_TILE, bool)]),
            plan_ptr=np.concatenate([lay.plan_ptr, lay.plan_ptr[-1:]]),
            tile_start=np.concatenate([lay.tile_start, lay.tile_start[-1:]]),
            tile_width=np.concatenate([lay.tile_width, lay.tile_width[-1:]]))
    dev = cuda_device
    tp, te = torch.from_numpy(lay.param_perm), torch.from_numpy(lay.event_perm)
    table = DenseSplineTable(table.coeffs.index_select(0, tp).index_select(2, te),
                             table.knots_x[tp], table.n_knots[tp], table.param_index[tp]).to(dev)
    seg, t = find_segments(table.knots_x, table.n_knots,
                           torch.as_tensor(d.params, device=dev)[:, table.param_index])
    base = d.base[:, lay.event_perm].copy()
    base[:, lay.pad_mask] = 0.0
    args = (seg, t, table.coeffs, _dev(base, dev), _dev(d.bins[lay.event_perm], dev))
    common = dict(n_bins=n_bins, norm_ext=_dev(d.norm_ext, dev),
                  norm_s=None if d.norm_s is None else _dev(d.norm_s[:, lay.event_perm], dev))
    real = dict(common, tile_start=_dev(lay.tile_start, dev), tile_width=_dev(lay.tile_width, dev),
                plan_ptr=_dev(lay.plan_ptr, dev), plan_idx=_dev(lay.plan_idx, dev), nbl=lay.nbl)
    starts, widths, ptr, idx, nbl = plan.trivial_plan(len(lay.event_perm), len(tp), n_bins)
    trivial = dict(common, tile_start=_dev(starts, dev), tile_width=_dev(widths, dev),
                   plan_ptr=_dev(ptr, dev), plan_idx=_dev(idx, dev), nbl=nbl)
    want = reweight.fused_reweight_histogram_shared_ref(*args, **real)
    for what, kwargs in (("plan", real), ("trivial plan", trivial)):
        got = reweight.fused_reweight_histogram_shared(*args, **kwargs)
        torch.cuda.synchronize()
        _close_on_card(got, want, f"{case} {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["shifted", "shared"])
def test_cuda_rows_off_16_bytes_raise(cuda_device, kernel):
    """A table whose row pitch is not a multiple of 16 bytes (E = 250 in
    bf16: 500 bytes) raises: there is no slower path."""
    d = _inputs(n_chains=3, n_events=250, n_params=4, bf16=True)
    table = _table(d).to(cuda_device)
    seg, t = find_segments(table.knots_x, table.n_knots,
                           torch.as_tensor(d.params, device=cuda_device)[:, table.param_index])
    dev = cuda_device
    before = dict(LAUNCHES)
    with pytest.raises(ValueError, match="multiples of 16"):
        if kernel == "shifted":
            reweight.fused_reweight_histogram_shifted(
                seg, t, table.coeffs, _dev(d.base, dev), _dev(d.shift, dev), _dev(d.x_nom, dev),
                _dev(d.static, dev), _dev(d.edges, dev), n_bins=N_AXIS * N_OTHER,
                shift_kind="scale", stride_j=1, n_axis_j=N_AXIS)
        else:
            starts, widths, ptr, idx, nbl = plan.trivial_plan(250, 4, 40)
            reweight.fused_reweight_histogram_shared(
                seg, t, table.coeffs, _dev(d.base, dev), _dev(d.bins, dev), n_bins=40,
                tile_start=_dev(starts, dev), tile_width=_dev(widths, dev),
                plan_ptr=_dev(ptr, dev), plan_idx=_dev(idx, dev), nbl=nbl)
    assert LAUNCHES == before
