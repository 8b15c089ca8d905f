"""The per-chain-bins reweight-histogram (K5, K5b), its bin map, and the
unblocked shared form (K4a) of the port vs the JAX package.

* K5/K5b: the port's ``fused_reweight_histogram_ref`` (the wrapper on CPU
  tensors; one plain version for both histogram forms) vs JAX's
  ``fused_reweight_histogram`` with ``hist="maskreduce"`` and
  ``hist="blockdiag"`` in Pallas interpret mode, C = 5, P = 3 and 16,
  E = 1,500, B = 24, bins including ``n_bins``, -1 and past ``n_bins``, f32
  and bf16 tables. Against the f32 oracle (``eval_dense(exact=True)`` x base,
  JAX's ``histogram``): rtol 1e-5, atol 1e-6·max (f32 sums in another order;
  measured ≤ 2.6e-7 relative). Against JAX's production rounding: the
  budget of ``tests/test_torch_reweight.py``, rtol 2e-3, atol 1e-6·max, at
  ~59 events per bin here (JAX rounds every response deviation to bf16;
  measured ≤ 2.4e-4 (Σw) and ≤ 4.5e-4 (Σw²) relative, the same for both
  histogram forms).
* K4a: the shared wrapper's plain version under ``plan.trivial_plan`` (every
  parameter, the whole bin axis, events in their own order) vs JAX's
  unblocked ``fused_reweight_histogram_shared`` with the in-kernel norm: the
  oracle budget, and against production the budget of
  ``tests/test_torch_shared.py``, rtol 5e-3, atol 1e-3·max, as a negative
  norm makes bins whose weights cancel (there JAX's bf16 rounding is 1.8% of
  one such bin's content; elsewhere ≤ 2.8e-4 relative).

* The bin map (``reweight.PerchainBins``, the generic route's in-kernel
  binning): ``perchain_bins_ref`` equals ``SampleModel._perchain_bins`` (the
  plain binning of the shifted kinematics) exactly on the experiment's
  numu_2d (two shifted axes) and nue_nonuniform (hyper-rectangle cells)
  laid out at 1,500 events, with events on edges (also reached through a
  shift value chosen to land there), shifted below the first and past the
  last edge, in a gap cell, NaN and ±inf kinematics, and on a sample with
  two shifts on one row; a synthetic map equals a numpy binning. The
  generic route's sampling forward with a map calls neither
  ``_perchain_bins`` nor ``_norm_weights`` (the norm product is in the
  kernel); a shift that is torch code keeps the bins [C, E] as input. The
  layout's plan lists every parameter that is not the identity on a tile.

The ``cuda``-marked tests hold the CUDA kernels to the plain version on edge
cases (B = 512, P = 16, one event, every bin out of range, C not a multiple
of the chain tile, E not a multiple of the event tile, bf16 tables; the bin
map with edge events, NaN and ±inf values, cells and gaps, under a plan and
with the norm in the kernel) and K5b to itself bit for bit; they import no
jax and run with ``--noconftest`` where a card is.
"""
import copy
import types

import numpy as np
import pytest
import torch

from mach3_tpu_torch.samples.events import EventData, build_sample_model
from mach3_tpu_torch.samples.sample import SampleModel, ShiftSpec
from mach3_tpu_torch.splines import plan, reweight
from mach3_tpu_torch.splines.eval import find_segments
from mach3_tpu_torch.splines.monolith import (
    DenseSplineTable,
    SplineParamSpec,
    build_dense_table,
    dense_table_activity,
)

torch.set_num_threads(1)

ORACLE_RTOL, ATOL_FRAC = 1e-5, 1e-6
PROD_RTOL, PROD_ATOL_FRAC = 2e-3, 1e-6
CANCEL_RTOL, CANCEL_ATOL_FRAC = 5e-3, 1e-3
INTERP = ["TSpline3", "Akima", "Linear", "Monotonic", "KochanekBartels"]
N_BINS = 24


def _inputs(n_params=3, n_chains=5, n_events=1500, n_bins=N_BINS, bf16=False, seed=0):
    """numpy inputs: toy-like responses (1 + slope·σ + curv·σ² at the knots,
    each parameter on the events of one of four modes), per-chain bins with
    out-of-range entries, one chain extrapolated past the last knot."""
    rng = np.random.default_rng(seed)
    modes = rng.integers(0, 4, n_events)
    sigma = np.array([-3.0, -1.0, 0.0, 1.0, 3.0])
    specs = []
    for p in range(n_params):
        ev = np.flatnonzero(modes == p % 4)
        slope = 0.08 * (1.0 + 0.3 * rng.normal(size=(len(ev), 1)))
        curv = 0.01 * rng.normal(size=(len(ev), 1))
        y = np.clip(1.0 + slope * sigma + curv * sigma**2, 0.0, None)
        y[:, 2] = 1.0
        specs.append(dict(name=f"s{p}", param_index=p, x_knots=sigma, event_ids=ev,
                          y_knots=y, interpolation=INTERP[p % 5]))
    params = rng.normal(scale=0.8, size=(n_chains, n_params))
    params[-1, 0] = 3.7
    bins = rng.integers(0, n_bins, size=(n_chains, n_events)).astype(np.int32)
    for bad in (n_bins, -1, n_bins + 7, 1 << 20):  # all dropped
        bins[rng.random((n_chains, n_events)) < 0.02] = bad
    base = rng.uniform(0.5, 2.0, size=(n_chains, n_events)).astype(np.float32)
    return types.SimpleNamespace(specs=specs, params=params, bins=bins, base=base,
                                 n_bins=n_bins, n_events=n_events, bf16=bf16)


def _port_args(d, device="cpu"):
    table = build_dense_table([SplineParamSpec(**s) for s in d.specs], d.n_events,
                              low_memory=d.bf16).to(device)
    params = torch.as_tensor(d.params, device=device)
    seg, t = find_segments(table.knots_x, table.n_knots, params[:, table.param_index])
    return (seg, t, table.coeffs, torch.as_tensor(d.base, device=device),
            torch.as_tensor(d.bins, device=device)), dict(n_bins=d.n_bins)


@pytest.fixture()
def jx(monkeypatch):
    """JAX package pieces, with pallas_call forced into interpret mode
    (as tests/test_pallas.py does)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from mach3_tpu.params.parameterset import SplineInterpolation
    from mach3_tpu.samples.binning import histogram
    from mach3_tpu.splines import monolith
    from mach3_tpu.splines import pallas_reweight as pr
    from mach3_tpu.splines.eval import eval_dense

    orig = pl.pallas_call

    def interpret(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpret)
    for fn in (pr.fused_reweight_histogram, pr.fused_reweight_histogram_shared):
        fn.clear_cache()
    yield types.SimpleNamespace(jax=jax, jnp=jnp, pr=pr, eval_dense=eval_dense,
                                histogram=histogram, monolith=monolith,
                                Interp=SplineInterpolation)
    for fn in (pr.fused_reweight_histogram, pr.fused_reweight_histogram_shared):
        fn.clear_cache()


def _jax_table(jx, d):
    specs = [jx.monolith.SplineParamSpec(**{**s, "interpolation": jx.Interp(s["interpolation"])})
             for s in d.specs]
    return jx.monolith.build_dense_table(specs, d.n_events, low_memory=d.bf16)


def _oracle(jx, d, w_extra=None):
    """f32 oracle from JAX pieces: exact spline eval x base (x w_extra),
    JAX's histogram with every invalid bin sent to its garbage bin."""
    jax, jnp = jx.jax, jx.jnp
    table = _jax_table(jx, d)
    w = np.asarray(jax.vmap(lambda p: jx.eval_dense(table, p, exact=True))(jnp.asarray(d.params)))
    w = w * d.base if w_extra is None else w * d.base * w_extra
    bins = np.broadcast_to(d.bins, w.shape)
    bins = np.where((bins >= 0) & (bins < d.n_bins), bins, d.n_bins)
    mc, w2 = jax.vmap(lambda wc, bc: jx.histogram(wc, bc, d.n_bins))(
        jnp.asarray(w, jnp.float32), jnp.asarray(bins))
    return np.asarray(mc), np.asarray(w2)


def _close(got, want, rtol, atol_frac):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max())


@pytest.mark.parametrize("hist", reweight.HIST_FORMS)
@pytest.mark.parametrize("n_params,bf16", [(3, False), (16, False), (3, True)],
                         ids=["p3", "p16", "p3-bf16"])
def test_plain_version_matches_jax(jx, hist, n_params, bf16):
    d = _inputs(n_params=n_params, bf16=bf16, seed=n_params)
    args, kwargs = _port_args(d)
    mc, w2 = reweight.fused_reweight_histogram(*args, **kwargs, hist=hist)
    assert mc.shape == (5, N_BINS) and mc.dtype == torch.float32
    mc, w2 = mc.numpy(), w2.numpy()
    if not bf16:  # the oracle's exact eval is f32-table only
        mc_o, w2_o = _oracle(jx, d)
        _close(mc, mc_o, ORACLE_RTOL, ATOL_FRAC)
        _close(w2, w2_o, ORACLE_RTOL, ATOL_FRAC)
    jnp = jx.jnp
    table = _jax_table(jx, d)
    mc_j, w2_j = jx.pr.fused_reweight_histogram(
        jx.pr.spline_selector(table, jnp.asarray(d.params)), table.coeffs, jnp.asarray(d.base),
        jnp.asarray(d.bins), n_bins=N_BINS, chain_tile=8, event_tile=512, hist=hist)
    _close(mc, np.asarray(mc_j), PROD_RTOL, PROD_ATOL_FRAC)
    _close(w2, np.asarray(w2_j), PROD_RTOL, PROD_ATOL_FRAC)


def test_plain_version_drops_every_out_of_range_bin():
    d = _inputs(n_chains=2, n_events=50)
    d.bins[0] = -1
    d.bins[1] = np.where(np.arange(50) % 2, N_BINS, 7)
    mc, w2 = reweight.fused_reweight_histogram(*_port_args(d)[0], n_bins=N_BINS)
    assert float(mc[0].abs().sum()) == 0.0 and float(w2[0].abs().sum()) == 0.0
    assert np.flatnonzero(mc[1].numpy()).tolist() == [7]


def test_k4a_trivial_plan_matches_jax(jx):
    """The shared wrapper under a trivial plan, P = 4, events unsorted, the
    norm product in the kernel: K4a's function."""
    jnp = jx.jnp
    d = _inputs(n_params=4, n_bins=30, seed=4)
    rng = np.random.default_rng(5)
    static = d.bins[0].copy()  # one bin map for every chain: shared bins
    static[(static < 0) | (static >= d.n_bins)] = d.n_bins
    d.bins = static
    norm_ext = np.ones((5, 4), np.float32)
    norm_ext[:, :3] = rng.uniform(0.7, 1.3, size=(5, 3))
    norm_ext[-1, 0] = -0.8
    norm_s = np.zeros((4, d.n_events), np.float32)
    norm_s[:3] = rng.integers(0, 3, size=(3, d.n_events))
    norm_s[3] = 1.0
    (seg, t, coeffs, base, bins), _ = _port_args(d)
    starts, widths, ptr, idx, nbl = plan.trivial_plan(d.n_events, 4, d.n_bins)
    mc, w2 = reweight.fused_reweight_histogram_shared(
        seg, t, coeffs, base, bins, n_bins=d.n_bins, tile_start=torch.from_numpy(starts),
        tile_width=torch.from_numpy(widths), plan_ptr=torch.from_numpy(ptr),
        plan_idx=torch.from_numpy(idx), nbl=nbl, norm_ext=torch.from_numpy(norm_ext),
        norm_s=torch.from_numpy(norm_s))
    mc, w2 = mc.numpy(), w2.numpy()
    ext = norm_ext.astype(np.float64)
    norm = (np.exp(np.log(np.abs(ext)) @ norm_s) * (1.0 - 2.0 * (((ext < 0) @ norm_s) % 2)))
    mc_o, w2_o = _oracle(jx, d, norm.astype(np.float32))
    _close(mc, mc_o, ORACLE_RTOL, ATOL_FRAC)
    _close(w2, w2_o, ORACLE_RTOL, ATOL_FRAC)
    assert (mc[-1] < 0).any()  # odd counts of the negative norm flip signs
    table = _jax_table(jx, d)
    mc_j, w2_j = jx.pr.fused_reweight_histogram_shared(
        jx.pr.spline_selector(table, jnp.asarray(d.params)), table.coeffs, jnp.asarray(d.base),
        jnp.asarray(static), n_bins=d.n_bins, chain_tile=8, event_tile=512,
        norm_ext=jnp.asarray(norm_ext), norm_s=jnp.asarray(norm_s))
    _close(mc, np.asarray(mc_j), CANCEL_RTOL, CANCEL_ATOL_FRAC)
    _close(w2, np.asarray(w2_j), CANCEL_RTOL, CANCEL_ATOL_FRAC)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args, kwargs = _port_args(_inputs())
    seg, t, coeffs, base, bins = args
    call = reweight.fused_reweight_histogram
    with pytest.raises(TypeError):
        call(seg, t, coeffs, base, bins.long(), **kwargs)
    with pytest.raises(ValueError):
        call(seg, t, coeffs, base, bins[:, :-1].contiguous(), **kwargs)
    with pytest.raises(ValueError):
        call(seg, t, coeffs, base, bins[0], **kwargs)  # shared bins: another kernel
    with pytest.raises(ValueError):
        call(seg, t, coeffs, base, bins.t().contiguous().t(), **kwargs)
    with pytest.raises(ValueError):
        call(*args, n_bins=reweight.MAX_BINS + 1)
    with pytest.raises(ValueError):
        call(*args, **kwargs, hist="radix")
    before = dict(reweight.LAUNCHES)
    for hist in reweight.HIST_FORMS:
        call(*args, **kwargs, hist=hist)
    assert reweight.LAUNCHES == before  # the plain version is not a launch


# ------------------------------------------------ the bin map (generic route)


@pytest.fixture(scope="module")
def exp_model(tmp_path_factory):
    """The experiment of ``tutorial/experiment_files.py`` at 1,500 events,
    built by the port on the CPU (its generic samples laid out)."""
    from mach3_tpu_torch.core.config import Config
    from mach3_tpu_torch.samples.experiment import build_experiment
    from mach3_tpu_torch.tutorial.experiment_files import write_experiment

    path = write_experiment(tmp_path_factory.mktemp("exp"), n_events=1500, seed=3)
    return build_experiment(Config.from_file(str(path)), device="cpu").model


def _sample(model, name):
    return next(s for s in model.samples if s.name == name)


def _landing(x: np.ndarray, kind: str, v: float) -> np.ndarray:
    """f32 values that the shift (kind, v) moves exactly onto the f32
    values ``x`` (those it cannot are dropped)."""
    x = x.astype(np.float32)
    v32, one = np.float32(v), np.float32(1.0)
    if kind == "scale":
        pre = x / (one + v32)
    elif kind == "offset":
        pre = x - v32
    else:
        pre = one + (x - one) / (one + v32)
    fn = reweight.SHIFT_KINDS[kind][1]
    back = fn(torch.tensor(v32)[None, None], torch.from_numpy(pre)[None])[0].numpy()
    return pre[back == x]


@pytest.mark.parametrize("name", ["numu_2d", "nue_nonuniform"])
def test_perchain_bins_ref_is_the_plain_binning(exp_model, name):
    """On the laid-out sample, with its events moved onto edges (some only
    reach one through chain 1's shift value), into a gap cell, to NaN and
    ±inf, and chains whose shifts push events past both ends."""
    s = copy.deepcopy(_sample(exp_model, name))
    bm = s.bin_map
    assert s.kernel_route.variant == "generic" and bm is not None and s.hist_plan_ptr is not None
    rng = np.random.default_rng(5)
    kin = s.kin.numpy().copy()
    real = np.flatnonzero(~s.event_pad.numpy())
    picks = iter(np.array_split(rng.permutation(real), 8))
    for a, (row, n_edges, _) in enumerate(bm.axes):
        edges = bm.edges[a, :n_edges].numpy()
        on = next(picks)
        kin[row, on] = edges[rng.integers(0, n_edges, len(on))]
        kind = next(k for ax, k in bm.shifts if ax == a)
        land = _landing(edges, kind, 0.125)
        to = next(picks)[:len(land)]
        kin[row, to] = land[rng.integers(0, len(land), len(to))]
    odd = next(picks)[:8]
    kin[bm.axes[0][0], odd] = [np.nan, np.inf, -np.inf, np.nan, np.inf, -np.inf, 0.5, 0.5]
    static_rows = [r for r in s.binning.axis_vars if r not in [ax[0] for ax in bm.axes]]
    for r in static_rows:  # a non-finite value on an axis no shift moves
        kin[r, odd[6:]] = [np.nan, np.inf]
    if name == "nue_nonuniform":  # e_reco < 0.3, cos_theta < 0: no bin there
        gap = next(picks)[:20]
        kin[bm.axes[0][0], gap] = 0.1
        kin[static_rows[0], gap] = -0.5
    s.kin = torch.from_numpy(kin)
    s = s.with_binning(s.binning)  # rebuilds the static part and the map from the new values
    assert s.bin_map is not None
    th = exp_model.prefit_vector().double().repeat(6, 1)
    th[3:] += 0.05 * torch.from_numpy(rng.normal(size=(3, th.shape[1])))
    p = s.bin_map.param_index
    th[0, p] = 0.0  # events on edges sit on them
    th[1, p] = 0.125  # the landing events move onto edges
    th[2, p] = torch.tensor([-0.9, 3.0][:len(p)], dtype=th.dtype)  # far below / past the edges
    got = s.perchain_bins(th).bins(s.n_bins)
    want = s._perchain_bins(th)
    assert got.dtype == torch.int32 and got.shape == want.shape == (6, s.n_events)
    assert torch.equal(got.long(), want)
    assert (want[0] < s.n_bins).any() and (want[0] == s.n_bins).any()
    assert (want[2] == s.n_bins).sum() > (want[0] == s.n_bins).sum()
    assert (want[:, odd[:6]] == s.n_bins).all()
    if name == "nue_nonuniform":
        assert (want[0, gap] == s.n_bins).all()


def _two_shift_sample(order=("scale", "offset"), n=3000, seed=9):
    """Two shifts on one row (x) and one on another (y) of a 2-D binning, a
    unit spline table: the generic route with a bin map."""
    rng = np.random.default_rng(seed)
    ex, ey = np.linspace(0.0, 3.0, 13), np.linspace(0.0, 1.0, 5)
    x = np.concatenate([ex, ex + 0.125, rng.uniform(-0.5, 3.5, n - 26)])
    y = np.concatenate([ey, rng.uniform(-0.1, 1.1, n - 5)])
    events = EventData(kinematics={"x": x, "y": y}, mode=np.zeros(n, np.int32),
                       target=np.full(n, 12, np.int32), pdg=np.full(n, 14, np.int32),
                       preosc_pdg=np.full(n, 14, np.int32), mc_weight=np.ones(n))
    unit = SplineParamSpec("s", 0, np.array([-1.0, 0.0, 1.0]), np.arange(n), np.ones((n, 3)))
    shifts = tuple(ShiftSpec.named(k, 1 + i, 0) for i, k in enumerate(order))
    shifts += (ShiftSpec.named("scale_about_one", 3, 1),)
    return build_sample_model("two", events, ["x", "y"], [ex, ey], ["x", "y"], n_total_params=4,
                              spline_table=build_dense_table([unit], n), shifts=shifts)


@pytest.mark.parametrize("order", [("scale", "offset"), ("offset", "scale")])
def test_two_shifts_on_one_row_bin_as_the_plain_route(order):
    s = _two_shift_sample(order)
    assert s.kernel_route.variant == "generic" and s.bin_map is not None
    assert s.bin_map.shifts == ((0, order[0]), (0, order[1]), (1, "scale_about_one"))
    th = np.zeros((10, 4))
    th[:, 1] = [0.0, 0.25, -0.25, 0.5, 0.125, -0.375, 0.1, -0.3, 1e-7, 0.0]
    th[:, 2] = [0.0, 0.125, 0.25, -0.5, 0.0, 0.375, -0.1, 0.3, -1e-7, 0.25]
    th[:, 3] = [0.0, 0.5, -0.5, 0.25, 0.1, 0.0, -0.25, 0.75, 0.0, 0.0]
    th = torch.from_numpy(th)
    got, want = s.perchain_bins(th).bins(s.n_bins), s._perchain_bins(th)
    assert torch.equal(got.long(), want)
    mc, w2 = s.reweight_batch(th)  # the kernel's plain version on the CPU
    mc_p, w2_p = s.reweight_batch_plain(th)
    assert torch.equal(mc, mc_p) and torch.equal(w2, w2_p)
    assert float(mc.sum()) > 0.4 * 10 * 3000


def test_registered_shift_keeps_bins_as_input():
    s = _two_shift_sample()
    custom = ShiftSpec(None, lambda v, x, kin: x * (1.0 + v), 1, 0)  # torch code, no kind
    s = build_sample_model(
        "custom", EventData(kinematics={"x": s.kin[0].numpy(), "y": s.kin[1].numpy()},
                            mode=np.zeros(s.n_events, np.int32),
                            target=np.full(s.n_events, 12, np.int32),
                            pdg=np.full(s.n_events, 14, np.int32),
                            preosc_pdg=np.full(s.n_events, 14, np.int32),
                            mc_weight=s.mc_weight.numpy()),
        ["x", "y"], [np.linspace(0.0, 3.0, 13), np.linspace(0.0, 1.0, 5)], ["x", "y"],
        n_total_params=4, spline_table=s.spline_table, shifts=(custom, s.shifts[1]))
    assert s.kernel_route.variant == "generic" and s.bin_map is None
    th = torch.zeros((3, 4), dtype=torch.float64)
    th[1, 1], th[2, 2] = 0.25, -0.125
    args, kw = s.perchain_kernel_args(th)
    assert isinstance(args[4], torch.Tensor) and args[4].dtype == torch.int32
    assert torch.equal(args[4].long(), s._perchain_bins(th))
    mc, _ = s.reweight_batch(th)
    assert torch.equal(mc, s.reweight_batch_plain(th)[0])


@pytest.mark.parametrize("name", ["numu_2d", "nue_nonuniform"])
def test_named_shifts_path_calls_neither_plain_binning_nor_norm_gather(exp_model, name,
                                                                        monkeypatch):
    s = _sample(exp_model, name)
    th = exp_model.prefit_vector().double().repeat(4, 1)
    th[1:] += 0.05 * torch.from_numpy(np.random.default_rng(2).normal(size=(3, th.shape[1])))
    mc_p, w2_p = s.reweight_batch_plain(th)

    def forbidden(*a, **k):
        raise AssertionError("called on the sampling path")

    monkeypatch.setattr(SampleModel, "_perchain_bins", forbidden)
    monkeypatch.setattr(SampleModel, "_norm_weights", forbidden)
    args, kw = s.perchain_kernel_args(th)
    assert isinstance(args[4], reweight.PerchainBins) and kw["norm_s"] is s.norm_s
    mc, w2 = s.reweight_batch(th)
    _close(mc.numpy(), mc_p.numpy(), 2e-5, ATOL_FRAC)
    _close(w2.numpy(), w2_p.numpy(), 2e-5, ATOL_FRAC)


@pytest.mark.parametrize("name", ["numu_2d", "nue_nonuniform"])
def test_plan_lists_every_non_identity_parameter(exp_model, name):
    s = _sample(exp_model, name)
    e = s.n_events
    assert e % plan.EVENT_TILE == 0 and (s.mc_weight[s.event_pad] == 0).all()
    act = dense_table_activity(s.spline_table)  # laid-out order
    ptr, idx = s.hist_plan_ptr.numpy(), s.hist_plan_idx.numpy()
    for t in range(e // plan.EVENT_TILE):
        need = set(np.flatnonzero(act[:, t * plan.EVENT_TILE:(t + 1) * plan.EVENT_TILE].any(1)))
        assert need <= set(idx[ptr[t]:ptr[t + 1]].tolist()), t
    assert ptr[-1] < act.shape[0] * (e // plan.EVENT_TILE)  # the plan skips something


def _map_inputs(n_chains=7, n_events=2000, n_bins=None, cells=True, bf16=False, seed=0,
                n_params=4):
    """A synthetic bin map over two axes (x: 12 cells, a scale; y: 4 cells,
    an offset then a scale_about_one) and a static axis of 3, with events on
    edges, NaN and ±inf values, static parts out of range; with ``cells`` a
    cell -> bin map with gaps onto ``n_bins`` bins, else the flat index is
    the bin (144 bins)."""
    d = _inputs(n_params=n_params, n_chains=n_chains, n_events=n_events, bf16=bf16, seed=seed,
                n_bins=24)
    rng = np.random.default_rng(seed + 100)
    ex, ey = np.arange(13) * 0.25, np.arange(5) * 0.25
    x = rng.uniform(-0.3, 3.3, n_events)
    y = rng.uniform(-0.1, 1.1, n_events)
    x[::4] = ex[rng.integers(0, 13, len(x[::4]))]
    y[1::5] = ey[rng.integers(0, 5, len(y[1::5]))]
    x[7::97], y[11::89] = np.nan, np.inf
    x[13::101] = -np.inf
    static = rng.integers(0, 3, n_events).astype(np.int32)
    static[rng.random(n_events) < 0.03] = -1
    n_flat = 12 * 4 * 3
    cell_to_bin = None
    if cells:
        n_bins = n_bins or 24
        cell_to_bin = rng.integers(0, n_bins, n_flat).astype(np.int32)
        cell_to_bin[rng.random(n_flat) < 0.1] = n_bins  # gaps
    else:
        n_bins = n_flat
    shift = rng.normal(scale=0.05, size=(n_chains, 3)).astype(np.float32)
    shift[0] = 0.0
    shift[1] = [1.0, 0.25, 0.5]
    shift[2] = [-0.9, 2.0, -0.99]
    edges = np.full((2, 13), np.inf, np.float32)
    edges[0], edges[1, :5] = ex, ey
    d.map = dict(kin=np.stack([y, x]).astype(np.float32), shift=shift, static=static,
                 edges=edges, cell_to_bin=cell_to_bin, axes=((1, 13, 12), (0, 5, 3)),
                 shifts=((0, "scale"), (1, "offset"), (1, "scale_about_one")))
    d.n_bins = n_bins
    return d


def _map_of(d, device="cpu"):
    m = d.map
    return reweight.PerchainBins(
        torch.as_tensor(m["shift"], device=device), torch.as_tensor(m["kin"], device=device),
        torch.as_tensor(m["static"], device=device), torch.as_tensor(m["edges"], device=device),
        None if m["cell_to_bin"] is None else torch.as_tensor(m["cell_to_bin"], device=device),
        m["axes"], m["shifts"])


def _numpy_bins(d):
    """The map's bins by numpy, in f32: the oracle of perchain_bins_ref."""
    m = d.map
    one = np.float32(1.0)
    sv = m["shift"]
    x = m["kin"][1][None] * (one + sv[:, :1])
    y = m["kin"][0][None] + sv[:, 1:2]
    y = one + (y - one) * (one + sv[:, 2:3])
    flat = np.broadcast_to(m["static"], x.shape).astype(np.int64)
    valid = flat >= 0
    for v, edges, n, stride in ((x, m["edges"][0], 12, 12), (y, m["edges"][1, :5], 4, 3)):
        idx = (edges[None, None, :] <= v[..., None]).sum(-1) - 1
        valid &= (idx >= 0) & (idx < n)
        flat = flat + idx * stride
    if m["cell_to_bin"] is not None:
        flat = m["cell_to_bin"][np.where(valid, flat, 0)]
    return np.where(valid, flat, d.n_bins)


@pytest.mark.parametrize("cells", [True, False], ids=["cells", "flat"])
def test_perchain_bins_ref_matches_a_numpy_binning(cells):
    d = _map_inputs(cells=cells)
    got = _map_of(d).bins(d.n_bins).numpy()
    want = _numpy_bins(d)
    assert np.array_equal(got, want)
    assert (want < d.n_bins).mean() > 0.3 and (want == d.n_bins).any()
    args, kwargs = _port_args(d)
    mc, w2 = reweight.fused_reweight_histogram(*args[:4], _map_of(d), n_bins=d.n_bins)
    mc_g, w2_g = reweight.fused_reweight_histogram(*args[:4], torch.from_numpy(want.astype(
        np.int32)), n_bins=d.n_bins)
    assert torch.equal(mc, mc_g) and torch.equal(w2, w2_g)


MAP_CHECKS = {
    "five_axes": lambda m: dataclasses_replace(m, axes=m.axes * 3, edges=m.edges.repeat(3, 1)[:5]),
    "nine_shifts": lambda m: dataclasses_replace(m, shifts=((0, "scale"),) * 9,
                                                 shift_vals=m.shift_vals.repeat(1, 3)),
    "ungrouped_shifts": lambda m: dataclasses_replace(
        m, shifts=((1, "offset"), (0, "scale"), (1, "scale_about_one"))),
    "unknown_kind": lambda m: dataclasses_replace(m, shifts=((0, "log"),) + m.shifts[1:]),
    "row_past_kin": lambda m: dataclasses_replace(m, axes=((2, 13, 12), m.axes[1])),
    "edges_past_pitch": lambda m: dataclasses_replace(m, axes=((1, 14, 12), m.axes[1])),
    "too_many_cells": lambda m: dataclasses_replace(
        m, cell_to_bin=torch.zeros(reweight.MAX_MAP_CELLS + 1, dtype=torch.int32)),
    "shift_vals_shape": lambda m: dataclasses_replace(m, shift_vals=m.shift_vals[:, :2]),
    "cells_int64": lambda m: dataclasses_replace(m, cell_to_bin=m.cell_to_bin.long()),
}


def dataclasses_replace(m, **changes):
    import dataclasses

    return dataclasses.replace(m, **changes)


@pytest.mark.parametrize("case", list(MAP_CHECKS))
def test_wrapper_rejects_a_bin_map_the_kernel_does_not_take(case):
    d = _map_inputs()
    args, kwargs = _port_args(d)
    bad = MAP_CHECKS[case](_map_of(d))
    with pytest.raises((ValueError, TypeError)):
        reweight.fused_reweight_histogram(*args[:4], bad, **kwargs)


# ---------------------------------------------------------------- the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


def _edge_case(case):
    if case == "b512_p16":
        return _inputs(n_params=16, n_chains=9, n_events=6000, n_bins=512)
    if case == "one_event":
        return _inputs(n_params=4, n_chains=3, n_events=1)
    if case == "all_out_of_range":
        d = _inputs(n_params=4, n_chains=6, n_events=3000)
        d.bins[:] = np.where(np.arange(d.n_events) % 2, -1, d.n_bins)
        return d
    if case == "chains_not_multiple":
        return _inputs(n_params=5, n_chains=13, n_events=5000, n_bins=240)
    return _inputs(n_params=4, n_chains=17, n_events=7000, n_bins=100, bf16=True)


CUDA_CASES = ["b512_p16", "one_event", "all_out_of_range", "chains_not_multiple", "bf16"]
_COUNTER = {"maskreduce": "reweight_perchain", "blockdiag": "reweight_perchain_blockdiag"}


@pytest.mark.cuda
@pytest.mark.parametrize("hist", reweight.HIST_FORMS)
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernels_match_plain_version(cuda_device, case, hist):
    d = _edge_case(case)
    args, kwargs = _port_args(d, cuda_device)
    before = reweight.LAUNCHES[_COUNTER[hist]]
    mc, w2 = reweight.fused_reweight_histogram(*args, **kwargs, hist=hist)
    torch.cuda.synchronize()
    assert reweight.LAUNCHES[_COUNTER[hist]] == before + 1
    mc_p, w2_p = reweight.fused_reweight_histogram_ref(*args, **kwargs)
    if case == "all_out_of_range":
        assert float(mc.abs().sum()) == 0.0 and float(w2.abs().sum()) == 0.0
        return
    _close(mc.cpu().numpy(), mc_p.cpu().numpy(), 2e-5, ATOL_FRAC)
    _close(w2.cpu().numpy(), w2_p.cpu().numpy(), 2e-5, ATOL_FRAC)
    assert mc.abs().sum() > 0


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["given", "map"])
def test_cuda_blockdiag_is_deterministic(cuda_device, source):
    """K5b adds in a fixed order: two runs agree bit for bit."""
    if source == "map":
        args, kwargs = _map_args(_map_inputs(n_chains=33, n_events=20000, n_params=6),
                                 cuda_device, layout=True, norm=True)
    else:
        args, kwargs = _port_args(_inputs(n_params=6, n_chains=33, n_events=20000, n_bins=200),
                                  cuda_device)
    a = reweight.fused_reweight_histogram(*args, **kwargs, hist="blockdiag")
    b = reweight.fused_reweight_histogram(*args, **kwargs, hist="blockdiag")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert float(a[0].abs().sum()) > 0


def _map_args(d, device, layout=False, norm=False):
    """(args, kwargs) of the per-chain wrapper with the bin map of
    :func:`_map_inputs`; ``layout``: the events laid out by
    ``plan.shifted_layout`` (pads of weight 0) with its plan; ``norm``: the
    norm product in the kernel, a negative value in the last chain."""
    table = build_dense_table([SplineParamSpec(**sp) for sp in d.specs], d.n_events,
                              low_memory=d.bf16)
    m = d.map
    kin, static, base = m["kin"], m["static"], d.base.copy()
    kw = dict(n_bins=d.n_bins)
    n_ev = d.n_events
    perm = np.arange(n_ev)
    if layout:
        lay = plan.shifted_layout(dense_table_activity(table))
        perm, tp = lay.event_perm, torch.from_numpy(lay.param_perm)
        te = torch.from_numpy(perm)
        table = DenseSplineTable(table.coeffs.index_select(0, tp).index_select(2, te),
                                 table.knots_x[tp], table.n_knots[tp], table.param_index[tp])
        kin, static, base = kin[:, perm], static[perm], base[:, perm]
        base[:, lay.pad_mask] = 0.0
        kw.update(plan_ptr=torch.as_tensor(lay.plan_ptr, device=device),
                  plan_idx=torch.as_tensor(lay.plan_idx, device=device))
    if norm:
        rng = np.random.default_rng(17)
        c = d.params.shape[0]
        ext = np.ones((c, 4), np.float32)
        ext[:, :3] = rng.uniform(0.7, 1.3, size=(c, 3))
        ext[-1, 0] = -0.8
        match = np.zeros((4, n_ev), np.float32)
        match[:3] = rng.integers(0, 2, size=(3, n_ev))
        match[3] = 1.0
        kw.update(norm_ext=torch.as_tensor(ext, device=device),
                  norm_s=torch.as_tensor(np.ascontiguousarray(match[:, perm]), device=device))
    table = table.to(device)
    params = torch.as_tensor(d.params, device=device)
    seg, t = find_segments(table.knots_x, table.n_knots, params[:, table.param_index])
    laid = types.SimpleNamespace(map=dict(m, kin=np.ascontiguousarray(kin),
                                          static=np.ascontiguousarray(static)))
    return (seg, t, table.coeffs, torch.as_tensor(np.ascontiguousarray(base), device=device),
            _map_of(laid, device)), kw


def _map_case(case):
    if case == "b512_p16":
        return _map_inputs(n_params=16, n_chains=9, n_events=8192, n_bins=512)
    if case == "flat_bins":
        return _map_inputs(n_chains=17, n_events=5120, cells=False)
    if case == "chains_not_multiple":
        return _map_inputs(n_chains=13, n_events=4096, n_params=5)
    if case == "events_not_multiple":  # rows not 16-byte aligned: plain loads
        return _map_inputs(n_chains=11, n_events=5001)
    if case == "bf16_unaligned":
        return _map_inputs(n_chains=17, n_events=7001, bf16=True)
    return _map_inputs(n_chains=20, n_events=9000, bf16=case.endswith("bf16"))


MAP_CUDA_CASES = ["edges_cells", "b512_p16", "flat_bins", "chains_not_multiple",
                  "events_not_multiple", "bf16_unaligned", "plan_norm", "plan_norm_bf16"]


@pytest.mark.cuda
@pytest.mark.parametrize("hist", reweight.HIST_FORMS)
@pytest.mark.parametrize("case", MAP_CUDA_CASES)
def test_cuda_bin_map_matches_plain_version(cuda_device, case, hist):
    """The kernel binning from a bin map (edge events, NaN and ±inf values,
    gap cells, static parts out of range; under a plan with the norm in the
    kernel for the plan cases) against the plain version, and against the
    same kernel fed the map's plain bins."""
    d = _map_case(case)
    planned = case.startswith("plan")
    args, kwargs = _map_args(d, cuda_device, layout=planned, norm=planned)
    before = reweight.LAUNCHES[_COUNTER[hist]]
    mc, w2 = reweight.fused_reweight_histogram(*args, **kwargs, hist=hist)
    torch.cuda.synchronize()
    assert reweight.LAUNCHES[_COUNTER[hist]] == before + 1
    mc_p, w2_p = reweight.fused_reweight_histogram_ref(*args, **kwargs)
    _close(mc.cpu().numpy(), mc_p.cpu().numpy(), 2e-5, ATOL_FRAC)
    _close(w2.cpu().numpy(), w2_p.cpu().numpy(), 2e-5, ATOL_FRAC)
    given = args[:4] + (args[4].bins(d.n_bins),)
    mc_g, w2_g = reweight.fused_reweight_histogram(*given, **kwargs, hist=hist)
    _close(mc.cpu().numpy(), mc_g.cpu().numpy(), 2e-5, ATOL_FRAC)
    _close(w2.cpu().numpy(), w2_g.cpu().numpy(), 2e-5, ATOL_FRAC)
    assert mc.abs().sum() > 0 and (mc_p == 0).any()
