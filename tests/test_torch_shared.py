"""The shared-bins reweight-histogram (K2) of the port, its event layout, and
the shifted kernel at K3's shapes, vs the JAX package.

* Layout helpers (``splines/plan.py``, ``dense_table_activity``): the
  activity pattern and the parameter regrouping are JAX's exactly; the
  layout keeps Σw and Σw² per bin; each tile's list is exactly the
  parameters that are not the identity on its events; no tile straddles an
  activity group or spans more than ``MAX_WINDOW`` bins.
* The plain version of the shared kernel (the wrapper on CPU tensors) vs
  JAX's ``fused_reweight_histogram_shared`` in Pallas interpret mode, in the
  sorted/planned form (K2, JAX's own window and block plan for its tile) and
  the wide forms (K4a unblocked, K4b param-blocked): within rtol 5e-3,
  atol 1e-3·max. JAX rounds every response deviation to bf16 (~0.4% of
  |resp − 1|, up to ~1.6% of a response extrapolated to 3.7σ), the port
  keeps f32; these inputs have ~4 events per bin and ~5 active responses per
  event, and Σw² doubles a weight's relative error, so JAX's production
  output is itself 1.6e-3 (Σw) and 3.4e-3 (Σw²) from the f32 oracle here,
  and more in bins where negative weights cancel. Against that oracle
  (``eval_dense(exact=True)``) the port holds rtol 2e-5, atol 1e-6·max (f32
  sums in another order).
* K3's shapes (P = 20 > 16, bf16 table) through the port's shifted plain
  version vs JAX's param-blocked shifted kernel in interpret mode, the
  production budget above.

The ``cuda``-marked tests hold the CUDA kernel to the plain version on edge
cases; they import no jax and run with ``--noconftest`` where a card is.
"""
import types

import numpy as np
import pytest
import torch

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

N_BINS = 500
ORACLE_RTOL, ATOL_FRAC = 2e-5, 1e-6
PROD_RTOL, PROD_ATOL_FRAC = 5e-3, 1e-3
INTERP = ["TSpline3", "Akima", "Linear", "Monotonic", "KochanekBartels"]


def _specs(rng, modes, n_params):
    """Toy-like responses (1 + slope·σ + curv·σ² at the knots), each
    parameter on the events of one mode (as the large fixture's are)."""
    sigma = np.array([-3.0, -1.0, 0.0, 1.0, 3.0])
    specs = []
    for p in range(n_params):
        ev = np.flatnonzero(modes == p % 4)
        slope = 0.06 * (1.0 + 0.3 * rng.normal(size=(len(ev), 1)))
        curv = 0.008 * rng.normal(size=(len(ev), 1))
        y = np.clip(1.0 + slope * sigma + curv * sigma**2, 0.0, None)
        y[:, 2] = 1.0
        specs.append(dict(name=f"s{p}", param_index=p, x_knots=sigma, event_ids=ev,
                          y_knots=y, interpolation=INTERP[p % 5]))
    return specs


def _inputs(case="norm", n_chains=5, n_events=2048, n_params=20, n_bins=N_BINS, seed=0):
    """numpy inputs of one case, in the original event order."""
    rng = np.random.default_rng(seed)
    modes = rng.integers(0, 4, n_events)
    params = np.zeros((n_chains, n_params))
    params[:] = rng.normal(scale=0.8, size=(n_chains, n_params))
    params[-1, 0] = 3.7  # extrapolation past the last knot
    bins = rng.integers(0, n_bins, n_events).astype(np.int32)
    bins[rng.choice(n_events, size=n_events // 50, replace=False)] = n_bins  # garbage
    base = rng.uniform(0.5, 2.0, size=(n_chains, n_events)).astype(np.float32)
    norm_ext = norm_s = None
    if case != "no_norm":
        norm_ext = np.ones((n_chains, 4), np.float32)
        norm_ext[:, :3] = rng.uniform(0.7, 1.3, size=(n_chains, 3))
        if case == "negative_norm":
            norm_ext[-1, 0] = -0.8
        if case == "zero_norm":
            norm_ext[-1, 1] = 0.0
        norm_s = np.zeros((4, n_events), np.float32)
        norm_s[0] = rng.integers(0, 3, size=n_events)  # repeated matches: parity
        norm_s[1] = rng.integers(0, 2, size=n_events)
        norm_s[2] = rng.integers(0, 2, size=n_events)
        norm_s[3] = 1.0  # the unit slot
    return types.SimpleNamespace(
        specs=_specs(rng, modes, n_params), params=params, bins=bins, base=base,
        norm_ext=norm_ext, norm_s=norm_s, low_memory=case == "bf16", n_bins=n_bins,
        n_events=n_events,
    )


def _laid_out(d, device="cpu", trivial=False):
    """(args, kwargs, layout) of the port's wrapper: the events laid out by
    ``shared_layout`` (pads weigh 0), or in their order with a trivial plan."""
    table = build_dense_table([SplineParamSpec(**s) for s in d.specs], d.n_events,
                              low_memory=d.low_memory)
    if trivial:
        lay = None
        perm, pad = np.arange(d.n_events), np.zeros(d.n_events, bool)
        pperm = np.arange(table.n_spline_params)
        starts, widths, ptr, idx, nbl = plan.trivial_plan(d.n_events, len(pperm), d.n_bins)
    else:
        lay = plan.shared_layout(dense_table_activity(table), d.bins, d.n_bins)
        perm, pad, pperm = lay.event_perm, lay.pad_mask, lay.param_perm
        starts, widths, ptr, idx, nbl = (lay.tile_start, lay.tile_width, lay.plan_ptr,
                                         lay.plan_idx, lay.nbl)
    tp, te = torch.from_numpy(pperm), torch.from_numpy(perm)
    table = DenseSplineTable(table.coeffs.index_select(0, tp).index_select(2, te),
                             table.knots_x[tp], table.n_knots[tp], table.param_index[tp])
    table = table.to(device)
    params = torch.as_tensor(d.params, device=device)
    seg, t = find_segments(table.knots_x, table.n_knots, params[:, table.param_index])
    base = d.base[:, perm].copy()
    base[:, pad] = 0.0

    def dev(a, dtype=None):
        return None if a is None else torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                                                      device=device)

    args = (seg, t, table.coeffs, dev(base), dev(d.bins[perm]))
    kwargs = dict(n_bins=d.n_bins, tile_start=dev(starts), tile_width=dev(widths),
                  plan_ptr=dev(ptr), plan_idx=dev(idx), nbl=nbl, norm_ext=dev(d.norm_ext),
                  norm_s=None if d.norm_s is None else dev(d.norm_s[:, perm]))
    return args, kwargs, types.SimpleNamespace(lay=lay, perm=perm, pad=pad, pperm=pperm,
                                               base=base)


def _close(got, want, rtol=ORACLE_RTOL, atol_frac=ATOL_FRAC):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max())


def _close_to_production(got, want):
    _close(got, want, PROD_RTOL, PROD_ATOL_FRAC)


# ----------------------------------------------------------------- layout


def test_layout_keeps_sums_and_plans_exactly():
    d = _inputs("norm", n_events=3000, n_params=20)
    args, kwargs, lo = _laid_out(d)
    lay = lo.lay
    e2 = len(lay.event_perm)
    assert e2 % plan.EVENT_TILE == 0 and e2 >= d.n_events
    assert np.array_equal(np.sort(lay.event_perm[~lay.pad_mask]), np.arange(d.n_events))
    # Σw and Σw² per bin kept (pads weigh 0)
    w = np.ones(d.n_events) * np.arange(1, d.n_events + 1)
    w_new = np.where(lay.pad_mask, 0.0, w[lay.event_perm])
    b_new = d.bins[lay.event_perm]
    for p in (1, 2):
        want = np.bincount(d.bins, w**p, minlength=d.n_bins + 1)
        got = np.bincount(b_new, w_new**p, minlength=d.n_bins + 1)
        np.testing.assert_allclose(got, want, rtol=1e-12)
    # the plan lists exactly each tile's non-identity parameters
    act = dense_table_activity(types.SimpleNamespace(coeffs=args[2]))
    act[:, lay.pad_mask] = False
    gid = plan.event_groups(act)
    for t in range(lay.n_tiles):
        cols = slice(t * plan.EVENT_TILE, (t + 1) * plan.EVENT_TILE)
        listed = lay.plan_idx[lay.plan_ptr[t]:lay.plan_ptr[t + 1]]
        assert listed.tolist() == np.flatnonzero(act[:, cols].any(1)).tolist()
        real = ~lay.pad_mask[cols]
        assert len(set(gid[cols][real].tolist())) <= 1  # no tile straddles a group
        tb = b_new[cols][real]
        tb = tb[tb < d.n_bins]
        if tb.size:
            assert lay.tile_start[t] <= tb.min() and tb.max() < lay.tile_start[t] + lay.tile_width[t]
            assert lay.tile_start[t] % plan.WINDOW_ALIGN == 0
            assert lay.tile_width[t] <= plan.MAX_WINDOW
    assert lay.nbl == lay.tile_width.max() <= plan.MAX_WINDOW
    assert lay.mean_active() < 20  # mode-filtered params are skipped


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
    pr.fused_reweight_histogram_shared.clear_cache()
    pr.fused_reweight_histogram_shifted.clear_cache()
    yield types.SimpleNamespace(
        jax=jax, jnp=jnp, pr=pr, eval_dense=eval_dense, histogram=histogram,
        monolith=monolith, Interp=SplineInterpolation,
    )
    pr.fused_reweight_histogram_shared.clear_cache()
    pr.fused_reweight_histogram_shifted.clear_cache()


def _jax_table(jx, d, lo=None):
    specs = [jx.monolith.SplineParamSpec(**{**s, "interpolation": jx.Interp(s["interpolation"])})
             for s in d.specs]
    table = jx.monolith.build_dense_table(specs, d.n_events, low_memory=d.low_memory)
    if lo is None:
        return table
    jnp = jx.jnp
    pp, ep = jnp.asarray(lo.pperm), jnp.asarray(lo.perm)
    return table.replace(coeffs=jnp.take(jnp.take(table.coeffs, pp, axis=0), ep, axis=2),
                         knots_x=jnp.take(table.knots_x, pp, axis=0),
                         n_knots=jnp.take(table.n_knots, pp, axis=0),
                         param_index=jnp.take(table.param_index, pp, axis=0))


def test_activity_and_param_order_are_jax_s(jx):
    d = _inputs("bf16", n_events=1000, n_params=12)
    table = build_dense_table([SplineParamSpec(**s) for s in d.specs], d.n_events,
                              low_memory=True)
    act = dense_table_activity(table)
    assert np.array_equal(act, jx.monolith.dense_table_activity(_jax_table(jx, d)))
    assert act.any(1).all() and not act.all()
    assert np.array_equal(plan.param_order(act), jx.pr.param_block_order(act))


def _oracle(jx, d, lo):
    """f32 oracle from JAX pieces on the laid-out events; the norm product
    with the kernels' semantics (|ext| floored at 1e-30)."""
    jax, jnp = jx.jax, jx.jnp
    table = _jax_table(jx, d, lo)
    w = jax.vmap(lambda p: jx.eval_dense(table, p, exact=True))(jnp.asarray(d.params))
    w = np.asarray(w) * lo.base
    if d.norm_ext is not None:
        s = d.norm_s[:, lo.perm].astype(np.float64)
        ext = d.norm_ext.astype(np.float64)
        w = w * (np.exp(np.log(np.maximum(np.abs(ext), 1e-30)) @ s)
                 * (1.0 - 2.0 * (((ext < 0) @ s) % 2))).astype(np.float32)
    bins = jnp.asarray(d.bins[lo.perm])
    mc, w2 = jax.vmap(lambda wc: jx.histogram(wc, bins, d.n_bins))(jnp.asarray(w, jnp.float32))
    return np.asarray(mc), np.asarray(w2)


def _jax_shared(jx, d, lo, form):
    """JAX's production kernel on the laid-out events: "sorted" (K2 with
    JAX's window and block plan for its own tile), "wide" (K4a) or
    "blocked" (K4b)."""
    jnp, pr = jx.jnp, jx.pr
    table = _jax_table(jx, d, lo)
    selector = pr.spline_selector(table, jnp.asarray(d.params))
    kw = dict(n_bins=d.n_bins, chain_tile=8, event_tile=128)
    if d.norm_ext is not None:
        kw.update(norm_ext=jnp.asarray(d.norm_ext), norm_s=jnp.asarray(d.norm_s[:, lo.perm]))
    bins = d.bins[lo.perm]
    if form != "wide":
        kw["param_tile"] = 8
    if form == "sorted":
        act = np.array(jx.monolith.dense_table_activity(table))
        act[:, lo.pad] = False
        starts, nbl = pr.hist_tile_plan(bins, d.n_bins, 128)
        block_plan, block_nact = pr.param_block_plan(act, 128, 8)
        assert block_plan.shape[1] < 3  # the plan skips blocks
        kw.update(tile_starts=jnp.asarray(starts), nbl=int(nbl),
                  block_plan=jnp.asarray(block_plan), block_nact=jnp.asarray(block_nact))
    mc, w2 = pr.fused_reweight_histogram_shared(
        selector, table.coeffs, jnp.asarray(lo.base), jnp.asarray(bins), **kw)
    return np.asarray(mc), np.asarray(w2)


@pytest.mark.parametrize("form,case", [
    ("sorted", "norm"), ("sorted", "bf16"), ("sorted", "negative_norm"),
    ("wide", "no_norm"), ("blocked", "norm"),
])
def test_plain_version_matches_jax(jx, form, case):
    n_params = 6 if form == "wide" else 20
    d = _inputs(case, n_params=n_params, seed=1)
    args, kwargs, lo = _laid_out(d)
    mc, w2 = reweight.fused_reweight_histogram_shared(*args, **kwargs)
    assert mc.shape == (5, d.n_bins) and mc.dtype == torch.float32
    mc, w2 = mc.numpy(), w2.numpy()
    if case != "bf16":  # the oracle's exact eval is f32-table only
        mc_o, w2_o = _oracle(jx, d, lo)
        _close(mc, mc_o, ORACLE_RTOL)
        _close(w2, w2_o, ORACLE_RTOL)
    mc_j, w2_j = _jax_shared(jx, d, lo, form)
    _close_to_production(mc, mc_j)
    _close_to_production(w2, w2_j)
    if case == "negative_norm":
        assert (mc[-1] < 0).any()  # odd counts of the negative norm flip signs


def test_plain_version_drops_negative_bins(jx):
    """A bin of −1 is dropped, as the kernel and the per-chain plain version
    drop it: on chain 0 (where it would index before the histogram) and on
    every later chain (where it would land in the previous chain's garbage
    bin) alike. JAX's shared kernel (interpret mode, wide form) is fed the
    garbage bin ``n_bins`` there, its own drop."""
    d = _inputs("norm", n_events=600, n_params=6, seed=6)
    neg = np.random.default_rng(6).choice(d.n_events, 40, replace=False)
    d.bins[neg] = -1
    args, kwargs, lo = _laid_out(d, trivial=True)
    mc, w2 = reweight.fused_reweight_histogram_shared(*args, **kwargs)
    garbage = (*args[:4], torch.where(args[4] < 0, d.n_bins, args[4]))
    mc_g, w2_g = reweight.fused_reweight_histogram_shared(*garbage, **kwargs)
    assert torch.equal(mc, mc_g) and torch.equal(w2, w2_g)
    d.bins[neg] = d.n_bins
    mc_j, w2_j = _jax_shared(jx, d, lo, "wide")
    for c in (0, 2):
        _close_to_production(mc[c].numpy(), mc_j[c])
        _close_to_production(w2[c].numpy(), w2_j[c])
    _close_to_production(mc.numpy(), mc_j)


def test_plain_version_ignores_the_plan():
    """The plan only skips exact identities: any plan gives the same sums."""
    d = _inputs("norm", n_events=700, n_params=8, seed=2)
    a1, k1, _ = _laid_out(d)
    a2, k2, _ = _laid_out(d, trivial=True)
    for x, y in zip(reweight.fused_reweight_histogram_shared(*a1, **k1),
                    reweight.fused_reweight_histogram_shared(*a2, **k2)):
        _close(x.numpy(), y.numpy(), ORACLE_RTOL)


def test_shifted_plain_version_at_k3_shapes(jx):
    """P = 20 > 16 and a bf16 table: the port's shifted plain version vs
    JAX's param-blocked shifted kernel (K3) in interpret mode."""
    jnp = jx.jnp
    d = _inputs("bf16", n_events=900, n_params=20, seed=3)
    edges = np.linspace(0.0, 3.0, 16)
    rng = np.random.default_rng(4)
    shift = rng.uniform(-0.1, 0.1, size=5).astype(np.float32)
    x_nom = rng.uniform(-0.2, 3.2, size=d.n_events).astype(np.float32)
    static = np.zeros(d.n_events, np.int32)
    norm_ext, norm_s = np.ones((5, 4), np.float32), np.ones((4, d.n_events), np.float32)
    norm_ext[:, :3] = rng.uniform(0.8, 1.2, size=(5, 3))
    norm_s[:3] = rng.integers(0, 2, size=(3, d.n_events))
    table = build_dense_table([SplineParamSpec(**s) for s in d.specs], d.n_events,
                              low_memory=True)
    params = torch.from_numpy(d.params)
    seg, t = find_segments(table.knots_x, table.n_knots, params[:, table.param_index])
    mc, w2 = reweight.fused_reweight_histogram_shifted(
        seg, t, table.coeffs, torch.from_numpy(d.base), torch.from_numpy(shift),
        torch.from_numpy(x_nom), torch.from_numpy(static),
        torch.from_numpy(edges.astype(np.float32)), n_bins=15, shift_kind="scale", stride_j=1,
        n_axis_j=15, norm_ext=torch.from_numpy(norm_ext), norm_s=torch.from_numpy(norm_s))
    jt = _jax_table(jx, d)
    mc_j, w2_j = jx.pr.fused_reweight_histogram_shifted(
        jx.pr.spline_selector(jt, jnp.asarray(d.params)), jt.coeffs, jnp.asarray(d.base),
        jnp.asarray(shift), jnp.asarray(x_nom), jnp.asarray(static), n_bins=15,
        shift_fn=lambda v, x: x * (1.0 + v), edges=tuple(float(e) for e in edges), stride_j=1,
        n_axis_j=15, chain_tile=4, event_tile=256, param_tile=8,
        norm_ext=jnp.asarray(norm_ext), norm_s=jnp.asarray(norm_s))
    _close_to_production(mc.numpy(), np.asarray(mc_j))
    _close_to_production(w2.numpy(), np.asarray(w2_j))


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args, kwargs, _ = _laid_out(_inputs("norm", n_events=600, n_params=8))
    seg, t, coeffs, base, bins = args
    call = reweight.fused_reweight_histogram_shared
    with pytest.raises(TypeError):
        call(seg, t, coeffs, base, bins.long(), **kwargs)
    with pytest.raises(ValueError):
        call(seg, t, coeffs, base[:, :-1], bins, **kwargs)
    with pytest.raises(ValueError):
        call(*args, **{**kwargs, "tile_start": kwargs["tile_start"][:-1]})
    with pytest.raises(ValueError):
        call(*args, **{**kwargs, "nbl": 0})
    with pytest.raises(ValueError):  # a window past a block's shared memory
        call(*args, **{**kwargs, "n_bins": 4000, "nbl": 4000})
    with pytest.raises(ValueError):
        call(*args, **{**kwargs, "n_bins": reweight.MAX_SHARED_BINS + 1})
    with pytest.raises(ValueError):
        call(*args, **{**kwargs, "norm_s": None})
    before = dict(reweight.LAUNCHES)
    call(*args, **kwargs)
    assert reweight.LAUNCHES == before  # the plain version is not a launch


# ---------------------------------------------------------------- the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


def _edge_case(case):
    """(inputs, trivial plan?) of one edge case of the CUDA kernel."""
    if case == "single_event":
        return _inputs("norm", n_chains=3, n_events=1, n_params=4), False
    if case == "chains_not_multiple":
        return _inputs("norm", n_chains=21, n_events=3000, n_params=20), False
    if case == "window_at_last_bins":
        d = _inputs("norm", n_chains=7, n_events=1500, n_params=8)
        d.bins = (d.n_bins - 1 - (np.arange(d.n_events) % 5)).astype(np.int32)
        return d, False
    if case == "all_inactive_tile":
        d = _inputs("no_norm", n_chains=7, n_events=1500, n_params=8)
        d.specs = [s for s in d.specs if s["param_index"] % 4 != 0]  # mode-0 events: no spline
        for i, s in enumerate(d.specs):
            s["param_index"] = i
        d.params = d.params[:, :len(d.specs)]
        return d, False
    if case == "nan_kinematics":
        d = _inputs("norm", n_chains=7, n_events=1500, n_params=8)
        kin = np.random.default_rng(5).uniform(0.0, 1.0, size=(1, d.n_events)).astype(np.float32)
        kin[0, ::7] = np.nan
        binning = SampleBinning.build([np.linspace(0.0, 1.0, d.n_bins + 1)], [0])
        d.bins = binning.find_bins(torch.from_numpy(kin)).numpy().astype(np.int32)
        assert (d.bins[::7] == d.n_bins).all()
        return d, False
    if case == "wide_trivial_plan":  # K4a/K4b's form: all params, the whole bin axis
        return _inputs("norm", n_chains=7, n_events=1500, n_params=20, n_bins=1200), True
    return _inputs(case, n_chains=19, n_events=5000, n_params=20), False


CUDA_CASES = ["norm", "no_norm", "negative_norm", "zero_norm", "bf16", "single_event",
              "chains_not_multiple", "window_at_last_bins", "all_inactive_tile",
              "nan_kinematics", "wide_trivial_plan"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, case):
    d, trivial = _edge_case(case)
    args, kwargs, lo = _laid_out(d, cuda_device, trivial=trivial)
    if case == "all_inactive_tile":
        ptr = kwargs["plan_ptr"].cpu().numpy()
        assert (np.diff(ptr) == 0).any()
    before = reweight.LAUNCHES["reweight_shared"]
    mc, w2 = reweight.fused_reweight_histogram_shared(*args, **kwargs)
    torch.cuda.synchronize()
    assert reweight.LAUNCHES["reweight_shared"] == before + 1
    mc_p, w2_p = reweight.fused_reweight_histogram_shared_ref(*args, **kwargs)
    _close(mc.cpu().numpy(), mc_p.cpu().numpy(), ORACLE_RTOL)
    _close(w2.cpu().numpy(), w2_p.cpu().numpy(), ORACLE_RTOL)
    assert mc.abs().sum() > 0
