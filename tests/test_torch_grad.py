"""The gradient path of the port (``splines/grad.py``, the differentiable
sample and model) vs the JAX package.

* The backward (K6a + K6b fused; on the CPU its plain passes) against JAX's
  ``_grad_backward`` in Pallas interpret mode, on synthetic inputs: shared
  and per-chain bins, P ≤ 16 and P > 16 (param-blocked in JAX), bins out of
  range, zero responses (nz = 0, 1, ≥ 2). The port's ḡ_t is held to JAX's
  ḡ_selector contracted with ∂selector/∂t = [0, 1, 2t, 3t²] at the segment.
  JAX rounds its responses' deviations and both operands of its pass-B dot
  to bf16, the port keeps f32: ḡ_base within 1e-2 relative (+1e-3·max) and
  ḡ_t within 2e-2 of Σ_e |term| per (chain, param); measured gaps in
  ROADMAP Queue 3.
* Against the port's own f32 autograd of ``spline_product`` + histogram:
  rtol 1e-5·P (elementwise ḡ_base), 1e-5·P of Σ_e |term| (ḡ_t). In f64 the
  plain backward passes ``torch.autograd.gradcheck``.
* The autograd ``Function``s (shared route under a plan, shifted route)
  against autograd of the plain route, same tolerances.
* Sample and model level: the toy (JAX ``use_pallas=True``, interpret mode)
  and ``build_large`` at the test size of ``tests/test_torch_large.py``
  (against ``jax.grad`` of JAX's XLA route with the f32-oracle spline eval,
  oscillation grids held fixed), values within the NLL budgets of
  ``tests/test_torch_toy.py``. Gradients, as a fraction of each chain's
  largest component: within 2e-3 of the f32 oracle's (measured 1.1e-3 on
  the toy's numu sample, whose Asimov statistic's slope is a small
  residual, and ≤ 6.6e-6 on the large fixture), within 0.15 of JAX's
  production diff path (bf16 response deviations; measured 8.1e-2) and
  within 3e-4 of the port's own plain route. Oscillation gradients alone
  (beam grids, layered PREM) within 1e-6 relative of the largest.
* Each of the six test statistics' gradients against ``jax.grad`` of the
  JAX one, the ``LOW_MC_BOUND`` clamps, ``data == 0`` and ``w2 == 0``
  included: rtol 1e-9 (same f64 formulas).

The ``cuda``-marked tests hold the backward kernel to its plain passes on
edge cases (more in ``tests/test_torch_backward.py``); they import no jax and
run with ``--noconftest`` where a card is.
"""
import types

import numpy as np
import pytest
import torch

from mach3_tpu_torch.samples.binning import SampleBinning, histogram
from mach3_tpu_torch.splines import grad, plan, reweight
from mach3_tpu_torch.splines.eval import coefficient_rows, find_segments, spline_product
from mach3_tpu_torch.splines.monolith import (
    DenseSplineTable,
    SplineParamSpec,
    build_dense_table,
    dense_table_activity,
)

torch.set_num_threads(1)

JAX_BASE_RTOL, JAX_T_RTOL = 1e-2, 2e-2
SELF_RTOL = 1e-5  # x P


def _inputs(n_params=3, n_events=300, n_chains=5, n_bins=13, per_chain=False, seed=0,
            zeros=False, low_memory=False, modes=False):
    """numpy inputs: smooth random responses (test_pallas_grad._setup), base
    weights, cotangents and bins with some out of range. zeros: param 1's
    coefficients vanish on a third of the events and param 2's on an
    overlapping third (nz = 0, 1 and 2). modes: each param on a quarter of
    the events only (a plan then skips it elsewhere)."""
    rng = np.random.default_rng(seed)
    specs = []
    for p in range(n_params):
        ev = np.flatnonzero(rng.integers(0, 4, n_events) == p % 4) if modes else np.arange(n_events)
        y = 1.0 + 0.1 * rng.normal(size=(len(ev), 5)).cumsum(axis=1)
        specs.append(dict(name=f"p{p}", param_index=p, x_knots=np.array([-2.0, -1, 0, 1, 2]),
                          event_ids=ev, y_knots=y))
    params = 0.8 * rng.normal(size=(n_chains, n_params))
    params[-1, 0] = 2.6  # extrapolation past the last knot
    shape = (n_chains, n_events) if per_chain else (n_events,)
    bins = rng.integers(0, n_bins, shape).astype(np.int32)
    flat = bins.reshape(-1)
    flat[rng.choice(flat.size, flat.size // 20, replace=False)] = n_bins  # garbage
    flat[rng.choice(flat.size, min(3, flat.size), replace=False)] = -1
    return types.SimpleNamespace(
        specs=specs, params=params, bins=bins, n_bins=n_bins, n_events=n_events,
        base=rng.uniform(0.5, 2.0, size=(n_chains, n_events)).astype(np.float32),
        gmc=rng.normal(size=(n_chains, n_bins)).astype(np.float32),
        gw2=rng.normal(size=(n_chains, n_bins)).astype(np.float32),
        zero_1=np.arange(n_events) % 3 == 0 if zeros else None,
        zero_2=np.arange(n_events) % 3 != 1 if zeros else None,
        low_memory=low_memory,
    )


def _port(d, device="cpu"):
    table = build_dense_table([SplineParamSpec(**s) for s in d.specs], d.n_events,
                              low_memory=d.low_memory)
    coeffs = table.coeffs.clone()
    if d.zero_1 is not None:
        coeffs[1][:, torch.from_numpy(d.zero_1)] = 0.0
        coeffs[2][:, torch.from_numpy(d.zero_2)] = 0.0
    table = DenseSplineTable(coeffs, table.knots_x, table.n_knots, table.param_index).to(device)
    seg, t = find_segments(table.knots_x, table.n_knots,
                           torch.as_tensor(d.params, device=device)[:, table.param_index])
    return types.SimpleNamespace(
        table=table, seg=seg, t=t, coeffs=table.coeffs,
        base=torch.as_tensor(d.base, device=device), bins=torch.as_tensor(d.bins, device=device),
        gmc=torch.as_tensor(d.gmc, device=device), gw2=torch.as_tensor(d.gw2, device=device))


def _plain_loss_grads(x, d):
    """(ḡ_t, ḡ_base, Σ_e |term| [C, P]) by autograd of the port's f32 plain
    route: <ḡ_mc, Σw> + <ḡ_w2, Σw²> through spline_product + histogram."""
    t = x.t.clone().requires_grad_(True)
    base = x.base.clone().requires_grad_(True)
    w = spline_product(x.coeffs, x.seg, t, base)
    bins = x.bins.long().expand(w.shape)
    bins = torch.where((bins >= 0) & (bins < d.n_bins), bins, d.n_bins)
    mc, w2 = histogram(w, bins, d.n_bins)
    g_t, g_base = torch.autograd.grad((x.gmc * mc).sum() + (x.gw2 * w2).sum(), (t, base))
    return g_t, g_base, _abs_terms(x, d)


def _abs_terms(x, d):
    """Σ_e |sev · excl_p · slope_p| per (chain, param) in f64: the scale of
    the reduction's rounding (it cancels), the tolerance unit of ḡ_t."""
    c, e = x.base.shape
    f64 = torch.float64
    resp, slope = [], []
    for p in range(x.coeffs.shape[0]):
        co = coefficient_rows(x.coeffs, x.seg, p, f64)
        tt = x.t[:, p, None].double()
        resp.append(co[:, 0] + tt * (co[:, 1] + tt * (co[:, 2] + tt * co[:, 3])))
        slope.append(co[:, 1] + tt * (2 * co[:, 2] + 3 * tt * co[:, 3]))
    resp, slope = torch.stack(resp, 1), torch.stack(slope, 1)  # [C, P, E]
    b = x.bins.long().expand(c, e)
    ok = (b >= 0) & (b < d.n_bins)
    idx = torch.where(ok, b, 0)
    w = x.base.double() * resp.prod(1)
    g = torch.where(ok, x.gmc.double().gather(1, idx) + 2 * w * x.gw2.double().gather(1, idx), 0.0)
    excl = torch.stack([torch.cat([resp[:, :p], resp[:, p + 1:]], 1).prod(1)
                        for p in range(resp.shape[1])], 1)
    return (g[:, None] * x.base.double()[:, None] * excl * slope).abs().sum(-1)


def _close_t(got, want, scale, rtol):
    got, want, scale = (np.asarray(v, np.float64) for v in (got, want, scale))
    err = np.abs(got - want)
    bound = rtol * scale + 1e-12
    assert (err <= bound).all(), f"max err/bound {np.max(err / bound):.3f}"
    return float(np.max(err / np.maximum(scale, 1e-30)))


def _close_base(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


# ------------------------------------------------------- against JAX


@pytest.fixture()
def jx(monkeypatch):
    """JAX package pieces, with pallas_call forced into interpret mode
    (as tests/test_pallas_grad.py does)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from mach3_tpu.splines import monolith
    from mach3_tpu.splines import pallas_grad as pg
    from mach3_tpu.splines import pallas_reweight as pr

    orig = pl.pallas_call

    def interpret(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpret)
    cached = (pr.fused_reweight_histogram, pr.fused_reweight_histogram_shared,
              pr.fused_reweight_histogram_shifted)
    for fn in cached:
        fn.clear_cache()
    yield types.SimpleNamespace(jax=jax, jnp=jnp, pg=pg, pr=pr, monolith=monolith)
    for fn in cached:
        fn.clear_cache()


def _jax_backward(jx, d, x, param_tile=None):
    """JAX's (ḡ_t contracted from ḡ_selector, ḡ_base) on the same inputs."""
    jnp = jx.jnp
    table = jx.monolith.build_dense_table(
        [jx.monolith.SplineParamSpec(**s) for s in d.specs], d.n_events, low_memory=d.low_memory)
    coeffs = jnp.asarray(x.coeffs.float().numpy()).astype(table.coeffs.dtype)
    selector = jx.pr.spline_selector(table, jnp.asarray(d.params))
    shared = d.bins.ndim == 1
    # JAX drops a bin only at n_bins: the garbage bin of a -1 is the same drop
    bins = np.where(d.bins < 0, d.n_bins, d.bins).astype(np.int32)
    gsel, gbase = jx.pg._grad_backward(
        (d.n_bins, 4, 128, param_tile, shared),
        (selector, coeffs, jnp.asarray(d.base), jnp.asarray(bins)),
        (jnp.asarray(d.gmc), jnp.asarray(d.gw2)))
    gsel = np.asarray(gsel, np.float64)
    c, p, k4 = gsel.shape
    seg, t = x.seg.numpy(), x.t.double().numpy()
    g4 = np.take_along_axis(gsel.reshape(c, p, k4 // 4, 4), seg[:, :, None, None], 2)[:, :, 0]
    return g4[..., 1] + 2 * t * g4[..., 2] + 3 * t * t * g4[..., 3], np.asarray(gbase)


JAX_CASES = {
    "shared_p3": dict(),
    "perchain_p3": dict(per_chain=True),
    "shared_p20_blocked": dict(n_params=20, seed=3),
    "perchain_p20_blocked": dict(n_params=20, per_chain=True, seed=4),
    "zero_responses": dict(zeros=True, seed=7),
}


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_passes_match_jax_and_own_autograd(jx, case):
    d = _inputs(**JAX_CASES[case])
    x = _port(d)
    g_t, gbase = grad.reweight_backward(x.seg, x.t, x.coeffs, x.base, x.bins, x.gmc, x.gw2,
                                        n_bins=d.n_bins)
    nz = grad.grad_pass_a_ref(x.seg, x.t, x.coeffs, x.base, x.bins, x.gmc, x.gw2,
                              n_bins=d.n_bins)[3]
    assert nz.dtype == torch.int32 and gbase.dtype == torch.float32
    p = x.coeffs.shape[0]
    own_t, own_base, scale = _plain_loss_grads(x, d)
    _close_t(g_t.numpy(), own_t.numpy(), scale.numpy(), SELF_RTOL * p)
    _close_base(gbase.numpy(), own_base.numpy(), SELF_RTOL * p)
    jax_t, jax_base = _jax_backward(jx, d, x, param_tile=8 if p > 16 else None)
    _close_t(g_t.numpy(), jax_t, scale.numpy(), JAX_T_RTOL)
    _close_base(gbase.numpy(), jax_base, JAX_BASE_RTOL)
    if case == "zero_responses":
        counts = nz.numpy()
        assert {0, 1, 2} <= set(np.unique(counts).tolist())
        assert (gbase.numpy()[counts > 0] == 0).all()
        assert np.isfinite(g_t.numpy()).all()


def test_zero_response_exclusion():
    """One parameter's response is 0 on every event, with a nonzero slope
    (``test_pallas_grad.test_zero_response_exclusion`` zeroes all its
    coefficients, which in the port's t-parameterisation also zeroes the
    slope): it sits on its first knot (t = 0) whose value row is 0. The
    other params' ḡ_t vanish, the zero param keeps the product of the
    others."""
    d = _inputs(seed=7)
    d.params[:, 1] = -2.0  # the first knot: segment 0, t = 0
    x = _port(d)
    assert (x.seg[:, 1] == 0).all() and (x.t[:, 1] == 0).all()
    coeffs = x.coeffs.clone()
    coeffs[1][0] = 0.0  # the value row of segment 0
    g_t, g_base = grad.reweight_backward(x.seg, x.t, coeffs, x.base, x.bins, x.gmc, x.gw2,
                                         n_bins=d.n_bins)
    assert (g_base == 0).all() and torch.isfinite(g_t).all()
    assert (g_t[:, [0, 2]] == 0).all() and (g_t[:, 1] != 0).all()
    own_t, _, scale = _plain_loss_grads(types.SimpleNamespace(**{**vars(x), "coeffs": coeffs}), d)
    _close_t(g_t.numpy(), own_t.numpy(), scale.numpy() + 1e-30, SELF_RTOL * 3)


class _PlainF64(torch.autograd.Function):
    """f64 forward of the plain route with the plain backward passes, for
    ``gradcheck``."""

    @staticmethod
    def forward(ctx, t, base, seg, coeffs, bins, gmc, gw2, n_bins):
        w = base
        for p in range(coeffs.shape[0]):
            co = coefficient_rows(coeffs, seg, p, torch.float64)
            tt = t[:, p, None]
            w = w * (co[:, 0] + tt * (co[:, 1] + tt * (co[:, 2] + tt * co[:, 3])))
        b = bins.long().expand(w.shape)
        b = torch.where((b >= 0) & (b < n_bins), b, n_bins)
        mc = torch.zeros(w.shape[0], n_bins + 1, dtype=w.dtype).scatter_add_(1, b, w)
        w2 = torch.zeros(w.shape[0], n_bins + 1, dtype=w.dtype).scatter_add_(1, b, w * w)
        ctx.save_for_backward(t, base, seg, coeffs, bins)
        ctx.n_bins = n_bins
        return mc[:, :n_bins], w2[:, :n_bins]

    @staticmethod
    def backward(ctx, gmc, gw2):
        t, base, seg, coeffs, bins = ctx.saved_tensors
        gb, sev, pnz, nz = grad.grad_pass_a_ref(seg, t, coeffs, base, bins, gmc, gw2,
                                                n_bins=ctx.n_bins)
        return grad.grad_pass_b_ref(seg, t, coeffs, sev, pnz, nz), gb, *([None] * 6)


@pytest.mark.parametrize("per_chain", [False, True], ids=["shared", "per_chain"])
def test_plain_passes_gradcheck_f64(per_chain):
    d = _inputs(n_params=4, n_events=40, n_chains=3, n_bins=6, per_chain=per_chain, seed=9,
                zeros=True)
    x = _port(d)
    t = x.t.double().requires_grad_(True)
    base = x.base.double().requires_grad_(True)
    coeffs = x.coeffs.double()
    assert torch.autograd.gradcheck(
        lambda tt, bb: _PlainF64.apply(tt, bb, x.seg, coeffs, x.bins, None, None, d.n_bins),
        (t, base), eps=1e-6, atol=1e-8, rtol=1e-6)


# ----------------------------------------------------- autograd Functions


def _shared_case(d):
    """Port args of a shared-route sample laid out by ``plan.shared_layout``."""
    table = build_dense_table([SplineParamSpec(**s) for s in d.specs], d.n_events)
    lay = plan.shared_layout(dense_table_activity(table), d.bins, d.n_bins)
    tp, te = torch.from_numpy(lay.param_perm), torch.from_numpy(lay.event_perm)
    table = DenseSplineTable(table.coeffs.index_select(0, tp).index_select(2, te),
                             table.knots_x[tp], table.n_knots[tp], table.param_index[tp])
    base = d.base[:, lay.event_perm].copy()
    base[:, lay.pad_mask] = 0.0
    seg, t = find_segments(table.knots_x, table.n_knots,
                           torch.from_numpy(d.params)[:, table.param_index])
    kw = dict(n_bins=d.n_bins, tile_start=torch.from_numpy(lay.tile_start),
              tile_width=torch.from_numpy(lay.tile_width),
              plan_ptr=torch.from_numpy(lay.plan_ptr), plan_idx=torch.from_numpy(lay.plan_idx),
              nbl=lay.nbl)
    x = types.SimpleNamespace(seg=seg, t=t, coeffs=table.coeffs, base=torch.from_numpy(base),
                              bins=torch.from_numpy(np.ascontiguousarray(d.bins[lay.event_perm])),
                              gmc=torch.from_numpy(d.gmc), gw2=torch.from_numpy(d.gw2))
    return x, kw, lay


@pytest.mark.parametrize("route", ["shared", "shifted"])
def test_autograd_functions_match_plain_route(route):
    before = dict(reweight.LAUNCHES)
    if route == "shared":
        d = _inputs(n_params=8, n_events=900, n_bins=40, seed=5, modes=True)
        d.bins = np.clip(d.bins, 0, d.n_bins)
        x, kw, lay = _shared_case(d)
        assert lay.mean_active() < 8  # the plan skips parameters
    else:
        d = _inputs(n_params=5, n_events=500, n_bins=12, seed=6)
        x = _port(d)
        rng = np.random.default_rng(16)
        edges = torch.linspace(0.0, 3.0, d.n_bins + 1)
        x_nom = torch.from_numpy(rng.uniform(-0.2, 3.2, d.n_events).astype(np.float32))
        shift = torch.from_numpy(rng.uniform(-0.1, 0.1, 5).astype(np.float32))
        static = torch.zeros(d.n_events, dtype=torch.int32)
        kin = (x_nom[None] * (1.0 + shift[:, None]))[:, None, :]  # [C, V=1, E]
        x.bins = SampleBinning.build([edges.numpy()], [0]).find_bins(kin).int()
        assert (x.bins == d.n_bins).any() and x.bins.shape == (5, d.n_events)
    t = x.t.clone().requires_grad_(True)
    base = x.base.clone().requires_grad_(True)
    if route == "shared":
        mc, w2 = grad.fused_reweight_diff(t, base, x.seg, x.coeffs, x.bins, **kw)
    else:
        mc, w2 = grad.fused_reweight_diff_shifted(
            t, base, x.seg, x.coeffs, shift, x_nom, static, edges, n_bins=d.n_bins,
            shift_kind="scale", stride_j=1, n_axis_j=d.n_bins)
    w = spline_product(x.coeffs, x.seg, x.t, x.base)
    mc_p, w2_p = histogram(w, x.bins.long().expand(w.shape), d.n_bins)
    _close_base(mc.detach().numpy(), mc_p.numpy(), 2e-5)
    _close_base(w2.detach().numpy(), w2_p.numpy(), 2e-5)
    loss = (x.gmc * mc).sum() + (x.gw2 * w2).sum()
    g_t, g_base = torch.autograd.grad(loss, (t, base))
    own_t, own_base, scale = _plain_loss_grads(x, d)
    p = x.coeffs.shape[0]
    _close_t(g_t.numpy(), own_t.numpy(), scale.numpy(), SELF_RTOL * p)
    _close_base(g_base.numpy(), own_base.numpy(), SELF_RTOL * p)
    assert reweight.LAUNCHES == before  # the plain versions are not launches


def test_backward_is_first_order_only():
    d = _inputs(n_params=3, n_events=200, per_chain=True, seed=2)
    x = _port(d)
    t = x.t.clone().requires_grad_(True)
    edges = torch.arange(d.n_bins + 1, dtype=torch.float32)
    mc, w2 = grad.fused_reweight_diff_shifted(
        t, x.base, x.seg, x.coeffs, torch.zeros(5), torch.zeros(d.n_events),
        torch.zeros(d.n_events, dtype=torch.int32), edges, n_bins=d.n_bins,
        shift_kind="scale", stride_j=1, n_axis_j=d.n_bins)
    (g,) = torch.autograd.grad((x.gmc * mc).sum(), t, create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(g.sum(), t)


def test_wrappers_reject_what_the_kernels_do_not_take():
    d = _inputs(seed=1)
    x = _port(d)
    a = (x.seg, x.t, x.coeffs, x.base, x.bins, x.gmc, x.gw2)
    call = grad.reweight_backward
    with pytest.raises(TypeError):
        call(*a[:4], x.bins.long(), *a[5:], n_bins=d.n_bins)
    with pytest.raises(ValueError):
        call(*a[:5], x.gmc[:, :-1], x.gw2, n_bins=d.n_bins)
    with pytest.raises(ValueError):
        call(*a, n_bins=d.n_bins, plan_ptr=torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        call(x.seg.long(), *a[1:], n_bins=d.n_bins)
    with pytest.raises(ValueError):
        call(*a[:3], x.base[:, :-1].contiguous(), *a[4:], n_bins=d.n_bins)
    with pytest.raises(ValueError):
        call(*a, n_bins=0)


# ------------------------------------------------- sample and model level

TOY = dict(n_events=1500, seed=11, e_grid_size=30, flip_hierarchy=True)
SIZE = dict(n_numu=4000, n_nue=1500, n_atmo=3000, e_grid_size=40, atmo_e_grid_size=20,
            atmo_cosz_grid_size=8, low_memory=True, seed=7)
NLL_PROD_ATOL, NLL_PROD_RTOL = 5e-3, 1e-3
# Gradients, as a fraction of each chain's largest component. Against JAX
# production: its bf16 response deviations move Σw by ~4e-4 relative, and
# near the Asimov minimum mc − data, which the statistic's slope follows, is
# of that order (measured 0.081 on the toy's numu sample).
GRAD_PROD = 0.15
# Against jax.grad of the f32 oracle (exact spline eval): f32 sums in
# another order.
GRAD_ORACLE = 2e-3
# The port's fused route (kernels' plain versions + hand-written backward)
# against autograd of its plain route: the same f32 terms multiplied in
# another order. The Δm² components are sums over events that cancel to
# ~1e-3 of their terms, so a 1-ulp difference per event shows at up to
# 7.6e-5 of the largest component (measured on the toy's numu sample).
GRAD_SELF = 3e-4


def _chains(flat, n_chains, seed, frac=0.05):
    chol = np.asarray(flat.chol)
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = np.asarray(flat.low_bound), np.asarray(flat.up_bound)
    th = np.asarray(flat.prefit) + frac * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    return np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))


def _close_grad(got, want, frac):
    """Per chain: |got − want| ≤ frac · max_k |want_k|; returns the largest
    such fraction."""
    got, want = np.asarray(got), np.asarray(want)
    gap = np.abs(got - want) / np.abs(want).max(-1, keepdims=True)
    assert gap.max() <= frac, f"gradient gap {gap.max():.3e} > {frac}"
    return float(gap.max())


def _jax_reference(jm, th, route):
    """JAX's per-sample NLLs on ``route`` ("diff": fused kernels + analytic
    backward; "xla": plain XLA), the f32-oracle NLLs and log_posterior_batch:
    values [2S + 1, C] and per-chain gradients [2S + 1, C, NP]."""
    import jax
    import jax.numpy as jnp

    from mach3_tpu.samples.binning import histogram as jhistogram
    from mach3_tpu.splines.eval import eval_dense as jeval_dense

    def oracle(js, thetas, grids):
        def one(theta, g):
            w = (js.mc_weight * js._norm_weights(theta)
                 * jeval_dense(js.spline_table, theta, exact=True) * js._osc_weights(theta, g))
            if js.static_bins is not None:
                bins = js.static_bins
            else:
                row = js.shifts[0].var_row
                v = theta[js.shifts[0].param_index].astype(jnp.float32)
                bins = js.binning.find_bins(js.kin.at[row].set(js.kin[row] * (1.0 + v)))
            return js._stat_sum(*jhistogram(w, bins, js.n_bins))

        return jax.vmap(one)(thetas, grids)

    def outs(t):
        tables = jm._shared_osc_tables(t)
        nll = getattr(jm.samples[0], f"log_likelihood_batch_{route}")
        per = [getattr(s, nll.__name__)(t, tables[i]) for i, s in enumerate(jm.samples)]
        orc = [oracle(s, t, tables[i]) for i, s in enumerate(jm.samples)]
        out = jnp.stack(per + orc + [jm.log_posterior_batch(t)])
        return out.sum(1), out

    jac, vals = jax.jit(jax.jacrev(outs, has_aux=True))(jnp.asarray(th))
    return np.asarray(vals), np.asarray(jac)


def _port_reference(tm, th):
    """The port's per-sample diff NLLs, plain NLLs and log_posterior_batch:
    values [2S + 1, C] and per-chain gradients [2S + 1, C, NP]."""
    t = torch.tensor(th, requires_grad=True)
    tables = tm._shared_osc_tables(t)
    outs = ([s.log_likelihood_batch_diff(t, tables[i]) for i, s in enumerate(tm.samples)]
            + [s.log_likelihood_batch_plain(t, tables[i]) for i, s in enumerate(tm.samples)]
            + [tm.log_posterior_batch(t)])
    grads = [torch.autograd.grad(o.sum(), t, retain_graph=True)[0] for o in outs]
    return torch.stack(outs).detach().numpy(), torch.stack(grads).numpy()


def _check_level(tm, jm, th, route, gaps):
    jv, jg = _jax_reference(jm, th, route)
    tv, tg = _port_reference(tm, th)
    n = len(tm.samples)
    for i, s in enumerate(tm.samples):
        np.testing.assert_allclose(tv[i], jv[i], rtol=NLL_PROD_RTOL, atol=NLL_PROD_ATOL,
                                   err_msg=s.name)
        gaps[s.name] = (_close_grad(tg[i], jg[i], GRAD_PROD),
                        _close_grad(tg[i], jg[n + i], GRAD_ORACLE))
        np.testing.assert_allclose(tv[i], tv[n + i], rtol=1e-6, atol=1e-5, err_msg=s.name)
        _close_grad(tg[i], tg[n + i], GRAD_SELF)  # the fused route vs the plain route
    np.testing.assert_allclose(tv[-1], jv[-1], rtol=NLL_PROD_RTOL, atol=n * NLL_PROD_ATOL)
    gaps["model"] = _close_grad(tg[-1], jg[-1], GRAD_PROD)
    assert np.isfinite(tg).all()
    return tg


def test_toy_gradients_match_jax(jx):
    """The toy, JAX's fused diff path (K1 + K6a/K6b in interpret mode) vs the
    port's, per sample and for log_posterior_batch, oscillation free."""
    from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
    from mach3_tpu_torch.bridge import from_jax_model

    jm = jbuild_toy(**TOY, use_pallas=True).model
    tm = from_jax_model(jm)
    assert [s._diff_route()[0] for s in jm.samples] == ["shifted", "shifted"]
    assert [s._diff_route() for s in tm.samples] == ["shifted", "shifted"]
    th = _chains(jm._flat(), 4, seed=3)
    gaps = {}
    tg = _check_level(tm, jm, th, "diff", gaps)
    print("toy gradient gaps (prod, oracle):", gaps)
    assert (np.abs(tg[-1][:, 10:]) > 0).all()  # oscillation gradients flow
    single = tm.log_posterior(torch.from_numpy(th[1]))
    assert float(single) == pytest.approx(float(tm.log_posterior_batch(torch.from_numpy(th))[1]),
                                          rel=1e-12)


def test_large_gradients_match_jax(monkeypatch):
    """``build_large`` at the test size: the port's kernel routes (shared,
    shifted, shared) vs ``jax.grad`` of JAX's XLA route with its spline eval
    switched to the f32 oracle (``exact=True``), both fed JAX's oscillation
    grids as constants: ``jax.grad`` through the layered-PREM grids takes
    minutes on the CPU, and the oscillation tests below hold those
    gradients. The port's log_posterior_batch (oscillation free) is held to
    its own plain route."""
    import jax
    import jax.numpy as jnp

    from mach3_tpu.fitters.model import FitModel as JFitModel
    from mach3_tpu.samples import sample as jsample
    from mach3_tpu.splines.eval import eval_dense as jeval_dense
    from mach3_tpu.tutorial.large import build_large as jbuild_large
    from mach3_tpu_torch.tutorial.large import build_large

    monkeypatch.setattr(jsample, "eval_dense",
                        lambda table, params: jeval_dense(table, params, exact=True))
    tm = build_large(**SIZE, device="cpu").model
    j = jbuild_large(**SIZE, use_pallas=False, asimov=False)
    jm = JFitModel.build([j.xsec, j.osc], [s.with_data(t.data.numpy())
                                           for s, t in zip(j.samples, tm.samples)])
    assert [s._diff_route() for s in tm.samples] == ["shared", "shifted", "shared"]
    th = _chains(jm._flat(), 3, seed=5)
    grids = jax.jit(lambda t: jm._shared_osc_tables(t))(jnp.asarray(th))

    def nlls(t):
        return jnp.stack([s.log_likelihood_batch_xla(t, grids[i])
                          for i, s in enumerate(jm.samples)])

    jac, jv = jax.jit(jax.jacrev(lambda t: (nlls(t).sum(1), nlls(t)), has_aux=True))(
        jnp.asarray(th))
    t = torch.tensor(th, requires_grad=True)
    gaps = {}
    for i, s in enumerate(tm.samples):
        g = tuple(torch.from_numpy(np.array(a)) for a in grids[i])
        diff, plain = s.log_likelihood_batch_diff(t, g), s.log_likelihood_batch_plain(t, g)
        g_diff, g_plain = (torch.autograd.grad(v.sum(), t)[0].numpy() for v in (diff, plain))
        np.testing.assert_allclose(diff.detach().numpy(), np.asarray(jv[i]), rtol=1e-5,
                                   atol=1e-4, err_msg=s.name)
        np.testing.assert_allclose(diff.detach().numpy(), plain.detach().numpy(), rtol=1e-6,
                                   atol=1e-5, err_msg=s.name)
        gaps[s.name] = _close_grad(g_diff, np.asarray(jac[i]), GRAD_ORACLE)
        _close_grad(g_diff, g_plain, GRAD_SELF)
    t = torch.tensor(th, requires_grad=True)
    g_diff, g_plain = (torch.autograd.grad(tm.log_posterior_batch(t, plain=plain).sum(), t)[0]
                       for plain in (False, True))
    gaps["model vs plain route"] = _close_grad(g_diff.numpy(), g_plain.numpy(), GRAD_SELF)
    assert torch.isfinite(g_diff).all() and (g_diff[:, -6:] != 0).any()
    print("large gradient gaps (oracle):", gaps)


# ---------------------------------------------------- oscillation alone

OSC = np.array([
    [0.307, 0.022, 0.561, -1.601, 7.42e-5, 2.51e-3],
    [0.290, 0.025, 0.450, 0.700, 7.60e-5, -2.45e-3],
    [0.320, 0.020, 0.600, 3.000, 7.30e-5, 2.60e-3],
])
OSC_RTOL = 1e-6


def _osc_grad(fn, weights):
    x = torch.tensor(OSC, requires_grad=True)
    (g,) = torch.autograd.grad((fn(x) * torch.from_numpy(weights)).sum(), x)
    return g.numpy()


@pytest.mark.parametrize("anti", [False, True], ids=["nu", "nubar"])
def test_beam_osc_gradient_matches_jax(anti):
    import jax
    import jax.numpy as jnp

    from mach3_tpu.osc import prob as jprob
    from mach3_tpu_torch.osc import prob

    energy = np.linspace(0.05, 3.0, 30)
    w = np.random.default_rng(1).normal(size=(3, 30, 3, 3))
    kw = dict(length=295.0, rho=2.6, antineutrino=anti)

    def jf(x):
        p = jax.vmap(lambda r: jprob.probabilities_const_density(
            jprob.OscParams.from_array(r), jnp.asarray(energy), dtype=jnp.float64, **kw))(x)
        return jnp.sum(p * w)

    want = np.asarray(jax.grad(jf)(jnp.asarray(OSC)))
    got = _osc_grad(lambda x: prob.probabilities_const_density(
        prob.OscParams.from_array(x), torch.from_numpy(energy), dtype=torch.float64, **kw), w)
    np.testing.assert_allclose(got, want, rtol=OSC_RTOL, atol=OSC_RTOL * np.abs(want).max())


def test_layered_osc_gradient_matches_jax():
    import jax
    import jax.numpy as jnp

    from mach3_tpu.osc import prob as jprob
    from mach3_tpu_torch.osc import prem, prob

    cosz = np.linspace(-0.99, 0.99, 6)
    energy = np.geomspace(0.5, 50.0, 8)
    lengths, rho, ye = prem.path_through_earth(cosz)
    rho_eff = rho * ye / 0.5
    w = np.random.default_rng(2).normal(size=(3, 6, 8, 3, 3))

    def jf(x):
        p = jax.vmap(lambda r: jprob.probabilities_layered(
            jprob.OscParams.from_array(r), jnp.asarray(energy), jnp.asarray(lengths),
            jnp.asarray(rho_eff), dtype=jnp.float64))(x)
        return jnp.sum(p * w)

    want = np.asarray(jax.grad(jf)(jnp.asarray(OSC)))
    got = _osc_grad(lambda x: prob.probabilities_layered(
        prob.OscParams.from_array(x), torch.from_numpy(energy), torch.from_numpy(lengths),
        torch.from_numpy(rho_eff), dtype=torch.float64), w)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=OSC_RTOL, atol=OSC_RTOL * np.abs(want).max())


# ------------------------------------------------------ test statistics


def _stat_bins():
    rng = np.random.default_rng(8)
    data = rng.poisson(rng.uniform(0.5, 100.0, size=40)).astype(np.float64)
    mc = data * rng.uniform(0.7, 1.3, size=40) + rng.uniform(0.1, 1, size=40)
    w2 = mc * rng.uniform(0.01, 2.0, size=40)
    low = 1e-5
    edge = np.array([  # data == 0, mc around LOW_MC_BOUND, w2 == 0
        [0.0, 3.0, 1.0], [0.0, 2.0, 0.0], [5.0, 1e-7, 1e-9], [5e-6, 1e-7, 1e-9],
        [1e-7, 5e-6, 1e-9], [4.0, 4.0, 0.0], [3.0, 1e-6, 0.0], [2.0, 2.0, 4.0],
        [0.0, 5e-6, 1e-10], [7.0, 2 * low, 1e-10], [1.0, 0.5, 0.0],
    ])
    return (np.concatenate([data, edge[:, 0]]), np.concatenate([mc, edge[:, 1]]),
            np.concatenate([w2, edge[:, 2]]))


@pytest.mark.parametrize("stat", ["Poisson", "BarlowBeeston", "DembinskiAbdelmotteleb",
                                  "IceCube", "Pearson", "Gaussian"])
def test_statistic_gradients_match_jax(stat):
    import jax
    import jax.numpy as jnp

    from mach3_tpu.samples import teststats as jts
    from mach3_tpu_torch.samples import teststats as tts

    data, mc, w2 = _stat_bins()
    jfn = jts.get_test_stat_fn(stat)
    want_mc, want_w2 = jax.grad(lambda m, q: jnp.sum(jfn(jnp.asarray(data), m, q)),
                                argnums=(0, 1))(jnp.asarray(mc), jnp.asarray(w2))
    m = torch.tensor(mc, requires_grad=True)
    q = torch.tensor(w2, requires_grad=True)
    g = torch.autograd.grad(tts.get_test_stat_fn(stat)(torch.from_numpy(data), m, q).sum(),
                            (m, q), allow_unused=True)
    got_mc, got_w2 = (np.zeros_like(mc) if v is None else v.numpy() for v in g)
    assert np.isfinite(got_mc).all() and np.isfinite(got_w2).all()
    for got, want in ((got_mc, want_mc), (got_w2, want_w2)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-9,
                                   atol=1e-12 * max(1.0, np.abs(want).max()))


# ------------------------------------------------------------- the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


def _to(x, dev):
    return types.SimpleNamespace(**{k: v.to(dev) if torch.is_tensor(v) else v
                                    for k, v in vars(x).items()})


def _cuda_case(case):
    """(inputs, port tensors on the CPU, plan kwargs or None) of one edge case."""
    if case == "empty_plan_tile":
        d = _inputs(n_params=6, n_events=1500, n_chains=7, n_bins=50, seed=10, modes=True)
        d.bins = np.clip(d.bins, 0, d.n_bins)
        d.specs = [s for s in d.specs if s["param_index"] % 4 != 0]  # mode 0: no spline
        for i, s in enumerate(d.specs):
            s["param_index"] = i
        d.params = d.params[:, :len(d.specs)]
        x, kw, _ = _shared_case(d)
        return d, x, kw
    if case == "shared_plan":
        d = _inputs(n_params=20, n_events=3000, n_chains=21, n_bins=300, seed=11, modes=True)
        d.bins = np.clip(d.bins, 0, d.n_bins)
        x, kw, _ = _shared_case(d)
        return d, x, kw
    if case == "bf16_per_chain":
        d = _inputs(n_params=12, n_events=2000, n_chains=19, n_bins=30, per_chain=True,
                    low_memory=True, seed=12)
    elif case == "p256":
        d = _inputs(n_params=256, n_events=300, n_chains=3, n_bins=8, seed=13)
        d.params *= 0.05  # keep the product of 256 responses near 1
    elif case == "one_event":
        d = _inputs(n_params=4, n_events=1, n_chains=3, n_bins=2, seed=14)
        d.bins[:] = 1
    elif case == "zero_response":
        d = _inputs(n_params=5, n_events=2000, n_chains=9, n_bins=20, per_chain=True,
                    zeros=True, seed=15)
    return d, _port(d), None


CUDA_CASES = ["empty_plan_tile", "shared_plan", "bf16_per_chain", "p256", "one_event",
              "zero_response"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernels_match_plain_versions(cuda_device, case):
    d, x, kw = _cuda_case(case)
    plan_kw = {} if kw is None else dict(plan_ptr=kw["plan_ptr"], plan_idx=kw["plan_idx"])
    if case == "empty_plan_tile":
        assert (np.diff(kw["plan_ptr"].numpy()) == 0).any()
    xc = _to(x, cuda_device)
    plan_c = {k: v.to(cuda_device) for k, v in plan_kw.items()}
    a = (xc.seg, xc.t, xc.coeffs, xc.base, xc.bins, xc.gmc, xc.gw2)
    before = reweight.LAUNCHES["reweight_backward"]
    got_t, got_base = grad.reweight_backward(*a, n_bins=d.n_bins, **plan_c)
    torch.cuda.synchronize()
    assert reweight.LAUNCHES["reweight_backward"] == before + 1
    ref_a = grad.grad_pass_a_ref(*a, n_bins=d.n_bins, **plan_c)
    ref_t = grad.grad_pass_b_ref(xc.seg, xc.t, xc.coeffs, *ref_a[1:])
    p = x.coeffs.shape[0]
    _close_base(got_base.cpu().numpy(), ref_a[0].cpu().numpy(), SELF_RTOL * p)
    _close_t(got_t.cpu().numpy(), ref_t.cpu().numpy(), _abs_terms(x, d).numpy(), SELF_RTOL * p)
    assert torch.isfinite(got_t).all() and got_t.abs().sum() > 0
