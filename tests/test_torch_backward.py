"""The fused backward of the reweight histogram (``splines/grad.py``
``reweight_backward``, ``csrc/reweight_backward.cu``: K6a and K6b in one
kernel) on the shifted route, vs the JAX package and its own plain passes.

* ``reweight.shifted_bins_ref``, the shifted route's plain binning (what the
  backward kernel and the forward kernel form in-kernel), equals
  ``SampleModel._perchain_bins`` (the plain binning of the shifted
  kinematics) on every event of the toy's two samples and of a small
  ``build_large`` nue_beam, with events moved onto the edges and a chain at
  shift value 0: exactly.
* The shifted differentiable route (``fused_reweight_diff_shifted``) under
  its activity plan, with the shift arguments in place of precomputed bins,
  on a laid-out sample whose plan lists fewer than P parameters on some
  tiles, against JAX's ``_grad_backward`` in Pallas interpret mode (per-chain
  bins from the same binning): ḡ_t within 2e-2 of Σ_e |term|, ḡ_base within
  1e-2 relative (JAX rounds its responses' deviations and its pass-B dot to
  bf16; ``test_torch_grad.py``'s budgets), and against autograd of the
  port's own f32 plain route within 1e-5·P.
* The wrapper's checks: any row pitch is taken (no 16-byte alignment), P >
  256, K4 % 4 ≠ 0, more than 64 knots, a block's shared memory past 227 KB
  and an unknown shift kind are refused; ``need_t=False`` returns no ḡ_t and
  the same ḡ_base.

The ``cuda``-marked cases hold the kernel to its plain passes on the card:
the shifted route under its plan, a trivial plan and none; its in-kernel bins
(events on edges, one cotangent value per bin); ``need_t=False``; a bf16
table whose rows are not 16-byte aligned; ḡ_t bit-identical over launches;
responses below 2^-126 (subnormal) and above 2^126 with a nonzero slope,
where the kernel's fast reciprocal would be wrong.
They import no jax and run with ``--noconftest`` where a card is.
"""
import copy
import types

import numpy as np
import pytest
import torch

from mach3_tpu_torch.samples.binning import histogram
from mach3_tpu_torch.splines import grad, plan, reweight
from mach3_tpu_torch.splines.eval import find_segments, spline_product
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
JAX_BASE_RTOL, JAX_T_RTOL = 1e-2, 2e-2  # test_torch_grad.py
SELF_RTOL = 1e-5  # x P
SIGMA = np.array([-3.0, -1.0, 0.0, 1.0, 3.0])
N_AXIS, N_OTHER = 12, 3


# ------------------------------------------------ the plain shifted binning


@pytest.fixture(scope="module")
def samples():
    from mach3_tpu_torch.tutorial.large import build_large
    from mach3_tpu_torch.tutorial.toy import build_toy

    toy = build_toy(**TOY, device="cpu").model
    large = build_large(**SIZE, device="cpu").model
    return {"toy_numu": (toy, 0), "toy_nue": (toy, 1), "nue_beam": (large, 1)}


@pytest.mark.parametrize("which", ["toy_numu", "toy_nue", "nue_beam"])
def test_shifted_bins_ref_is_the_plain_binning(samples, which):
    model, i = samples[which]
    s = copy.deepcopy(model.samples[i])
    assert s._diff_route() == "shifted"
    row, p_shift = s.shifts[0].var_row, s.shifts[0].param_index
    rng = np.random.default_rng(3)
    on_edge = rng.choice(s.n_events, s.n_events // 5, replace=False)
    s.kin[row, on_edge] = s.shift_edges[rng.integers(0, len(s.shift_edges), len(on_edge))]
    flat = model.flat
    th = flat.prefit.double() + 0.05 * torch.from_numpy(rng.normal(size=(6, flat.prefit.shape[0])))
    th = torch.clamp(th, flat.low_bound, flat.up_bound)
    th[0, p_shift] = 0.0  # an event on an edge sits on it
    args, kw = s.diff_kernel_args(th)
    got = reweight.shifted_bins_ref(*args[4:8], n_bins=s.n_bins, shift_kind=kw["shift_kind"],
                                    stride_j=kw["stride_j"], n_axis_j=kw["n_axis_j"])
    want = s._perchain_bins(th)
    assert got.dtype == torch.int32 and got.shape == want.shape == (6, s.n_events)
    assert torch.equal(got.long(), want)
    edge_bins = want[0, on_edge]
    assert (edge_bins < s.n_bins).any() and (edge_bins == s.n_bins).any()  # last edge: dropped


# ------------------------------------------- a laid-out shifted sample


def _laid_out(n_chains=5, n_events=1200, n_params=12, seed=0, kind="scale", bf16=False):
    """A shifted sample laid out by ``plan.shifted_layout``: each parameter
    acts on the events of one of 4 modes, the chains of parameter 0 sit in
    three segments, a third of the events lie on edges, chain 0 at shift 0."""
    rng = np.random.default_rng(seed)
    modes = rng.integers(0, 4, n_events)
    specs = []
    for p in range(n_params):
        ev = np.flatnonzero(modes == p % 4)
        slope = 0.06 * (1.0 + 0.3 * rng.normal(size=(len(ev), 1)))
        y = np.clip(1.0 + slope * SIGMA + 0.008 * rng.normal(size=(len(ev), 1)) * SIGMA**2, 0, None)
        y[:, 2] = 1.0
        specs.append(dict(name=f"s{p}", param_index=p, x_knots=SIGMA, event_ids=ev, y_knots=y))
    params = rng.normal(scale=0.3, size=(n_chains, n_params))
    params[:, 0] = np.resize([-2.0, 0.5, 2.2], n_chains)
    table = build_dense_table([SplineParamSpec(**s) for s in specs], n_events, low_memory=bf16)
    lay = plan.shifted_layout(dense_table_activity(table))
    perm, pad = lay.event_perm, lay.pad_mask
    tp, te = torch.from_numpy(lay.param_perm), torch.from_numpy(perm)
    table = DenseSplineTable(table.coeffs.index_select(0, tp).index_select(2, te),
                             table.knots_x[tp], table.n_knots[tp], table.param_index[tp])
    seg, t = find_segments(table.knots_x, table.n_knots,
                           torch.from_numpy(params)[:, table.param_index])
    edges = np.linspace(0.0, 3.0, N_AXIS + 1).astype(np.float32)
    x_nom = rng.uniform(-0.2, 3.2, n_events).astype(np.float32)
    x_nom[::3] = edges[rng.integers(0, N_AXIS + 1, len(x_nom[::3]))]
    static = rng.integers(0, N_OTHER, n_events).astype(np.int32) * N_AXIS
    static[rng.choice(n_events, 12, replace=False)] = -1
    shift = rng.normal(scale=0.05, size=n_chains).astype(np.float32)
    shift[0] = 0.0
    base = rng.uniform(0.5, 2.0, size=(n_chains, n_events)).astype(np.float32)[:, perm]
    base[:, pad] = 0.0
    n_bins = N_AXIS * N_OTHER
    bins = grad.ShiftedBins(torch.from_numpy(shift), torch.from_numpy(x_nom[perm]),
                            torch.from_numpy(static[perm]), torch.from_numpy(edges), kind, 1,
                            N_AXIS)
    return types.SimpleNamespace(
        specs=specs, params=params, lay=lay, seg=seg, t=t, coeffs=table.coeffs,
        base=torch.from_numpy(np.ascontiguousarray(base)), bins=bins, n_bins=n_bins,
        plan=dict(plan_ptr=torch.from_numpy(lay.plan_ptr), plan_idx=torch.from_numpy(lay.plan_idx)),
        gmc=torch.from_numpy(rng.normal(size=(n_chains, n_bins)).astype(np.float32)),
        gw2=torch.from_numpy(rng.normal(size=(n_chains, n_bins)).astype(np.float32)))


def _term_scale(x, bins):
    """Σ_e |G·base·excl_p·slope_p| [C, P]: the unit of ḡ_t's tolerance."""
    _, sev, pnz, nz = grad.grad_pass_a_ref(x.seg, x.t, x.coeffs, x.base, bins, x.gmc, x.gw2,
                                           n_bins=x.n_bins)
    return grad.pass_b_term_scale(x.seg, x.t, x.coeffs, sev, pnz, nz)


def _close_t(got, want, scale, rtol):
    got, want, scale = (np.asarray(v, np.float64) for v in (got, want, scale))
    err = np.abs(got - want)
    assert (err <= rtol * scale + 1e-12).all(), f"max err/bound {np.max(err / (rtol * scale)):.3f}"


def _close_base(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def _jax_backward(x, bins):
    """JAX's (ḡ_t contracted from ḡ_selector, ḡ_base) on the same inputs,
    pallas_call in interpret mode, per-chain bins."""
    import jax.numpy as jnp

    from mach3_tpu.splines import monolith
    from mach3_tpu.splines import pallas_grad as pg
    from mach3_tpu.splines import pallas_reweight as pr

    jt = monolith.build_dense_table([monolith.SplineParamSpec(**s) for s in x.specs],
                                    len(x.lay.event_perm))
    pp = jnp.asarray(x.lay.param_perm)
    jt = jt.replace(knots_x=jnp.take(jt.knots_x, pp, axis=0), n_knots=jnp.take(jt.n_knots, pp),
                    param_index=jnp.take(jt.param_index, pp))
    selector = pr.spline_selector(jt, jnp.asarray(x.params))
    gsel, gbase = pg._grad_backward(
        (x.n_bins, 4, 128, None, False),
        (selector, jnp.asarray(x.coeffs.float().numpy()), jnp.asarray(x.base.numpy()),
         jnp.asarray(bins.numpy())),
        (jnp.asarray(x.gmc.numpy()), jnp.asarray(x.gw2.numpy())))
    gsel = np.asarray(gsel, np.float64)
    c, p, k4 = gsel.shape
    g4 = np.take_along_axis(gsel.reshape(c, p, k4 // 4, 4), x.seg.numpy()[:, :, None, None], 2)
    t = x.t.double().numpy()
    return g4[:, :, 0, 1] + 2 * t * g4[:, :, 0, 2] + 3 * t * t * g4[:, :, 0, 3], np.asarray(gbase)


@pytest.fixture()
def interpret(monkeypatch):
    """Every ``pallas_call`` of the JAX package in interpret mode."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", patched)


@pytest.mark.parametrize("kind", ["scale", "offset"])
def test_shifted_route_under_its_plan_matches_jax(interpret, kind):
    x = _laid_out(kind=kind, seed=1)
    p = x.coeffs.shape[0]
    assert (np.diff(x.lay.plan_ptr) < p).all() and len(x.lay.plan_ptr) > 3
    sb = x.bins
    t = x.t.clone().requires_grad_(True)
    base = x.base.clone().requires_grad_(True)
    before = dict(reweight.LAUNCHES)
    mc, w2 = grad.fused_reweight_diff_shifted(
        t, base, x.seg, x.coeffs, sb.shift_vals, sb.x_nom, sb.static_base, sb.edges,
        n_bins=x.n_bins, shift_kind=kind, stride_j=1, n_axis_j=N_AXIS, **x.plan)
    g_t, g_base = torch.autograd.grad((x.gmc * mc).sum() + (x.gw2 * w2).sum(), (t, base))
    assert reweight.LAUNCHES == before  # the plain versions are not launches
    bins = sb.bins(x.n_bins)
    scale = _term_scale(x, bins).numpy()
    # the port's own plain route, by autograd
    t2 = x.t.clone().requires_grad_(True)
    base2 = x.base.clone().requires_grad_(True)
    mc_p, w2_p = histogram(spline_product(x.coeffs, x.seg, t2, base2), bins, x.n_bins)
    own_t, own_base = torch.autograd.grad((x.gmc * mc_p).sum() + (x.gw2 * w2_p).sum(), (t2, base2))
    _close_t(g_t.numpy(), own_t.numpy(), scale, SELF_RTOL * p)
    _close_base(g_base.numpy(), own_base.numpy(), SELF_RTOL * p)
    jax_t, jax_base = _jax_backward(x, bins)
    _close_t(g_t.numpy(), jax_t, scale, JAX_T_RTOL)
    _close_base(g_base.numpy(), jax_base, JAX_BASE_RTOL)
    assert (g_t != 0).all(dim=0).any() and (g_base != 0).any()


# ------------------------------------------------------- the wrapper's checks


def _small(n_params=4, n_events=250, bf16=False, knots=5):
    rng = np.random.default_rng(4)
    x_knots = np.linspace(-3.0, 3.0, knots)
    specs = [dict(name=f"s{p}", param_index=p, x_knots=x_knots, event_ids=np.arange(n_events),
                  y_knots=1.0 + 0.05 * rng.normal(size=(n_events, knots)))
             for p in range(n_params)]
    table = build_dense_table([SplineParamSpec(**s) for s in specs], n_events, low_memory=bf16)
    seg, t = find_segments(table.knots_x, table.n_knots,
                           torch.from_numpy(rng.normal(scale=0.5, size=(3, n_params))))
    bins = torch.from_numpy(rng.integers(0, 8, n_events).astype(np.int32))
    base = torch.from_numpy(rng.uniform(0.5, 2.0, size=(3, n_events)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3, 8)).astype(np.float32))
    return [seg, t, table.coeffs, base, bins, g, g.clone()]


CHECKS = {
    # name: (arguments, keyword changes, the error or None)
    "unaligned_pitch_taken": (lambda: _small(bf16=True), {}, None),
    "p_over_256": (lambda: _small(n_params=257, n_events=40), {}, ValueError),
    "k4_not_multiple_of_4": (lambda: [a[:, :-1].contiguous() if i == 2 else a
                                      for i, a in enumerate(_small())], {}, ValueError),
    "knots_over_64": (lambda: _small(n_events=40, knots=65), {}, ValueError),
    "shared_memory_over_limit": (lambda: _small(n_params=256, n_events=20, knots=64), {},
                                 ValueError),
    "unknown_shift_kind": (lambda: _small(), {"shift_kind": "log"}, ValueError),
}


@pytest.mark.parametrize("case", list(CHECKS))
def test_wrapper_checks(case):
    make, change, error = CHECKS[case]
    a = make()
    if "shift_kind" in change:
        e = a[2].shape[2]
        a[4] = grad.ShiftedBins(torch.zeros(3), torch.ones(e), torch.zeros(e, dtype=torch.int32),
                                torch.arange(9, dtype=torch.float32), change["shift_kind"], 1, 8)
    if error is None:
        g_t, g_base = grad.reweight_backward(*a, n_bins=8)
        assert a[2].shape[2] * a[2].element_size() % 16 != 0
        assert torch.isfinite(g_t).all() and g_base.shape == a[3].shape
    else:
        with pytest.raises(error):
            grad.reweight_backward(*a, n_bins=8)


def test_need_t_false_gives_no_g_t_and_the_same_g_base():
    x = _laid_out(n_events=600, seed=2)
    kw = dict(n_bins=x.n_bins, **x.plan)
    g_t, g_base = grad.reweight_backward(x.seg, x.t, x.coeffs, x.base, x.bins, x.gmc, x.gw2, **kw)
    none, g_base2 = grad.reweight_backward(x.seg, x.t, x.coeffs, x.base, x.bins, x.gmc, x.gw2,
                                           need_t=False, **kw)
    assert none is None and g_t is not None and torch.equal(g_base, g_base2)
    # through autograd: t not differentiated, base is
    base = x.base.clone().requires_grad_(True)
    sb = x.bins
    mc, w2 = grad.fused_reweight_diff_shifted(
        x.t, base, x.seg, x.coeffs, sb.shift_vals, sb.x_nom, sb.static_base, sb.edges,
        n_bins=x.n_bins, shift_kind="scale", stride_j=1, n_axis_j=N_AXIS, **x.plan)
    (g,) = torch.autograd.grad((x.gmc * mc).sum() + (x.gw2 * w2).sum(), base)
    assert torch.equal(g, g_base)


# --------------------------------------------------------------------- the card


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


def _on(x, dev):
    out = types.SimpleNamespace(**{k: v.to(dev) if torch.is_tensor(v) else v
                                   for k, v in vars(x).items()})
    out.bins = grad.ShiftedBins(*(getattr(x.bins, f).to(dev) for f in
                                  ("shift_vals", "x_nom", "static_base", "edges")),
                                x.bins.shift_kind, x.bins.stride_j, x.bins.n_axis_j)
    out.plan = {k: v.to(dev) for k, v in x.plan.items()}
    return out


def _hold(x, got, ref, what):
    """The kernel's (ḡ_t, ḡ_base) against the plain passes' on the card."""
    p = x.coeffs.shape[0]
    bins = x.bins.bins(x.n_bins) if isinstance(x.bins, grad.ShiftedBins) else x.bins
    _close_base(got[1].cpu().numpy(), ref[1].cpu().numpy(), SELF_RTOL * p)
    if ref[0] is not None:
        assert torch.isfinite(got[0]).all(), what
        _close_t(got[0].cpu().numpy(), ref[0].cpu().numpy(), _term_scale(x, bins).cpu().numpy(),
                 SELF_RTOL * p)


CUDA_CASES = ["shifted_plan", "shifted_inkernel_bins", "need_t_false", "bf16_unaligned",
              "bit_identical", "subnormal_response", "huge_response"]
EXTREME = {"subnormal_response": 2.0 ** -130, "huge_response": 2.0 ** 127}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_backward_matches_plain_passes(cuda_device, case):
    dev = cuda_device
    if case == "bf16_unaligned":  # per-chain bins, rows 1,554 bytes apart
        a = [v.to(dev) for v in _small(n_params=9, n_events=777, bf16=True)]
        a[4] = torch.randint(-1, 9, (3, 777), dtype=torch.int32, device=dev)
        x = types.SimpleNamespace(seg=a[0], t=a[1], coeffs=a[2], base=a[3], bins=a[4], gmc=a[5],
                                  gw2=a[6], n_bins=8, plan={})
    elif case in EXTREME:  # parameter 1 at its first knot: response = the value row, slope 1
        a = _small(n_params=4, n_events=256)
        a[0][:, 1], a[1][:, 1] = 0, 0.0
        a[2][1, 0, :128], a[2][1, 1] = EXTREME[case], 1.0
        if case == "huge_response":  # 2·base·Πr and G·base·Πr stay finite
            a[3], a[5] = 0.01 * a[3], 0.01 * a[5]
        a[6] = torch.zeros_like(a[6])
        a = [v.to(dev) for v in a]
        x = types.SimpleNamespace(seg=a[0], t=a[1], coeffs=a[2], base=a[3], bins=a[4], gmc=a[5],
                                  gw2=a[6], n_bins=8, plan={})
    else:
        x = _on(_laid_out(n_chains=21, n_events=5000, n_params=20, seed=5,
                          kind="offset" if case == "shifted_inkernel_bins" else "scale",
                          bf16=case == "bit_identical"), dev)
    if case == "shifted_inkernel_bins":  # one cotangent value per bin: a wrong bin shows
        x.gmc = (1.0 + torch.arange(x.gmc.numel(), dtype=torch.float32, device=dev)).reshape(
            x.gmc.shape)
        x.gw2 = torch.zeros_like(x.gw2)
    args = (x.seg, x.t, x.coeffs, x.base, x.bins, x.gmc, x.gw2)
    kw = dict(n_bins=x.n_bins, **x.plan)
    before = reweight.LAUNCHES["reweight_backward"]
    need_t = case != "need_t_false"
    got = grad.reweight_backward(*args, need_t=need_t, **kw)
    torch.cuda.synchronize()
    assert reweight.LAUNCHES["reweight_backward"] == before + 1
    ref = grad.reweight_backward_ref(*args, need_t=need_t, **kw)
    _hold(x, got, ref, case)
    if case == "shifted_plan":
        ptr, idx = plan.trivial_active(x.base.shape[1], x.coeffs.shape[0])
        for plan_kw in (dict(plan_ptr=torch.as_tensor(ptr, device=dev),
                             plan_idx=torch.as_tensor(idx, device=dev)), {}):
            _hold(x, grad.reweight_backward(*args, n_bins=x.n_bins, **plan_kw), ref, case)
    if case == "need_t_false":
        assert got[0] is None
    if case == "bit_identical":
        for _ in range(3):
            again = grad.reweight_backward(*args, **kw)
            assert torch.equal(again[0], got[0]) and torch.equal(again[1], got[1])
