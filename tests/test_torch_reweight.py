"""The fused shifted reweight-histogram (K1) of the port vs the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
* to the f32 oracle built from JAX pieces — ``eval_dense(exact=True)`` x base
  x norm, ``find_bins`` on the shifted variable, ``histogram`` — within
  rtol 2e-5, atol 1e-6·max|mc|: f32 sums over a few hundred events taken in
  another order;
* to JAX's production kernel (``fused_reweight_histogram_shifted`` in Pallas
  interpret mode) within rtol 2e-3, atol 1e-6·max|mc|: JAX rounds every
  response deviation to bf16, the port keeps f32 (splines/eval.py).

A NaN norm value makes its chain's NLL non-finite on every route, and
leaves the other chains as they were: JAX's kernel (its ``_norm_weight``
log-matmul) and the port's plain version spread the NaN to every event of
the chain, the CUDA kernel to the events that match the norm; MR2T2 rejects
a proposal whose NLL is not finite.

Each shift kind of ``SHIFT_KINDS`` (``scale``, ``offset``,
``scale_about_one``) takes the shifted route as a sample's single shift, and
the plain version bins every event, edge events included, exactly as the
sample's plain route does (unit weights: equal counts).

The ``cuda``-marked tests hold the CUDA kernel to the plain version, for
every shift kind too; they run only where a CUDA device is visible and
import no jax, so they also run with ``--noconftest`` on a machine without
jax.
"""
import types

import numpy as np
import pytest
import torch

from mach3_tpu_torch.samples.events import EventData, build_sample_model
from mach3_tpu_torch.samples.sample import ShiftSpec
from mach3_tpu_torch.splines import reweight
from mach3_tpu_torch.splines.eval import find_segments
from mach3_tpu_torch.splines.monolith import SplineParamSpec, build_dense_table

torch.set_num_threads(1)

EDGES = np.linspace(0.0, 3.0, 9)  # shifted axis: 8 bins
N_OTHER = 2  # a static axis of 2 bins -> 16 bins, stride 2 on the shifted axis
N_BINS = 8 * N_OTHER
ORACLE_RTOL, ORACLE_ATOL = 2e-5, 1e-6
PROD_RTOL = 2e-3


def _scale(v, x):
    return x * (1.0 + v)


def _inputs(case: str, n_chains: int = 5, n_events: int = 300, seed: int = 0):
    """numpy inputs of one case; C and E are not multiples of any tile."""
    rng = np.random.default_rng(seed)
    specs = []
    for p, interp in enumerate(["TSpline3", "Akima", "Linear"]):
        # toy-like responses (tutorial/toy.py): 1 + slope·σ + curv·σ² at the knots
        ev = np.sort(rng.choice(n_events, size=2 * n_events // 3, replace=False))
        sigma = np.array([-3.0, -1, 0, 1, 3])
        slope = 0.08 * (1.0 + 0.3 * rng.normal(size=(len(ev), 1)))
        curv = 0.01 * rng.normal(size=(len(ev), 1))
        y = np.clip(1.0 + slope * sigma + curv * sigma**2, 0.0, None)
        specs.append(dict(name=f"s{p}", param_index=p, x_knots=sigma,
                          event_ids=ev, y_knots=y, interpolation=interp))
    params = np.zeros((n_chains, 4))
    params[:, :3] = rng.normal(scale=0.8, size=(n_chains, 3))
    params[-1, 0] = 3.7  # extrapolation past the last knot
    shift = rng.uniform(-0.1, 0.1, size=n_chains).astype(np.float32)
    shift[0] = 0.0  # chain 0 bins x_nom exactly: events sit on edges
    x_nom = rng.uniform(-0.2, 3.2, size=n_events).astype(np.float32)
    x_nom[:9] = EDGES  # exactly on every edge (incl. the first and last)
    x_nom[9:12] = [-1.0, 3.0001, 7.0]  # below the first edge, above the last
    static = rng.integers(0, N_OTHER, size=n_events).astype(np.int32)
    static[rng.choice(n_events, size=12, replace=False)] = -1  # invalid static axis
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
        specs=specs, params=params, shift=shift, x_nom=x_nom, static=static, base=base,
        norm_ext=norm_ext, norm_s=norm_s, low_memory=case == "bf16",
    )


def _port_args(d, device="cpu", kind="scale"):
    """(args, kwargs) of the port's wrapper for inputs ``d``."""
    table = build_dense_table(
        [SplineParamSpec(**s) for s in d.specs], len(d.x_nom), low_memory=d.low_memory
    ).to(device)
    params = torch.as_tensor(d.params, device=device)
    seg, t = find_segments(table.knots_x, table.n_knots, params[:, table.param_index])

    def dev(a):
        return None if a is None else torch.as_tensor(a, device=device)

    args = (seg, t, table.coeffs, dev(d.base), dev(d.shift), dev(d.x_nom), dev(d.static),
            torch.as_tensor(EDGES, dtype=torch.float32, device=device))
    kwargs = dict(n_bins=N_BINS, shift_kind=kind, stride_j=N_OTHER, n_axis_j=len(EDGES) - 1,
                  norm_ext=dev(d.norm_ext), norm_s=dev(d.norm_s))
    return args, kwargs


@pytest.fixture()
def jx(monkeypatch):
    """JAX package pieces, with pallas_call forced into interpret mode
    (as tests/test_pallas.py does)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from mach3_tpu.params.parameterset import SplineInterpolation
    from mach3_tpu.samples.binning import SampleBinning, histogram
    from mach3_tpu.splines import monolith
    from mach3_tpu.splines import pallas_reweight as pr
    from mach3_tpu.splines.eval import eval_dense

    orig = pl.pallas_call

    def interpret(*args, **kwargs):
        kwargs.setdefault("interpret", True)
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpret)
    pr.fused_reweight_histogram_shifted.clear_cache()
    yield types.SimpleNamespace(
        jax=jax, jnp=jnp, pr=pr, eval_dense=eval_dense, histogram=histogram,
        SampleBinning=SampleBinning, monolith=monolith, Interp=SplineInterpolation,
    )
    pr.fused_reweight_histogram_shifted.clear_cache()


def _jax_table(jx, d):
    specs = [jx.monolith.SplineParamSpec(**{**s, "interpolation": jx.Interp(s["interpolation"])})
             for s in d.specs]
    return jx.monolith.build_dense_table(specs, len(d.x_nom), low_memory=d.low_memory)


def _jax_production(jx, d):
    jnp = jx.jnp
    table = _jax_table(jx, d)
    selector = jx.pr.spline_selector(table, jnp.asarray(d.params))
    norm = {}
    if d.norm_ext is not None:
        norm = dict(norm_ext=jnp.asarray(d.norm_ext), norm_s=jnp.asarray(d.norm_s))
    mc, w2 = jx.pr.fused_reweight_histogram_shifted(
        selector, table.coeffs, jnp.asarray(d.base), jnp.asarray(d.shift),
        jnp.asarray(d.x_nom), jnp.asarray(d.static), n_bins=N_BINS, shift_fn=_scale,
        edges=tuple(float(e) for e in EDGES), stride_j=N_OTHER, n_axis_j=len(EDGES) - 1,
        chain_tile=4, event_tile=128, **norm,
    )
    return np.asarray(mc), np.asarray(w2)


def _oracle(jx, d):
    """f32 oracle from JAX pieces; the norm product with the kernels'
    semantics (|ext| floored at 1e-30, sign from the parity of negatives)."""
    jax, jnp = jx.jax, jx.jnp
    table = _jax_table(jx, d)
    w = jax.vmap(lambda p: jx.eval_dense(table, p, exact=True))(jnp.asarray(d.params))
    w = w * jnp.asarray(d.base)
    if d.norm_ext is not None:
        ext = d.norm_ext.astype(np.float64)
        logw = np.log(np.maximum(np.abs(ext), 1e-30)) @ d.norm_s
        neg = (ext < 0).astype(np.float64) @ d.norm_s
        w = w * jnp.asarray(np.exp(logw) * (1.0 - 2.0 * (neg % 2)), jnp.float32)
    binning = jx.SampleBinning.build([EDGES], [0])
    x = jnp.asarray(d.x_nom)[None, :] * (1.0 + jnp.asarray(d.shift)[:, None])  # f32
    idx = jax.vmap(lambda xc: binning.find_bins(xc[None, :]))(x)  # n_axis = out of range
    static = jnp.asarray(d.static)
    valid = (idx < len(EDGES) - 1) & (static >= 0)
    bins = jnp.where(valid, static + N_OTHER * idx, N_BINS)
    mc, w2 = jax.vmap(lambda wc, bc: jx.histogram(wc, bc, N_BINS))(w, bins)
    return np.asarray(mc), np.asarray(w2)


def _close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=ORACLE_ATOL * np.abs(want).max())


CASES = ["norm", "no_norm", "negative_norm", "zero_norm", "bf16"]


@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_jax(jx, case):
    d = _inputs(case)
    args, kwargs = _port_args(d)
    mc, w2 = reweight.fused_reweight_histogram_shifted(*args, **kwargs)
    assert mc.shape == (5, N_BINS) and mc.dtype == torch.float32
    mc, w2 = mc.numpy(), w2.numpy()
    if case != "bf16":  # the oracle's exact eval is f32-table only
        mc_o, w2_o = _oracle(jx, d)
        _close(mc, mc_o, ORACLE_RTOL)
        _close(w2, w2_o, ORACLE_RTOL)
    mc_j, w2_j = _jax_production(jx, d)
    _close(mc, mc_j, PROD_RTOL)
    _close(w2, w2_j, PROD_RTOL)
    if case == "negative_norm":
        assert (mc[-1] < 0).any()  # odd counts of the negative norm flip signs


def test_zero_norm_gives_tiny_weight_not_zero(jx):
    """A zero norm weighs ~1e-30, as the TPU kernel's floored log-norm gives
    (the JAX XLA route gives an exact 0); the port keeps the kernel's choice."""
    d = _inputs("zero_norm", n_chains=1, n_events=20)
    d.norm_ext[0] = [0.0, 1.0, 1.0, 1.0]
    d.norm_s[:] = 0.0
    d.norm_s[0] = 1.0
    d.norm_s[3] = 1.0
    d.static[:] = 0
    d.x_nom[:] = 1.1
    args, kwargs = _port_args(d)
    mc, _ = reweight.fused_reweight_histogram_shifted(*args, **kwargs)
    total = float(mc.sum())
    assert 0.0 < total < 1e-25
    mc_j, _ = _jax_production(jx, d)
    assert total == pytest.approx(float(mc_j.sum()), rel=1e-2)


def _nll(stat_fn, data, mc, w2):
    return np.asarray(stat_fn(data, mc, w2)).sum(-1)


def test_nan_norm_spoils_only_its_chain(jx):
    """A NaN norm value in chain 2: its NLL is non-finite in JAX's kernel
    and in the port's plain version, every other chain's is what it was
    without it; MR2T2 then rejects such a proposal."""
    from mach3_tpu.samples.teststats import get_test_stat_fn as jstat
    from mach3_tpu_torch.samples.teststats import get_test_stat_fn

    d = _inputs("norm")
    args, kwargs = _port_args(d)
    clean = [v.double() for v in reweight.fused_reweight_histogram_shifted(*args, **kwargs)]
    data = clean[0][0].clone()
    d.norm_ext[2, 1] = np.nan
    args, kwargs = _port_args(d)
    mc, w2 = (v.double() for v in reweight.fused_reweight_histogram_shifted(*args, **kwargs))
    mc_j, w2_j = (np.asarray(v, np.float64) for v in _jax_production(jx, d))
    stat = get_test_stat_fn("BarlowBeeston")
    got, want = stat(data, mc, w2).sum(-1).numpy(), stat(data, *clean).sum(-1).numpy()
    got_j = _nll(jstat("BarlowBeeston"), jx.jnp.asarray(data.numpy()), mc_j, w2_j)
    others = [0, 1, 3, 4]
    assert not np.isfinite(got[2]) and not np.isfinite(got_j[2])
    assert np.array_equal(got[others], want[others]) and np.isfinite(got_j[others]).all()
    np.testing.assert_allclose(got_j[others], want[others], rtol=1e-3, atol=5e-3)
    # both spread the NaN over the chain: every bin with an event
    filled = clean[0][2] != 0
    assert torch.isnan(mc[2][filled]).all() and np.isnan(mc_j[2][filled.numpy()]).all()


def test_mr2t2_rejects_a_non_finite_proposal():
    from mach3_tpu_torch.fitters.mcmc import ChainState, MCMCConfig, make_step_fn_args
    from mach3_tpu_torch.tutorial.toy import build_toy

    model = build_toy(n_events=1500, seed=11, e_grid_size=30, device="cpu").model
    theta = model.prefit_vector().repeat(4, 1)
    state = ChainState(theta=theta, nll=model.total_nll_batch(theta), generator=None, step=0,
                       n_accepted=torch.zeros(4, dtype=torch.int32))
    z = torch.zeros((4, model.flat.chol.shape[1]), dtype=torch.float64)
    z[2] = np.nan  # chain 2 proposes NaN values, norms included
    new, out = make_step_fn_args(MCMCConfig())(model, state, z=z,
                                               flip_u=torch.ones_like(theta),
                                               u_acc=torch.zeros(4, dtype=torch.float64))
    assert out["accepted"].tolist() == [True, True, False, True]
    assert torch.equal(new.theta, theta) and torch.equal(new.nll, state.nll)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    args, kwargs = _port_args(_inputs("norm"))
    seg, t, coeffs, base, shift, x_nom, static, edges = args
    with pytest.raises(TypeError):
        reweight.fused_reweight_histogram_shifted(seg.long(), *args[1:], **kwargs)
    with pytest.raises(ValueError):
        reweight.fused_reweight_histogram_shifted(*args[:3], base[:, :-1], *args[4:], **kwargs)
    with pytest.raises(ValueError):
        reweight.fused_reweight_histogram_shifted(*args[:3], base.t().contiguous().t(),
                                                  *args[4:], **kwargs)
    with pytest.raises(ValueError):
        reweight.fused_reweight_histogram_shifted(*args, **{**kwargs, "shift_kind": "double_scale"})
    with pytest.raises(ValueError):
        reweight.fused_reweight_histogram_shifted(*args, **{**kwargs, "n_bins": 513})
    with pytest.raises(ValueError):
        reweight.fused_reweight_histogram_shifted(*args, **{**kwargs, "norm_s": None})
    before = dict(reweight.LAUNCHES)
    reweight.fused_reweight_histogram_shifted(*args, **kwargs)
    assert reweight.LAUNCHES == before  # the plain version is not a launch


@pytest.mark.parametrize("kind", sorted(reweight.SHIFT_KINDS))
def test_shift_kinds_bin_edge_events_as_the_plain_route(kind):
    edges = np.linspace(0.0, 3.0, 13)  # steps of 0.25: exact in f32
    rng = np.random.default_rng(7)
    x = np.concatenate([edges, edges + 0.125, rng.uniform(-0.5, 3.5, 3000)])
    n = len(x)
    events = EventData(kinematics={"x": x, "y": rng.uniform(0.0, 1.0, n)},
                       mode=np.zeros(n, np.int32), target=np.full(n, 12, np.int32),
                       pdg=np.full(n, 14, np.int32), preosc_pdg=np.full(n, 14, np.int32),
                       mc_weight=np.ones(n))
    unit = SplineParamSpec("s", 0, np.array([-1.0, 0.0, 1.0]), np.arange(n), np.ones((n, 3)))
    sample = build_sample_model(
        "s", events, ["x", "y"], [edges, np.array([0.0, 0.5, 1.0])], ["x", "y"],
        n_total_params=2, spline_table=build_dense_table([unit], n),
        shifts=(ShiftSpec.named(kind, 1, 0),))
    assert sample.kernel_route.variant == "shifted" and sample.kernel_shift[0] == kind
    th = np.zeros((9, 2))
    th[:, 1] = [0.0, 0.25, -0.25, 0.5, 0.125, -0.375, 0.1, -0.3, 1e-7]
    th = torch.from_numpy(th)
    mc, w2 = sample.reweight_batch(th)  # the kernel's plain version on the CPU
    mc_p, w2_p = sample.reweight_batch_plain(th)
    assert torch.equal(mc, mc_p) and torch.equal(w2, w2_p)
    assert float(mc.sum()) > 0.9 * n


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES + ["nan_shift"])
def test_cuda_kernel_matches_plain_version(cuda_device, case):
    d = _inputs("norm" if case == "nan_shift" else case, n_chains=11, n_events=5000)
    if case == "nan_shift":
        d.shift[3] = np.nan  # every event of chain 3 lands in the garbage bin
    args, kwargs = _port_args(d, cuda_device)
    before = reweight.LAUNCHES["reweight_shifted"]
    mc, w2 = reweight.fused_reweight_histogram_shifted(*args, **kwargs)
    torch.cuda.synchronize()
    assert reweight.LAUNCHES["reweight_shifted"] == before + 1
    mc_p, w2_p = reweight.fused_reweight_histogram_shifted_ref(*args, **kwargs)
    _close(mc.cpu().numpy(), mc_p.cpu().numpy(), ORACLE_RTOL)
    _close(w2.cpu().numpy(), w2_p.cpu().numpy(), ORACLE_RTOL)
    if case == "nan_shift":
        assert float(mc[3].abs().sum()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["shifted", "generic"])
def test_cuda_nan_norm_spoils_only_its_chain(cuda_device, route):
    """Through the kernel a NaN norm reaches the events that match it: the
    chain's histogram and NLL are non-finite, the other chains agree with
    the plain version; on the shifted route's kernel and on the generic
    route's (the same binning as its bin map, the norm in the kernel)."""
    from mach3_tpu_torch.samples.teststats import get_test_stat_fn
    from mach3_tpu_torch.splines.grad import ShiftedBins

    d = _inputs("norm", n_chains=11, n_events=5000)
    d.norm_ext[2, 1] = np.nan
    args, kwargs = _port_args(d, cuda_device)
    if route == "generic":
        bins = ShiftedBins(*args[4:8], kwargs["shift_kind"], kwargs["stride_j"],
                           kwargs["n_axis_j"]).bin_map()
        args = args[:4] + (bins,)
        kwargs = dict(n_bins=kwargs["n_bins"], norm_ext=kwargs["norm_ext"],
                      norm_s=kwargs["norm_s"])
        kern, ref = reweight.fused_reweight_histogram, reweight.fused_reweight_histogram_ref
    else:
        kern = reweight.fused_reweight_histogram_shifted
        ref = reweight.fused_reweight_histogram_shifted_ref
    mc, w2 = kern(*args, **kwargs)
    torch.cuda.synchronize()
    mc_p, w2_p = ref(*args, **kwargs)
    others = [c for c in range(11) if c != 2]
    _close(mc[others].cpu().numpy(), mc_p[others].cpu().numpy(), ORACLE_RTOL)
    _close(w2[others].cpu().numpy(), w2_p[others].cpu().numpy(), ORACLE_RTOL)
    data = mc_p[0].double()
    nll = get_test_stat_fn("BarlowBeeston")(data, mc.double(), w2.double()).sum(-1).cpu()
    assert not torch.isfinite(nll[2]) and torch.isfinite(nll[others]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(reweight.SHIFT_KINDS))
def test_cuda_shift_kinds_match_plain_version(cuda_device, kind):
    d = _inputs("norm", n_chains=11, n_events=5000)
    args, kwargs = _port_args(d, cuda_device, kind)
    mc, w2 = reweight.fused_reweight_histogram_shifted(*args, **kwargs)
    torch.cuda.synchronize()
    mc_p, w2_p = reweight.fused_reweight_histogram_shifted_ref(*args, **kwargs)
    _close(mc.cpu().numpy(), mc_p.cpu().numpy(), ORACLE_RTOL)
    _close(w2.cpu().numpy(), w2_p.cpu().numpy(), ORACLE_RTOL)
