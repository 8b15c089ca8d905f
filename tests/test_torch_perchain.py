"""The per-chain-bins reweight-histogram (K5, K5b) and the unblocked shared
form (K4a) of the port vs the JAX package.

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

The ``cuda``-marked tests hold the CUDA kernels to the plain version on edge
cases (B = 512, P = 16, one event, every bin out of range, C not a multiple
of the chain tile, bf16 tables) and K5b to itself bit for bit; they import
no jax and run with ``--noconftest`` where a card is.
"""
import types

import numpy as np
import pytest
import torch

from mach3_tpu_torch.splines import plan, reweight
from mach3_tpu_torch.splines.eval import find_segments
from mach3_tpu_torch.splines.monolith import SplineParamSpec, build_dense_table

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
def test_cuda_blockdiag_is_deterministic(cuda_device):
    """K5b adds in a fixed order: two runs agree bit for bit."""
    args, kwargs = _port_args(_inputs(n_params=6, n_chains=33, n_events=20000, n_bins=200),
                              cuda_device)
    a = reweight.fused_reweight_histogram(*args, **kwargs, hist="blockdiag")
    b = reweight.fused_reweight_histogram(*args, **kwargs, hist="blockdiag")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
