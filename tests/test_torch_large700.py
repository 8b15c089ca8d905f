"""The port's 700-parameter envelope (``build_large700``) vs the JAX
package's, at the reduced size of ``tests/test_large700.py``'s gradient test
(1,500 / 600 / 1,500 events, small oscillation grids), always with 655 splines
and 700 parameters.

* Structure: 7 samples, the 655 spline rows split over them (80-110 each),
  each sample's norm axis compressed to at most 40 rows, routes shared x 5
  (numu_a/b, atmo_a/b/c) and shifted x 2 (nue_a/b, P > 16).
* Same fixture: the port draws the same numpy random numbers, so events,
  norm matches, spline tables and oscillation indices equal JAX's before the
  kernel routes' event layout (both on the plain route), exactly.
* Likelihood at prefit and at three jittered points, built natively and by
  the bridge from the JAX model, against JAX production (its XLA route,
  which rounds response deviations to bf16): per-sample and total NLLs
  within 5e-3 + 1e-3·|NLL|, the budget of ``test_torch_large.py``
  (ROADMAP Queue 3, "Measured gaps").
* Asimov NLL at prefit 0 (1e-6); gradients of ``log_posterior_batch``
  finite and non-zero (``tests/test_large700.py:55``'s counterpart).
* On the card (``cuda``): each route's forward kernel against its plain
  version at large700's parameter widths, and the gradient through the
  backward kernel against the plain route. These import no jax and run
  with ``--noconftest`` where a card is.
"""
import numpy as np
import pytest
import torch

from mach3_tpu_torch.bridge import from_jax_model
from mach3_tpu_torch.tutorial.large import build_large700

torch.set_num_threads(1)

SIZE = dict(n_numu=1500, n_nue=600, n_atmo=1500, e_grid_size=30, atmo_e_grid_size=10,
            atmo_cosz_grid_size=6, seed=11)
NAMES = ["numu_a", "nue_a", "numu_b", "nue_b", "atmo_a", "atmo_b", "atmo_c"]
ROUTES = ["shared", "shifted", "shared", "shifted", "shared", "shared", "shared"]
NLL_PROD_ATOL, NLL_PROD_RTOL = 5e-3, 1e-3


@pytest.fixture(scope="module")
def port():
    return build_large700(**SIZE, device="cpu")


@pytest.fixture(scope="module")
def port_plain():
    return build_large700(**SIZE, use_kernel=False, asimov=False, device="cpu")


@pytest.fixture(scope="module")
def jax_model(port):
    """JAX's model (its XLA route on the CPU, events unsorted) on the port's
    PREM paths (``jax_prem.py``), carrying the port's Asimov data, so both
    sides score the same observed histograms."""
    from jax_prem import repaired_paths
    from mach3_tpu.fitters.model import FitModel as JFitModel
    from mach3_tpu.tutorial.large import build_large700 as jbuild_large700

    with repaired_paths():
        j = jbuild_large700(**SIZE, asimov=False)
    samples = [s.with_data(t.data.numpy()) for s, t in zip(j.samples, port.samples)]
    return j, JFitModel.build([j.xsec, j.osc], samples)


def _thetas(flat, n_chains=4, seed=0):
    """Prefit and prefit + 5% prior-sigma jitter inside the bounds."""
    chol = np.asarray(flat.chol)
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = np.asarray(flat.low_bound), np.asarray(flat.up_bound)
    th = np.asarray(flat.prefit) + 0.05 * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    th = np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
    th[0] = np.asarray(flat.prefit)
    return th


@pytest.fixture(scope="module")
def reference(jax_model):
    """JAX production per-sample NLLs [C, 7] (XLA route) and the total with
    JAX's prior."""
    import jax
    import jax.numpy as jnp

    _, jm = jax_model
    th = jnp.asarray(_thetas(jm._flat()))
    grids_of = jax.jit(lambda s, t: jax.vmap(s.osc_prob_grids)(t))
    nll_of = jax.jit(lambda s, t, g: s.log_likelihood_batch_xla(t, g))
    grids, parts = {}, []
    for i, s in enumerate(jm.samples):
        g = jm.osc_groups[i]
        if g not in grids:
            grids[g] = grids_of(jm.samples[g], th)
        parts.append(np.asarray(nll_of(s, th, grids[g])))
    prior = np.asarray(jax.jit(lambda m, t: jax.vmap(m.prior_nll_breakdown)(t))(jm, th))
    parts = np.stack(parts, axis=1)
    return np.array(th), parts, prior.sum(1) + parts.sum(1)


def test_structure(port):
    assert port.n_params == 700 and len(port.samples) == 7
    assert [s.name for s in port.samples] == NAMES
    assert [s.kernel_route.variant for s in port.samples] == ROUTES
    assert all(s.event_pad is not None and s.n_events % 256 == 0 for s in port.samples)
    counts = [s.spline_table.n_spline_params for s in port.samples]
    assert sum(counts) == 655 and all(80 <= c <= 110 for c in counts), counts
    assert [s.n_bins for s in port.samples] == [1152, 30, 1152, 30, 1000, 1000, 1000]
    for s in port.samples:
        assert s.norm_applied is not None and s.norm_s is not None
        assert s.norm_s.shape[0] <= 40, (s.name, s.norm_s.shape)
        assert s.spline_table.coeffs.dtype == torch.bfloat16
        assert s.stat_dtype == torch.float32
    assert port.model.osc_groups == (0, 0, 0, 0, 4, 4, 4)  # one beam grid, one atmo grid


def _eq(a, b):
    a = np.asarray(a)
    b = b.float().numpy() if b.dtype == torch.bfloat16 else b.numpy()
    assert a.shape == b.shape and np.array_equal(a.astype(b.dtype), b)


@pytest.mark.parametrize("i", range(7), ids=NAMES)
def test_same_fixture_before_layout(jax_model, port_plain, i):
    js, ts = jax_model[0].samples[i], port_plain.samples[i]
    assert js.name == ts.name == NAMES[i] and js.n_bins == ts.n_bins
    assert ts.kernel_route.variant == "xla"
    for f in ("kin", "mc_weight", "norm_idx", "norm_s", "norm_applied"):
        _eq(getattr(js, f), getattr(ts, f))
    for f in ("coeffs", "knots_x", "n_knots", "param_index"):
        _eq(getattr(js.spline_table, f), getattr(ts.spline_table, f))
    fields = (("event_flat_idx", "layer_lengths", "layer_rho")
              if NAMES[i].startswith("atmo") else ("e_grid", "event_grid_idx", "event_channel"))
    for f in fields + ("chan_alpha", "chan_beta", "chan_anti", "nc_mask", "osc_param_idx"):
        _eq(getattr(js.osc, f), getattr(ts.osc, f))
    if js.static_bins is not None:
        _eq(js.static_bins, ts.static_bins)


def test_same_priors(jax_model, port):
    jf = jax_model[1]._flat()
    for f in ("prefit", "inv_cov", "chol", "step_scale", "low_bound", "up_bound"):
        _eq(getattr(jf, f), getattr(port.model.flat, f))
    assert port.names == jax_model[0].names


def test_asimov_nll_zero_at_prefit(port):
    nll = port.model.total_nll_batch(port.model.prefit_vector()[None])
    assert abs(float(nll[0])) < 1e-6


def _check_nlls(model, reference):
    th, parts_ref, total_ref = reference
    total, _, parts = model.total_nll_batch_parts(torch.from_numpy(th))
    np.testing.assert_allclose(parts.numpy(), parts_ref, rtol=NLL_PROD_RTOL, atol=NLL_PROD_ATOL)
    np.testing.assert_allclose(total.numpy(), total_ref, rtol=NLL_PROD_RTOL,
                               atol=7 * NLL_PROD_ATOL)


@pytest.mark.parametrize("how", ["native", "bridged"])
def test_nll_matches_jax(port, jax_model, reference, how):
    model = port.model if how == "native" else from_jax_model(jax_model[1])
    assert [s.kernel_route.variant for s in model.samples] == ROUTES
    _check_nlls(model, reference)


def test_gradient_finite_and_nonzero(port):
    theta = port.model.prefit_vector()[None].repeat(2, 1).requires_grad_(True)
    (g,) = torch.autograd.grad(port.model.log_posterior_batch(theta).sum(), theta)
    assert bool(torch.isfinite(g).all())
    assert int(torch.count_nonzero(g)) > 700  # spline, norm and osc directions all live


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("i", [0, 1, 4], ids=["numu_a", "nue_a", "atmo_a"])
def test_cuda_kernels_at_large700_widths(cuda_device, i):
    """Each route's forward kernel and the backward kernel at large700's P
    (~94) against their plain versions (the smoke's tolerances)."""
    from mach3_tpu_torch.kernels.launch import LAUNCHES
    from mach3_tpu_torch.splines import reweight

    model = build_large700(**SIZE, device="cpu").model
    # jittered chains only: at prefit (the Asimov minimum) the gradient is ~0
    th = torch.as_tensor(_thetas(model.flat, n_chains=20, seed=1)[1:], device=cuda_device)
    model.to(cuda_device)
    s = model.samples[i]
    tables = model._shared_osc_tables(th)
    name = f"reweight_{s.kernel_route.variant}"
    before = LAUNCHES[name]
    with torch.no_grad():
        if s.kernel_route.variant == "shared":
            args, kw = s.shared_kernel_args(th, tables[i])
            got = reweight.fused_reweight_histogram_shared(*args, **kw)
            ref = reweight.fused_reweight_histogram_shared_ref(*args, **kw)
        else:
            args, kw = s.shifted_kernel_args(th, tables[i])
            got = reweight.fused_reweight_histogram_shifted(*args, **kw)
            ref = reweight.fused_reweight_histogram_shifted_ref(*args, **kw)
    assert LAUNCHES[name] == before + 1
    for x, y in zip(got, ref):
        tol = 2e-5 * y.abs() + 1e-6 * y.abs().max()
        assert bool(((x - y).abs() <= tol).all())
    t = th.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(s.log_likelihood_batch_diff(t, tables[i]).sum(), t)
    (g_p,) = torch.autograd.grad(s.log_likelihood_batch_plain(t, tables[i]).sum(), t)
    assert bool(torch.isfinite(g).all())
    assert float(((g - g_p).abs() / g_p.abs().amax(1, keepdim=True)).max()) < 5e-3
