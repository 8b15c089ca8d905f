"""The port's sparse and binned spline tables vs the JAX package's.

* ``build_sparse_table``: every field equal to JAX's (flat splines dropped,
  parameters of several knot counts, events with no spline).
* ``eval_sparse`` / ``eval_sparse_batched`` on JAX's table against JAX's: the
  same f32 Horner step per spline, the per-event product in another order:
  rtol 1e-6 (a product of a few f32 factors); against the port's dense table
  of the same splines (``eval_dense``): the same f32 responses multiplied in
  another order, rtol 1e-6.
* ``build_binned_table`` against JAX's (``tests/test_aux.py:143`` as the
  model), fields equal and responses as that test states them.
* ``build_toy(dense_splines=False)``: tables equal to JAX's; NLLs at prefit
  and at jittered points against JAX's within the toy's budget 5e-3 +
  1e-3·|NLL| (``test_torch_toy.py``; JAX shifts with the f64 value, the
  port with its f32 rounding, which can move an event at an edge).
* ``save_table`` / ``load_table`` both ways across the packages, dense
  (bf16 included) and sparse.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.splines import binned as jbinned
from mach3_tpu.splines import eval as jeval
from mach3_tpu.splines import monolith as jmono
from mach3_tpu.tutorial.toy import build_toy as jbuild_toy
from mach3_tpu_torch.params.parameterset import SplineInterpolation
from mach3_tpu_torch.splines.binned import BinnedSplineParamSpec, build_binned_table
from mach3_tpu_torch.splines.eval import eval_dense, eval_sparse, eval_sparse_batched
from mach3_tpu_torch.splines.monolith import (
    DenseSplineTable,
    SparseSplineTable,
    SplineParamSpec,
    build_dense_table,
    build_sparse_table,
    load_table,
    save_table,
)
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

SPARSE_FIELDS = ("spline_coeffs", "spline_param", "event_splines", "knots_x", "n_knots",
                 "param_index")
DENSE_FIELDS = ("coeffs", "knots_x", "n_knots", "param_index")
TOY = dict(n_events=3000, seed=5, e_grid_size=40)
NLL_ATOL, NLL_RTOL = 5e-3, 1e-3


def _specs(seed=0, n_events=400):
    """Spline specs of 5 parameters over the five families, knot counts 3-7,
    a quarter of each parameter's splines flat, events 0-9 with none."""
    rng = np.random.default_rng(seed)
    fams = ["TSpline3", "Linear", "Monotonic", "Akima", "KochanekBartels"]
    out = []
    for p in range(5):
        k = 3 + p
        x = np.sort(rng.uniform(-3, 3, k))
        ev = np.sort(rng.choice(np.arange(10, n_events), size=n_events // 3, replace=False))
        y = 1.0 + 0.2 * rng.normal(size=(len(ev), k))
        y[rng.random(len(ev)) < 0.25] = 1.0
        out.append((f"s{p}", 2 * p + 1, x, ev, y, fams[p]))
    return out


def _port_specs(raw):
    return [SplineParamSpec(n, i, x, ev, y, SplineInterpolation(f)) for n, i, x, ev, y, f in raw]


def _jax_specs(raw):
    from mach3_tpu.params.parameterset import SplineInterpolation as JInterp

    return [jmono.SplineParamSpec(n, i, x, ev, y, JInterp(f)) for n, i, x, ev, y, f in raw]


def _eq(j, t):
    a = np.asarray(j)
    b = t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    assert a.shape == b.shape and np.array_equal(a.astype(b.dtype), b)


@pytest.mark.parametrize("drop_flat", [True, False])
def test_build_sparse_table_matches_jax(drop_flat):
    raw = _specs()
    jt = jmono.build_sparse_table(_jax_specs(raw), 400, drop_flat=drop_flat)
    tt = build_sparse_table(_port_specs(raw), 400, drop_flat=drop_flat)
    assert tt.n_splines == jt.n_splines and tt.n_events == jt.n_events == 400
    for f in SPARSE_FIELDS:
        _eq(getattr(jt, f), getattr(tt, f))
    assert (tt.event_splines[:10] == tt.n_splines).all()  # no spline: the unit row only


def _params(n_chains, seed=1):
    """[C, 12] parameter vectors, inside and outside the knot ranges."""
    return np.random.default_rng(seed).uniform(-4, 4, size=(n_chains, 12))


def test_eval_sparse_matches_jax():
    raw = _specs(seed=2)
    jt = jmono.build_sparse_table(_jax_specs(raw), 400)
    tt = build_sparse_table(_port_specs(raw), 400)
    th = _params(6)
    want = np.asarray(jax.vmap(lambda p: jeval.eval_sparse(jt, p))(jnp.asarray(th, jnp.float32)))
    got = eval_sparse_batched(tt, torch.from_numpy(th).float()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    one = eval_sparse(tt, torch.from_numpy(th[2]).float()).numpy()
    np.testing.assert_array_equal(one, got[2])
    np.testing.assert_array_equal(got[:, :10], 1.0)


def test_eval_sparse_matches_dense():
    raw = _specs(seed=3)
    th = torch.from_numpy(_params(5, seed=4)).float()
    dense = eval_dense(build_dense_table(_port_specs(raw), 400), th)
    sparse = eval_sparse(build_sparse_table(_port_specs(raw), 400), th)
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), rtol=1e-6, atol=1e-7)


def _binned_raw():
    """tests/test_aux.py:143's spec, and a second one of 4 bins and 4 knots."""
    rng = np.random.default_rng(9)
    first = dict(name="s", param_index=0, x_knots=np.array([-1.0, 0.0, 1.0]),
                 y_knots=np.array([[0.8, 1.0, 1.2], [1.0, 1.0, 1.0], [1.4, 1.0, 0.6]]),
                 event_bins=np.array([0, 0, 0, 0, 1, 1, 1, 2, 2, -1]))
    second = dict(name="t", param_index=1, x_knots=np.array([-2.0, -0.5, 0.5, 2.0]),
                  y_knots=1.0 + 0.1 * rng.normal(size=(4, 4)),
                  event_bins=rng.integers(-1, 4, size=10))
    return [first, second]


def test_build_binned_table_matches_jax():
    raw = _binned_raw()
    jt = jbinned.build_binned_table([jbinned.BinnedSplineParamSpec(**r) for r in raw], 10)
    tt = build_binned_table([BinnedSplineParamSpec(**r) for r in raw], 10)
    for f in SPARSE_FIELDS:
        _eq(getattr(jt, f), getattr(tt, f))
    assert tt.n_splines == 2 + 4  # bin 1 of the first is flat and dropped
    w = eval_sparse(tt, torch.tensor([1.0, 0.3])).numpy()
    ws = eval_sparse(build_binned_table([BinnedSplineParamSpec(**raw[0])], 10),
                     torch.tensor([1.0])).numpy()
    np.testing.assert_allclose(ws[:4], 1.2, rtol=1e-6)
    np.testing.assert_array_equal(ws[4:7], 1.0)
    np.testing.assert_allclose(ws[7:9], 0.6, rtol=1e-6)
    assert ws[9] == 1.0
    want = np.asarray(jeval.eval_sparse(jt, jnp.asarray([1.0, 0.3], jnp.float32)))
    np.testing.assert_allclose(w, want, rtol=1e-6)


@pytest.fixture(scope="module")
def toys():
    return build_toy(**TOY, dense_splines=False, device="cpu"), jbuild_toy(**TOY,
                                                                           dense_splines=False)


def test_sparse_toy_tables_and_route(toys):
    port, jax_toy = toys
    for js, ts in zip(jax_toy.samples, port.model.samples):
        assert isinstance(ts.spline_table, SparseSplineTable)
        assert ts.kernel_route.variant == "xla" and ts.hist_plan_ptr is None
        for f in SPARSE_FIELDS:
            _eq(getattr(js.spline_table, f), getattr(ts.spline_table, f))


def _jittered(flat, n_chains=4, seed=0):
    chol = np.asarray(flat.chol)
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = np.asarray(flat.low_bound), np.asarray(flat.up_bound)
    th = np.asarray(flat.prefit) + 0.1 * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    th = np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
    th[0] = np.asarray(flat.prefit)
    return th


def test_sparse_toy_nll_matches_jax(toys):
    port, jax_toy = toys
    th = _jittered(jax_toy.model._flat())
    want = np.asarray(jax.jit(lambda m, t: m.total_nll_batch(t))(jax_toy.model, jnp.asarray(th)))
    got = port.model.total_nll_batch(torch.from_numpy(th)).numpy()
    assert want[1:].min() > 0.1  # the jitter moves the NLL off the Asimov minimum
    np.testing.assert_allclose(got, want, rtol=NLL_RTOL, atol=NLL_ATOL)


def test_sparse_toy_matches_dense_toy(toys):
    """The sparse toy against the dense toy on the plain route: histograms
    of the same f32 responses multiplied and summed in another order (the
    dense toy's events are laid out for K1) within 2e-6 relative (+1e-6 of
    the largest bin); NLLs, each toy against its own Asimov data, within
    the f32-oracle budget of ``test_torch_large.py``, 1e-4 + 1e-5·|NLL|."""
    dense = build_toy(**TOY, device="cpu").model
    th = torch.from_numpy(_jittered(dense.flat, seed=1))
    tables = dense._shared_osc_tables(th)
    for i, (s, d) in enumerate(zip(toys[0].model.samples, dense.samples)):
        for got, want in zip(s.reweight_batch_plain(th, tables[i]),
                             d.reweight_batch_plain(th, tables[i])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-6,
                                       atol=1e-6 * float(want.abs().max()))
    np.testing.assert_allclose(toys[0].model.total_nll_batch(th).numpy(),
                               dense.total_nll_batch(th).numpy(), rtol=1e-5, atol=1e-4)


def _tables():
    raw = _specs(seed=5)
    return {"dense": (jmono.build_dense_table(_jax_specs(raw), 400),
                      build_dense_table(_port_specs(raw), 400)),
            "dense_bf16": (jmono.build_dense_table(_jax_specs(raw), 400, low_memory=True),
                           build_dense_table(_port_specs(raw), 400, low_memory=True)),
            "sparse": (jmono.build_sparse_table(_jax_specs(raw), 400),
                       build_sparse_table(_port_specs(raw), 400))}


@pytest.mark.parametrize("kind", ["dense", "dense_bf16", "sparse"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_save_load_across_packages(tmp_path, kind, writer):
    jt, tt = _tables()[kind]
    path = str(tmp_path / "table.npz")
    if writer == "port":
        save_table(path, tt)
        back_j, back_t = jmono.load_table(path), load_table(path)
    else:
        jmono.save_table(path, jt)
        back_j, back_t = jmono.load_table(path), load_table(path)
    fields = DENSE_FIELDS if kind.startswith("dense") else SPARSE_FIELDS
    assert isinstance(back_t, DenseSplineTable if kind.startswith("dense") else SparseSplineTable)
    for f in fields:
        _eq(getattr(jt, f), getattr(back_t, f))
        _eq(getattr(back_j, f), getattr(tt, f))
        assert getattr(back_t, f).dtype == getattr(tt, f).dtype
    if kind == "dense_bf16":
        assert back_t.coeffs.dtype == torch.bfloat16
        assert "bfloat16" in str(back_j.coeffs.dtype)
