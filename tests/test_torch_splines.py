"""Port's spline segment search, dense table and f32 evaluation vs the JAX package.

Tolerances: the port evaluates responses in f32 by Horner steps; JAX's
``eval_dense(exact=True)`` contracts the same polynomial as a power sum in
f32. Both round a handful of O(1) terms, so a product of P=3 responses
agrees to a few f32 ulps (rtol 1e-5). JAX's production ``eval_dense`` rounds
the selector powers (t, t², t³) and the deviations (co − I) to bf16 (2^-9
relative each); on these steep test splines single responses then differ by
up to ~0.7% at |θ| ~ 1σ and ~1.6% when extrapolating at 4σ, so the
per-event budget is rtol 2e-2 (the histogram-level budget, where events
average, is in test_torch_reweight.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.params.parameterset import SplineInterpolation as JInterp
from mach3_tpu.splines import eval as jeval
from mach3_tpu.splines import monolith as jmono
from mach3_tpu_torch.params.parameterset import SplineInterpolation as TInterp
from mach3_tpu_torch.splines import eval as teval
from mach3_tpu_torch.splines import monolith as tmono

torch.set_num_threads(1)

INTERPS = ["TSpline3", "Monotonic", "Akima", "Linear", "KochanekBartels"]


def _specs(pkg, interps, n_events=150, seed=0):
    rng = np.random.default_rng(seed)
    mono = jmono if pkg == "jax" else tmono
    enum = JInterp if pkg == "jax" else TInterp
    specs = []
    for p, interp in enumerate(interps):
        k = 5 if p % 2 == 0 else 4  # mixed knot counts exercise the +inf padding
        x = np.array([-3.0, -1.0, 0.0, 1.0, 3.0])[:k]
        ev = np.sort(rng.choice(n_events, size=n_events // 2, replace=False))
        y = np.clip(1.0 + 0.1 * rng.normal(size=(len(ev), k)).cumsum(axis=1), 0.0, None)
        specs.append(mono.SplineParamSpec(
            name=f"p{p}", param_index=2 * p + 1, x_knots=x, event_ids=ev, y_knots=y,
            interpolation=enum(interp), knot_low=0.0, knot_high=9.0,
        ))
    return specs


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("low_memory", [False, True], ids=["f32", "bf16"])
def test_dense_table_matches_jax(interp, low_memory):
    jt = jmono.build_dense_table(_specs("jax", [interp, interp]), 150, low_memory=low_memory)
    tt = tmono.build_dense_table(_specs("torch", [interp, interp]), 150, low_memory=low_memory)
    assert np.array_equal(np.asarray(jt.coeffs, np.float32), tt.coeffs.float().numpy())
    assert np.array_equal(np.asarray(jt.knots_x), tt.knots_x.numpy())
    assert np.array_equal(np.asarray(jt.n_knots), tt.n_knots.numpy())
    assert np.array_equal(np.asarray(jt.param_index), tt.param_index.numpy())


def test_find_segments_matches_jax():
    knots = np.full((3, 5), np.inf, np.float32)
    knots[0] = [-3, -1, 0, 1, 3]
    knots[1, :4] = [-2, -1, 1, 2]
    knots[2, :3] = [0, 0.5, 1]
    n_knots = np.array([5, 4, 3])
    vals = np.array([
        [-5.0, -1.0, 0.25],   # below the first knot, exactly on a knot
        [0.0, 2.0, 1.0],      # on knots, on the last knot
        [3.5, 7.0, -0.1],     # above the last knot
        [0.3, -1.5, np.nan],  # NaN value
    ], np.float32)
    js, jt = jax.vmap(lambda v: jeval.find_segments(jnp.asarray(knots), jnp.asarray(n_knots), v))(
        jnp.asarray(vals)
    )
    ts, tt = teval.find_segments(torch.from_numpy(knots), torch.from_numpy(n_knots),
                                 torch.from_numpy(vals))
    assert ts.dtype == torch.int32 and tt.dtype == torch.float32
    assert np.array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jt), tt.numpy())


@pytest.mark.parametrize("exact", [True, False], ids=["oracle", "production"])
def test_eval_dense_matches_jax(exact):
    interps = ["TSpline3", "Akima", "Monotonic"]
    jt = jmono.build_dense_table(_specs("jax", interps), 150)
    tt = tmono.build_dense_table(_specs("torch", interps), 150)
    rng = np.random.default_rng(1)
    params = rng.normal(scale=1.5 if exact else 1.0, size=(6, 7))
    params[0] = 0.0
    params[1, [1, 3, 5]] = [-4.0, 3.0, 1.0]  # extrapolation and a knot
    want = np.asarray(jax.vmap(lambda p: jeval.eval_dense(jt, p, exact=exact))(jnp.asarray(params)))
    got = teval.eval_dense(tt, torch.from_numpy(params)).numpy()
    assert got.shape == (6, 150) and got.dtype == np.float32
    rtol = 1e-5 if exact else 2e-2
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    one = teval.eval_dense(tt, torch.from_numpy(params[2])).numpy()
    np.testing.assert_array_equal(one, got[2])
