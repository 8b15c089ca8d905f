"""The port's ``PolygonBinning`` (TH2Poly-class bins) vs the JAX package's.

* ``find_bins`` on random points, points on shared edges and on vertices:
  equal to JAX's, bin for bin (both test in f32 with the same operations);
  a chain batch, and a batch taken in chunks, equal to the single rows.
* A polygon-binned sample (``tests/test_polygon_binning.py:95-125`` as the
  model, with a spline table): without a shift its bins are found once (the
  shared route), with an energy scale per step and given to the per-chain
  kernel (the generic route). NLLs at prefit and at jittered points against
  JAX's (its XLA route) within the toy's budget 5e-3 + 1e-3·|NLL|
  (``test_torch_toy.py``), against JAX's f32 oracle within 1e-4 +
  1e-5·|NLL| (``test_torch_large.py``), against the port's plain route
  within 1e-6, and the bridge carries the JAX sample across with the same
  NLLs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.core.config import Config as JConfig
from mach3_tpu.fitters.model import FitModel as JFitModel
from mach3_tpu.params.parameterset import ParameterSet as JParameterSet
from mach3_tpu.params.parameterset import ParamType as JParamType
from mach3_tpu.samples import events as jevents
from mach3_tpu.samples.binning import PolygonBinning as JPolygonBinning
from mach3_tpu.samples.binning import histogram as jhistogram
from mach3_tpu.samples.sample import ShiftSpec as JShiftSpec
from mach3_tpu.splines import monolith as jmono
from mach3_tpu.splines.eval import eval_dense as jeval_dense
from mach3_tpu_torch.bridge import from_jax_model
from mach3_tpu_torch.core.config import Config
from mach3_tpu_torch.fitters.model import FitModel
from mach3_tpu_torch.params.parameterset import ParameterSet, ParamType
from mach3_tpu_torch.samples.binning import PolygonBinning
from mach3_tpu_torch.samples.events import EventData, build_sample_model, match_norm_params
from mach3_tpu_torch.samples.sample import ShiftSpec
from mach3_tpu_torch.splines.monolith import SplineParamSpec, build_dense_table
from mach3_tpu_torch.tutorial.toy import xsec_config

torch.set_num_threads(1)

SQUARES = [[(0, 0), (1, 0), (1, 1), (0, 1)], [(1, 0), (2, 0), (2, 1), (1, 1)],
           [(0, 1), (2, 1), (2, 2), (0, 2)], [(0, 0), (-1, -1), (0, -2)],
           [(2, 0), (2.5, 0.3), (3, 1.7), (2.2, 1.9)]]
# TH2Poly-style plane over (e_reco, theta_reco): triangles and quads.
PLANE = [[(0, 0), (1.5, 0), (0, 30)], [(1.5, 0), (3.0, 0), (3.0, 30), (0, 30)],
         [(0, 30), (1.0, 30), (1.2, 45), (0, 60)], [(1.0, 30), (3.0, 30), (3.0, 60), (0, 60),
                                                    (1.2, 45)]]
NLL_ATOL, NLL_RTOL = 5e-3, 1e-3


def _points(n=20000, seed=0):
    """Random points, 200 on vertices, 400 on the squares' shared edges."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.5, 3.5, n).astype(np.float32)
    y = rng.uniform(-2.5, 2.5, n).astype(np.float32)
    verts = np.concatenate([np.asarray(p, np.float32) for p in SQUARES])
    pick = rng.integers(0, len(verts), 200)
    x[:200], y[:200] = verts[pick, 0], verts[pick, 1]
    x[200:400], y[200:400] = rng.choice([0, 1, 2], 200), rng.uniform(0, 2, 200)
    y[400:600], x[400:600] = rng.choice([0, 1, 2], 200), rng.uniform(0, 2, 200)
    return np.stack([x, y])


def test_find_bins_matches_jax():
    kin = _points()
    want = np.asarray(JPolygonBinning.build(SQUARES, [0, 1]).find_bins(jnp.asarray(kin)))
    got = PolygonBinning.build(SQUARES, [0, 1]).find_bins(torch.from_numpy(kin)).numpy()
    np.testing.assert_array_equal(got, want)
    counts = np.bincount(got[:600], minlength=6)
    assert counts[:5].sum() > 300  # points on edges and vertices fall in bins


def test_find_bins_batched_and_chunked(monkeypatch):
    b = PolygonBinning.build(SQUARES, [1, 0])
    kin = torch.from_numpy(_points(n=3000, seed=1)).flip(0)
    batch = torch.stack([kin, kin * 1.01, kin - 0.3])[None]  # [1, 3, V, E]
    whole = b.find_bins(batch)
    assert whole.shape == (1, 3, 3000)
    for c in range(3):
        assert torch.equal(whole[0, c], b.find_bins(batch[0, c]))
    monkeypatch.setattr(PolygonBinning, "CHUNK_ELEMENTS", 1000)
    assert torch.equal(b.find_bins(batch), whole)


def test_build_validation_and_names():
    with pytest.raises(ValueError):
        PolygonBinning.build([[(0, 0), (1, 1)]], axis_vars=[0, 1])
    with pytest.raises(ValueError):
        PolygonBinning.build(SQUARES, axis_vars=[0])
    b = PolygonBinning.build(SQUARES, axis_vars=[0, 1])
    assert b.n_bins == 5 and b.bin_name(0) == "poly[(0,0), (1,0), (1,1), (0,1)]"
    assert b.bin_name(5) == "underflow/overflow"


def _raw(n=4000, seed=7):
    """Events and spline responses (numpy) of the polygon sample."""
    rng = np.random.default_rng(seed)
    e_reco = rng.gamma(2.0, 0.5, n).astype(np.float32)
    ev = dict(kinematics={"e_true": e_reco * 1.05, "e_reco": e_reco,
                          "theta_reco": rng.uniform(0.0, 60.0, n).astype(np.float32)},
              mode=rng.integers(0, 3, n).astype(np.int32), target=np.full(n, 12, np.int32),
              pdg=np.full(n, 14, np.int32), preosc_pdg=np.full(n, 14, np.int32),
              mc_weight=rng.uniform(0.5, 1.5, n))
    splines = []
    for p in range(4):
        ids = np.nonzero(ev["mode"] == p % 3)[0]
        y = 1.0 + 0.06 * np.array([-2.0, -1.0, 0.0, 1.0, 2.0])[None] * (
            1.0 + 0.3 * rng.normal(size=(len(ids), 1)))
        splines.append((ids, y))
    return ev, splines


def _build(pkg, shifted):
    """The polygon sample's one-sample model in ``pkg`` ("port" or "jax")."""
    ev, splines = _raw()
    if pkg == "port":
        xsec = ParameterSet.from_config(Config(xsec_config()), name="xsec")
        events, spec, table = EventData(**ev), SplineParamSpec, build_dense_table
        binning = PolygonBinning.build(PLANE, axis_vars=[1, 2])
        shift = ShiftSpec.scale(xsec.index_of("escale"), var_row=1)
        build, match, spline_type = build_sample_model, match_norm_params, ParamType.SPLINE
        norm_type = ParamType.NORM
    else:
        xsec = JParameterSet.from_config(JConfig(xsec_config()), name="xsec")
        events, spec = jevents.EventData(**ev), jmono.SplineParamSpec
        table = jmono.build_dense_table
        binning = JPolygonBinning.build(PLANE, axis_vars=[1, 2])
        shift = JShiftSpec(fn=lambda v, x, kin: x * (1.0 + v),
                           param_index=xsec.index_of("escale"), var_row=1)
        build, match, spline_type = jevents.build_sample_model, jevents.match_norm_params, \
            JParamType.SPLINE
        norm_type = JParamType.NORM
    metas = xsec.of_type(spline_type)
    specs = [spec(m.name, m.index, np.array([-2.0, -1.0, 0.0, 1.0, 2.0]), ids, y)
             for m, (ids, y) in zip(metas, splines)]
    kw = dict(var_order=["e_true", "e_reco", "theta_reco"], binning_edges=[],
              binning_vars=["e_reco", "theta_reco"], n_total_params=len(xsec),
              norm_idx=match(events, [(m, m.index) for m in xsec.of_type(norm_type)], "poly"),
              spline_table=table(specs, events.n_events), binning=binning,
              shifts=(shift,) if shifted else ())
    if pkg == "port":
        return xsec, build("poly", events, **kw, use_kernel="auto")
    return xsec, build("poly", events, **kw, use_pallas="auto")


@pytest.fixture(scope="module", params=[False, True], ids=["static", "shifted"])
def models(request):
    shifted = request.param
    xsec, sample = _build("port", shifted)
    sample.set_data(sample.asimov_data(torch.from_numpy(np.asarray(xsec.prefit))))
    port = FitModel.build([xsec], [sample])
    jx, js = _build("jax", shifted)
    jmodel = JFitModel.build([jx], [js.with_data(sample.data.numpy())])
    return shifted, port, jmodel


def _thetas(flat, n_chains=4, seed=0):
    chol = np.asarray(flat.chol)
    sig = np.sqrt(np.diag(chol @ chol.T))
    lo, hi = np.asarray(flat.low_bound), np.asarray(flat.up_bound)
    th = np.asarray(flat.prefit) + 0.3 * sig * np.random.default_rng(seed).normal(
        size=(n_chains, len(sig)))
    th = np.clip(th, lo + 1e-6 * (hi - lo), hi - 1e-6 * (hi - lo))
    th[0] = np.asarray(flat.prefit)
    return th


def test_polygon_sample_routes(models):
    shifted, port, _ = models
    s = port.samples[0]
    assert isinstance(s.binning, PolygonBinning) and s.n_bins == 4
    assert s.kernel_route.variant == ("generic" if shifted else "shared")
    assert s.bin_map is None and (s.static_bins is None) == shifted


@jax.jit
def _oracle_nll(js, thetas):
    """JAX's f32-oracle NLL [C] of the polygon sample: exact spline
    evaluation, the shift formed in f32 as the port forms it."""

    def one(theta):
        w = js.mc_weight * js._norm_weights(theta) * jeval_dense(js.spline_table, theta,
                                                                 exact=True)
        if js.static_bins is not None:
            bins = js.static_bins
        else:
            row, v = js.shifts[0].var_row, theta[js.shifts[0].param_index].astype(jnp.float32)
            bins = js.binning.find_bins(js.kin.at[row].set(js.kin[row] * (1.0 + v)))
        return js._stat_sum(*jhistogram(w, bins, js.n_bins))

    return jax.vmap(one)(thetas)


def test_polygon_nll_matches_jax_and_plain(models):
    """Against JAX production (the toy's budget) and JAX's f32 oracle (that
    of ``test_torch_large.py``, 1e-4 + 1e-5·|NLL|)."""
    shifted, port, jmodel = models
    th = _thetas(jmodel._flat())
    want = np.asarray(jax.jit(lambda m, t: m.total_nll_batch(t))(jmodel, jnp.asarray(th)))
    t = torch.from_numpy(th)
    got = port.total_nll_batch(t)
    assert want[1:].min() > 0.1  # the jitter moves the NLL off the Asimov minimum
    np.testing.assert_allclose(got.numpy(), want, rtol=NLL_RTOL, atol=NLL_ATOL)
    s = port.samples[0]
    oracle = np.asarray(_oracle_nll(jmodel.samples[0], jnp.asarray(th)))
    np.testing.assert_allclose(s.log_likelihood_batch(t).numpy(), oracle, rtol=1e-5, atol=1e-4)
    plain = s.log_likelihood_batch_plain(t)
    np.testing.assert_allclose(s.log_likelihood_batch(t).numpy(), plain.numpy(), rtol=1e-6,
                               atol=1e-6)
    bridged = from_jax_model(jmodel)
    assert bridged.samples[0].kernel_route.variant == s.kernel_route.variant
    np.testing.assert_allclose(bridged.total_nll_batch(t).numpy(), got.numpy(), rtol=1e-9,
                               atol=1e-9)
