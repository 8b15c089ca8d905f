"""Port's binning, histogram, routing, plain sample route and kernel build
plumbing vs the JAX package (all on the CPU)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mach3_tpu.samples.binning import SampleBinning as JBinning
from mach3_tpu.samples.binning import histogram as jhistogram
from mach3_tpu_torch.kernels import build
from mach3_tpu_torch.samples import routing
from mach3_tpu_torch.samples.binning import SampleBinning, histogram
from mach3_tpu_torch.splines import reweight
from mach3_tpu_torch.splines.monolith import SplineParamSpec, build_dense_table
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

EDGES = [np.array([0.0, 0.5, 1.0, 2.0]), np.array([-1.0, 0.0, 1.0]), np.linspace(0, 3, 5)]


def _kin(n=400, seed=0):
    rng = np.random.default_rng(seed)
    kin = rng.uniform(-1.5, 3.5, size=(4, n)).astype(np.float32)
    kin[1, :4] = [0.0, 0.5, 2.0, 1.0]  # exactly on edges of axis 0 (row 1)
    kin[1, 4] = np.nan
    kin[3, 5] = np.inf
    return kin


@pytest.mark.parametrize("axes", [[0], [0, 1], [0, 1, 2]], ids=["1d", "2d", "3d"])
def test_find_bins_matches_jax(axes):
    edges = [EDGES[a] for a in axes]
    rows = [1, 3, 0][: len(axes)]
    kin = _kin()
    want = np.asarray(JBinning.build(edges, rows).find_bins(jnp.asarray(kin)))
    tb = SampleBinning.build(edges, rows)
    got = tb.find_bins(torch.from_numpy(kin))
    assert np.array_equal(got.numpy(), want)
    batched = tb.find_bins(torch.from_numpy(np.stack([kin, kin[::-1].copy()])))
    assert np.array_equal(batched[0].numpy(), want)


def test_histogram_matches_jax():
    rng = np.random.default_rng(1)
    w = rng.normal(size=(3, 500)).astype(np.float32)
    bins = rng.integers(0, 13, size=(3, 500))  # 12 bins + the garbage bin
    want = jax.vmap(lambda a, b: jhistogram(a, b, 12))(jnp.asarray(w), jnp.asarray(bins))
    got = histogram(torch.from_numpy(w), torch.from_numpy(bins), 12)
    for g, j in zip(got, want):
        assert g.shape == (3, 12)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def _table(p):
    spec = SplineParamSpec("s", 0, np.array([-1.0, 0.0, 1.0]), np.arange(4), np.ones((4, 3)))
    return build_dense_table([spec] * p, 4)


@pytest.mark.parametrize("static,shift,p,bins,variant", [
    (True, False, 4, 30, "shared"),
    (False, True, 4, 30, "shifted"),
    (False, True, 4, 600, "xla"),      # past the shared-memory histogram
    (False, True, 20, 30, "shifted"),  # param-blocked (K3): not ported yet
    (False, False, 4, 30, "generic"),
    (False, False, 20, 30, "xla"),
])
def test_routing_variants(static, shift, p, bins, variant):
    route = routing.choose_kernel_route(bins, _table(p), static, shift)
    assert route.variant == variant
    assert route.use_kernel == (variant != "xla")
    assert (route.reason == f"P={p}, bins={bins}") == route.use_kernel
    assert routing.choose_kernel_route(bins, _table(p), static, shift, requested=False).variant == "xla"
    assert routing.choose_kernel_route(bins, None, static, shift).variant == "xla"


def test_plain_route_matches_kernel_route():
    """use_kernel=False (plain torch) and the shifted route give the same NLL."""
    kw = dict(n_events=800, seed=2, e_grid_size=20)
    shifted = build_toy(**kw, device="cpu").model
    plain = build_toy(**kw, use_kernel=False, device="cpu").model
    assert [s.kernel_route.variant for s in plain.samples] == ["xla", "xla"]
    th = shifted.prefit_vector()[None].repeat(4, 1)
    th[1:, 9] = torch.tensor([0.02, -0.03, 0.05])  # energy scale
    th[1:, 0] = torch.tensor([1.1, 0.0, 0.9])  # a zero norm in chain 2
    a = shifted.total_nll_batch(th)
    b = plain.total_nll_batch(th)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-4)


def test_unported_routes_raise():
    toy = build_toy(n_events=300, seed=2, e_grid_size=10, device="cpu")
    s = toy.model.samples[0]
    s.kernel_route = routing.KernelRoute(True, "sparse")  # no kernel of that name
    with pytest.raises(NotImplementedError, match="no kernel route 'sparse'"):
        s.reweight_batch(toy.model.prefit_vector()[None])


def test_missing_nvcc_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.build("reweight_shifted")
    assert build.library_path("reweight_shifted").name.startswith("libreweight_shifted_")


def test_wrapper_has_no_fallback_for_other_devices():
    args = [torch.zeros((2, 1), dtype=torch.int32, device="meta"),
            torch.zeros((2, 1), device="meta"), torch.zeros((1, 4, 3), device="meta"),
            torch.zeros((2, 3), device="meta"), torch.zeros(2, device="meta"),
            torch.zeros(3, device="meta"), torch.zeros(3, dtype=torch.int32, device="meta"),
            torch.zeros(3, device="meta")]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        reweight.fused_reweight_histogram_shifted(
            *args, n_bins=4, shift_kind="scale", stride_j=1, n_axis_j=2)
