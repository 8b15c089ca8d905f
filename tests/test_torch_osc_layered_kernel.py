"""The layered-matter oscillation kernel (``csrc/osc_layered.cu`` through
``mach3_tpu_torch/osc/layered.py``) and its dispatch in
``AtmoOscConfig.prob_grids``.

On the CPU: the layer arrays the kernel reads (the configuration's
lengths and density indices [(H,) NZ, NL]) against the benchmark
reference's ``prem_paths``, on large700's zenith grid and on chords whose
impact parameter lies 1e-6 km inside and outside each shell, from one
production height and from three; ``osc_layer_products`` against the
products the plain path makes; a CPU call takes the plain path and counts
neither a launch nor a fallback; the wrapper raises on what the kernel does
not take.

On the card (``cuda``; skipped without one): the kernel against the plain
path on the card and against ``m3bench/reference``'s ``layered``
(neutrinos and antineutrinos, δCP away from 0, every path length of
large700's grid, a leading production-height axis, a CUDA graph's capture
and replays); a gradient call and a float64 call take the plain path and
count ``osc_layered_fallback`` once each, their values and gradients those
of the plain path; an MR2T2 step of a small copy of large700, as CUDA
graphs, launches the kernel once and falls back never. No jax import: the
card's machine has none.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from m3bench.fixtures import osc_tree
from m3bench.reference import osc as ref_osc
from m3bench.reference.params import read
from mach3_tpu_torch.core import tracing
from mach3_tpu_torch.osc import layered, prem, prob
from mach3_tpu_torch.samples.events import EventData, build_atmo_osc_config
from mach3_tpu_torch.splines import reweight

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
#: large700's atmospheric grid (``m3bench/configs/large700.py``).
ENERGIES = np.geomspace(0.5, 100.0, 50)
GRID = np.linspace(-0.99, 0.99, 20)
#: Its paths' layer counts, down-going (air alone) to the core's.
GRID_LAYERS = {1, 2, 4, 6, 8, 10}
HEIGHTS = (10.0, 15.0, 25.0)
HEIGHT_WEIGHTS = (0.25, 0.5, 0.25)
#: The plain path's gap to the reference in float32 matrix work
#: (``test_torch_prem_reference.py``'s ATOL_F32; measured 1.1e-5 there).
ATOL_REF = 5e-5
#: Kernel against the plain path on the card: the same float32 matrix work
#: and float64 phases, rounded in another order (unrolled products in place
#: of cuBLAS's, fused multiply-adds, an f64 Cardano in place of the Newton
#: polish).
ATOL_PLAIN = 2e-5
#: float64 throughout (the f64 wrapper): the reference's own precision.
ATOL_F64 = 1e-10
#: A gradient through the plain path against another of its runs, per
#: parameter over the largest |gradient| of that parameter.
GRAD_ATOL = 1e-3
KEYS = ("osc_layered", "osc_layered_fallback")


def _boundary_zeniths(r_det=ref_osc.EARTH_RADIUS_KM):
    b = np.array([s[0] + d for s in ref_osc.PREM for d in (-1e-6, 1e-6) if s[0] + d < r_det])
    return -np.sqrt(1.0 - (b / r_det) ** 2)


ZENITHS = np.concatenate([GRID, [-1.0, np.nextafter(0.0, -1.0), -1e-4], _boundary_zeniths()])


def _config(heights, dtype=torch.float32, cosz=ZENITHS):
    """An ``AtmoOscConfig`` as a configuration builds it, θ's first six
    entries its oscillation parameters; ``heights`` None for 15 km alone."""
    n = 4
    ev = EventData(kinematics={"e_true": np.full(n, 5.0), "cos_zenith": np.full(n, -0.5)},
                   mode=np.zeros(n, np.int32), target=np.full(n, 12, np.int32),
                   pdg=np.full(n, 14, np.int32), preosc_pdg=np.full(n, 14, np.int32),
                   mc_weight=np.ones(n))
    kw = {} if heights is None else dict(production_heights=heights,
                                         height_weights=HEIGHT_WEIGHTS)
    return build_atmo_osc_config(ev, ENERGIES, cosz, list(range(6)), dtype=dtype, **kw)


def _thetas(n, seed=5):
    """Oscillation parameters from their priors (Gaussian about the prefit
    point; sin²θ23 and δCP uniform inside their bounds)."""
    p = read([osc_tree()])
    rng = np.random.default_rng(seed)
    th = np.where(p.flat, rng.uniform(p.low, p.high, (n, 6)),
                  p.prefit + p.error * rng.normal(size=(n, 6)))
    th = np.clip(th, p.low, p.high)
    assert (np.abs(th[:, 3]) > 0.01).all()  # δCP away from 0
    return th


def _reference(th, heights):
    """[2, C, NZ, NE, 3, 3] float64: the reference's grids, height-averaged."""
    hs, ws = ((prem.PRODUCTION_HEIGHT_KM,), (1.0,)) if heights is None else (heights,
                                                                             HEIGHT_WEIGHTS)
    out = 0.0
    for h, w in zip(hs, ws):
        paths = ref_osc.prem_paths(ZENITHS, h)
        out = out + w * torch.stack([ref_osc.layered(torch.from_numpy(th),
                                                     torch.from_numpy(ENERGIES), paths, anti)
                                     for anti in (False, True)])
    return out


def _launches():
    return {k: reweight.LAUNCHES[k] for k in KEYS}


def _seen(before):
    return {k: reweight.LAUNCHES[k] - before[k] for k in KEYS}


# On the CPU -------------------------------------------------------------------


@pytest.mark.parametrize("heights", [None, HEIGHTS], ids=["15km", "three_heights"])
def test_the_kernels_paths_equal_the_reference(heights):
    """The layer arrays the kernel reads as they are (lengths and
    unique-density indices [(H,) NZ, NL]): each path the reference's, its
    zero-length padding after its layers."""
    cfg = _config(heights)
    lengths, idx = cfg.layer_lengths, cfg.rho_idx
    n_h = 1 if heights is None else len(heights)
    shape = (len(ZENITHS), lengths.shape[-1]) if heights is None else (
        n_h, len(ZENITHS), lengths.shape[-1])
    assert lengths.shape == idx.shape == shape
    assert lengths.dtype == torch.float64 and idx.dtype == torch.int64
    assert lengths.is_contiguous() and idx.is_contiguous()
    assert ((idx >= 0) & (idx < cfg.rho_unique.numel())).all()
    lengths, idx = lengths.reshape(n_h, *shape[-2:]), idx.reshape(n_h, *shape[-2:])
    counts = []
    for h, height in enumerate((prem.PRODUCTION_HEIGHT_KM,) if heights is None else heights):
        for z, (want_l, want_yr) in enumerate(ref_osc.prem_paths(ZENITHS, height)):
            keep = [j for j, x in enumerate(want_l) if x > 0]
            want_l, want_yr = np.take(want_l, keep), np.take(want_yr, keep)
            n = len(want_l)
            assert (lengths[h, z, :n] > 0).all() and (lengths[h, z, n:] == 0).all()
            np.testing.assert_allclose(lengths[h, z, :n].numpy(), want_l, rtol=0, atol=1e-9)
            # the configuration's densities fold Ye in as ρ·Ye/0.5
            got_yr = 0.5 * cfg.rho_unique[idx[h, z, :n]].numpy()
            np.testing.assert_allclose(got_yr, want_yr, rtol=0, atol=1e-12)
            counts.append((h, z, n))
    grid_layers = {n for h, z, n in counts if h == n_h // 2 and z < len(GRID)}
    assert grid_layers == GRID_LAYERS  # 15 km: large700's paths


@pytest.mark.parametrize("heights", [None, HEIGHTS], ids=["15km", "three_heights"])
def test_layer_products_equal_the_plain_paths_count(heights):
    """Both paths count ``osc_layer_products`` as the plain path multiplies:
    per chain, energy, neutrino or antineutrino and production height, one
    product a layer after the first of the zenith's group, whose layer count
    is the zenith's most over the heights (from the reference's paths)."""
    cfg = _config(heights)
    hs = (prem.PRODUCTION_HEIGHT_KM,) if heights is None else heights
    n_layers = np.max([[sum(x > 0 for x in want_l) for want_l, _ in ref_osc.prem_paths(ZENITHS, h)]
                       for h in hs], 0)
    products = len(hs) * int((np.maximum(n_layers, 1) - 1).sum())
    th = torch.from_numpy(_thetas(3))
    before = dict(tracing.PROGRAM)
    cfg.prob_grids(th)
    seen = {k: tracing.PROGRAM.get(k, 0) - before.get(k, 0) for k in tracing.DEVICE_WORK}
    assert seen == {"osc_layered_grids": 1,
                    "osc_layer_products": 2 * 3 * len(ENERGIES) * products}
    assert prob.layer_products(cfg.layer_lengths.shape[:-1], cfg.layer_lengths.shape[-1],
                               cfg.z_groups) == products


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_a_cpu_call_takes_the_plain_path(grad):
    cfg = _config(None)
    th = torch.from_numpy(_thetas(4)).requires_grad_(grad)
    before = _launches()
    with torch.set_grad_enabled(grad):
        got = cfg.prob_grids(th)
    assert _seen(before) == {k: 0 for k in KEYS}
    assert got[0].requires_grad == grad
    pars = prob.OscParams.from_array(th)
    for anti, g in zip((False, True), got):
        want = prob.probabilities_layered(
            pars, cfg.e_grid, cfg.layer_lengths, cfg.layer_rho, antineutrino=anti,
            dtype=torch.float32, rho_unique=cfg.rho_unique, rho_idx=cfg.rho_idx,
            z_groups=cfg.z_groups, z_order=cfg.z_order, z_inverse=cfg.z_inverse)
        assert torch.equal(g, want)
    assert not layered.kernel_takes(th, torch.float32)
    layered.count_fallback(th)
    assert _seen(before) == {k: 0 for k in KEYS}


def test_the_wrapper_raises_on_what_the_kernel_does_not_take():
    cfg = _config(None)
    pars = prob.OscParams.from_array(torch.from_numpy(_thetas(2)))
    e, lengths, idx, rho = cfg.e_grid, cfg.layer_lengths, cfg.rho_idx, cfg.rho_unique
    with pytest.raises(ValueError, match="device cpu"):
        layered.layered_grids(pars, e, lengths, idx, rho)
    with pytest.raises(ValueError, match="density indices"):
        layered.layered_grids(pars, e, lengths, idx.int(), rho)
    with pytest.raises(ValueError, match="not contiguous"):
        layered.layered_grids(pars, e, lengths.mT.contiguous().mT, idx, rho)
    with pytest.raises(ValueError, match="paths"):
        layered.layered_grids(pars, e, lengths[None, None], idx[None, None], rho)
    with pytest.raises(ValueError, match="device meta"):
        layered.kernel_takes(torch.empty(2, device="meta"), torch.float32)


# On the card -------------------------------------------------------------------


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the layered oscillation kernel has no "
                    "CPU mode)")
    return torch.device("cuda")


def _plain_on(cfg, th):
    """The plain path's grids of ``cfg`` (on its device), height-averaged."""
    pars = prob.OscParams.from_array(th)
    grids = [prob.probabilities_layered(
        pars, cfg.e_grid, cfg.layer_lengths, cfg.layer_rho, antineutrino=anti,
        dtype=cfg.dtype, rho_unique=cfg.rho_unique, rho_idx=cfg.rho_idx,
        z_groups=cfg.z_groups, z_order=cfg.z_order, z_inverse=cfg.z_inverse)
        for anti in (False, True)]
    if cfg.height_weights is not None:
        w = cfg.height_weights.to(grids[0].dtype)
        grids = [(w[:, None, None, None, None] * p).sum(1) for p in grids]
    return torch.stack(grids)


@pytest.mark.cuda
@pytest.mark.parametrize("heights", [None, HEIGHTS], ids=["15km", "three_heights"])
def test_kernel_vs_plain_and_reference(dev, heights):
    th = _thetas(64)
    cfg = _config(heights).to(dev)
    theta = torch.from_numpy(th).to(dev)
    before = _launches()
    with torch.no_grad():
        got = torch.stack(cfg.prob_grids(theta))
        plain = _plain_on(cfg, theta)
    torch.cuda.synchronize()
    assert _seen(before) == {"osc_layered": 1, "osc_layered_fallback": 0}
    assert got.shape == plain.shape == (2, 64, len(ZENITHS), len(ENERGIES), 3, 3)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    gap = float((got - plain).abs().max())
    assert gap <= ATOL_PLAIN, gap
    want = _reference(th, heights).numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=0, atol=ATOL_REF)


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph(dev):
    cfg = _config(None).to(dev)
    theta = torch.from_numpy(_thetas(32, seed=6)).to(dev)
    with torch.no_grad():
        eager = torch.stack(cfg.prob_grids(theta))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            cfg.prob_grids(theta)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _launches()
        with torch.cuda.graph(graph):
            out = cfg.prob_grids(theta)
        assert _seen(before) == {"osc_layered": 1, "osc_layered_fallback": 0}
        replays = []
        for shift in (0.0, 1e-3):
            theta.add_(shift)
            graph.replay()
            torch.cuda.synchronize()
            replays.append(torch.stack(out).clone())
        assert torch.equal(replays[0], eager)
        assert torch.equal(replays[1], torch.stack(cfg.prob_grids(theta)))
        assert not torch.equal(replays[1], replays[0])


@pytest.mark.cuda
def test_gradient_and_f64_calls_take_the_plain_path(dev):
    th = _thetas(8, seed=7)
    cfg = _config(None).to(dev)
    theta = torch.from_numpy(th).to(dev).requires_grad_(True)
    weights = torch.rand((2, 8, len(ZENITHS), len(ENERGIES), 3, 3), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))

    before = _launches()
    got = torch.stack(cfg.prob_grids(theta))
    assert _seen(before) == {"osc_layered": 0, "osc_layered_fallback": 1}
    (grad,) = torch.autograd.grad((got * weights).sum(), theta)
    before = _launches()
    want = _plain_on(cfg, theta)
    (want_grad,) = torch.autograd.grad((want * weights).sum(), theta)
    assert _seen(before) == {k: 0 for k in KEYS}
    assert torch.equal(got, want)
    # the plain path's backward sums by float32 index_add (atomics, in no
    # fixed order): two of its own runs differ by ~1e-5 of a column's scale
    scale = want_grad.abs().amax(0)
    assert ((grad - want_grad).abs() <= GRAD_ATOL * scale).all()

    pars = prob.OscParams.from_array(torch.from_numpy(th).to(dev))
    before = _launches()
    with torch.no_grad():
        f64 = torch.stack([prem.atmospheric_probabilities(pars, ENERGIES, ZENITHS,
                                                          antineutrino=anti)
                           for anti in (False, True)])
    assert _seen(before) == {"osc_layered": 0, "osc_layered_fallback": 2}
    np.testing.assert_allclose(f64.cpu().numpy(), _reference(th, None).numpy(), rtol=0,
                               atol=ATOL_F64)

    cfg64 = _config(None, dtype=torch.float64).to(dev)
    before = _launches()
    with torch.no_grad():
        got64 = torch.stack(cfg64.prob_grids(theta.detach()))
        want64 = _plain_on(cfg64, theta.detach())
    assert _seen(before) == {"osc_layered": 0, "osc_layered_fallback": 1}
    assert torch.equal(got64, want64)


@pytest.mark.cuda
def test_an_mr2t2_step_launches_the_kernel_once(dev):
    """large700's inputs at the benchmark test's small size (three
    atmospheric samples sharing one grid), MR2T2 as CUDA graphs: one launch a
    step, no fallback."""
    from m3bench import port
    from m3bench.reference.likelihood import Reference, spline_tables
    from m3bench.run import _load
    from mach3_tpu_torch.fitters.mcmc import MR2T2, MCMCConfig

    spec = json.loads((REPO / "m3bench/configs/large700.json").read_text())
    spec.update(n_numu=1500, n_nue=500, n_atmo=1500, n_beam_generated=4000)
    inputs = _load(REPO / "m3bench/configs/large700.py", "prem_large700").build(spec,
                                                                               2_200_000_017)
    params = read(inputs.trees)
    inputs.data = Reference(inputs, "cpu", spline_tables(inputs)).asimov(
        torch.as_tensor(params.prefit))
    model = port.build_model(inputs, dev)
    init = np.tile(params.prefit, (16, 1))
    fit = MR2T2(model, MCMCConfig(chunk_size=5), init, seed=1)
    fit.run(n_steps=5, collect=False)  # the warm-up step and the capture
    before = _launches()
    fit.run(n_steps=10, collect=False)
    torch.cuda.synchronize()
    assert fit._graph is not None
    assert _seen(before) == {"osc_layered": 10, "osc_layered_fallback": 0}
