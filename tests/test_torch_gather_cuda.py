"""The gathers' backward kernel (``csrc/gather_backward.cu`` through
``mach3_tpu_torch/samples/gather.py``) on the card.

Every test here needs a CUDA device and nvcc and skips without one. The
kernel and the plain version (``index_add``, float atomics) are each held
against the plain version in f64 on the card: a slot's error over Σ|terms|
of that slot, the unit of a sum's rounding, at most ``SUM_TOL`` for the
kernel (f32 sums of at most ~10^2 group sums a block, then of the blocks'
partials) and ``PLAIN_TOL`` for the plain version (one atomic f32 sum of
up to ~36,000 terms a slot: √n ulp is ~1e-5). Shapes are beam1det's
laid-out samples at 128 chains: numu_beam 191,488 events x 3 norm columns
into 16 norm slots and into 320 oscillation slots; nue_beam 60,672 x 4 into
23 and 800; the indices are drawn from a seed (``laid_out``), with the runs
of equal slots of those samples, sorted, or at random. No jax import: the
card's machine has none.
"""
import numpy as np
import pytest
import torch

from mach3_tpu_torch.samples.gather import (
    event_gather,
    event_gather_backward_ref,
    norm_product,
    norm_product_backward_ref,
)
from mach3_tpu_torch.splines import reweight

CHAINS = 128
# (events, norm columns, norm slots, oscillation slots, runs of equal
# oscillation slots in layout order) of beam1det's two samples.
SHAPES = {"numu_beam": (191_488, 3, 16, 320, 33_081), "nue_beam": (60_672, 4, 23, 800, 59_489)}
# A norm column's mean run of equal slots in layout order (1-2 slots a warp).
NORM_RUN = 48
SUM_TOL = 1e-5
PLAIN_TOL = 1e-4
ATMO_SLOTS = 4 * 20 * 50  # an atmospheric table: 4 channels x 20 zeniths x 50 energies


def _runs(rng, e, n_slots, mean_run):
    """[E] slots in runs of equal slots, geometric lengths of mean ``mean_run``."""
    lengths = rng.geometric(1.0 / mean_run, size=e)
    starts = np.cumsum(lengths)
    n = int(np.searchsorted(starts, e)) + 1
    return np.repeat(rng.integers(0, n_slots, size=n), lengths[:n])[:e]


def laid_out(e, w, s_norm, s_osc, osc_runs, layout, seed=0):
    """(norm_idx [E, W], flat_idx [E]) int64 on the CPU. ``runs``: the norm
    columns in runs of mean ``NORM_RUN``, a third of the runs on the padding
    slot, the oscillation index in ``osc_runs`` runs (a laid-out sample);
    ``sorted``: each column sorted (one slot a warp almost everywhere);
    ``random``: no runs."""
    rng = np.random.default_rng(seed)
    if layout == "runs":
        norm = np.stack([_runs(rng, e, s_norm - 1, NORM_RUN) for _ in range(w)], 1)
        pad = np.stack([_runs(rng, e, 3, NORM_RUN) == 0 for _ in range(w)], 1)
        norm[pad] = s_norm - 1
        return torch.from_numpy(norm), torch.from_numpy(_runs(rng, e, s_osc, e / osc_runs))
    norm = rng.integers(0, s_norm - 1, size=(e, w))
    norm[rng.random((e, w)) < 1 / 3] = s_norm - 1
    flat = rng.integers(0, s_osc, size=e)
    if layout == "sorted":
        norm, flat = np.sort(norm, axis=0), np.sort(flat)
    return torch.from_numpy(norm), torch.from_numpy(flat)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the gathers' backward kernel has no CPU mode)")
    return torch.device("cuda")


def _rel_err(got, want64, scale64):
    return float(((got.double() - want64).abs() / scale64.clamp_min(1e-300)).max())


def _check_both(dev, chains, norm_idx, flat_idx, s_norm, s_osc, seed=1, nan_chain=None):
    """Both gathers' gradients through autograd against the plain version in
    f64; returns the launches and fallbacks counted."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    ext = 1.0 + 0.2 * torch.randn(chains, s_norm, device=dev, generator=gen)
    ext[:, -1] = 1.0
    zero = min(2, s_norm - 2)
    ext[min(3, chains - 1), zero] = 0.0  # a zero norm
    if nan_chain is not None:
        ext[nan_chain, 1] = float("nan")
    g = torch.randn(chains, norm_idx.shape[0], device=dev, generator=gen)
    norm_idx, flat_idx = norm_idx.to(dev), flat_idx.to(dev)
    before = dict(reweight.LAUNCHES)

    x = ext.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(norm_product(x, norm_idx), x, g)
    plain = norm_product_backward_ref(g, ext, norm_idx)
    want = norm_product_backward_ref(g.double(), ext.double(), norm_idx)
    scale = norm_product_backward_ref(g.double().abs(), ext.double().abs(), norm_idx)
    rows = torch.arange(chains, device=dev) != (-1 if nan_chain is None else nan_chain)
    assert _rel_err(got[rows], want[rows], scale[rows]) <= SUM_TOL
    assert _rel_err(plain[rows], want[rows], scale[rows]) <= PLAIN_TOL
    if nan_chain is not None:  # the NaN stays in its own chain
        assert torch.isnan(got[nan_chain]).any() and torch.isfinite(got[rows]).all()
    if (norm_idx == zero).any():
        assert got[min(3, chains - 1), zero] != 0  # the zero norm gets the others' product

    table = torch.rand(chains, s_osc, device=dev, generator=gen).requires_grad_(True)
    (got,) = torch.autograd.grad(event_gather(table, flat_idx), table, g)
    want = event_gather_backward_ref(g.double(), table.shape, torch.float64, flat_idx)
    scale = event_gather_backward_ref(g.double().abs(), table.shape, torch.float64, flat_idx)
    assert _rel_err(got, want, scale) <= SUM_TOL
    torch.cuda.synchronize()
    return {k: reweight.LAUNCHES[k] - before[k]
            for k in ("gather_backward", "gather_backward_fallback")}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["runs", "sorted", "random"])
@pytest.mark.parametrize("sample", list(SHAPES))
def test_kernel_vs_plain_at_beam1det_shapes(dev, sample, layout):
    e, w, s_norm, s_osc, osc_runs = SHAPES[sample]
    norm_idx, flat_idx = laid_out(e, w, s_norm, s_osc, osc_runs, layout)
    counted = _check_both(dev, CHAINS, norm_idx, flat_idx, s_norm, s_osc)
    assert counted == {"gather_backward": 2, "gather_backward_fallback": 0}


# Shapes at the kernel's edges: (chains, events, norm columns, norm slots,
# oscillation slots); a chain tile cut short, events not a multiple of a
# warp or of a block, every width the kernel takes, one slot everywhere.
EDGES = {
    "short_tile": (5, 3_001, 2, 7, 40),
    "ragged": (16, 2_049, 1, 3, 1),
    "width5": (8, 1_000, 5, 11, 64),
    "width8": (9, 4_133, 8, 20, 2_048),
    "one_slot": (24, 10_000, 3, 2, 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(EDGES))
def test_kernel_at_edge_shapes(dev, case):
    chains, e, w, s_norm, s_osc = EDGES[case]
    rng = np.random.default_rng(len(case))
    norm_idx = torch.from_numpy(rng.integers(0, s_norm, size=(e, w)))
    flat_idx = torch.from_numpy(rng.integers(0, s_osc, size=e))
    counted = _check_both(dev, chains, norm_idx, flat_idx, s_norm, s_osc,
                          nan_chain=1 if case == "width5" else None)
    assert counted == {"gather_backward": 2, "gather_backward_fallback": 0}


@pytest.mark.cuda
def test_atmospheric_table_takes_index_add(dev):
    """A table too wide for a block of 8 chains takes ``index_add``, chosen
    from the shape before any launch, and counts as a fallback; so does a
    backward that builds a graph (a second derivative)."""
    e = 20_000
    _, flat_idx = laid_out(e, 1, 2, ATMO_SLOTS, e, "random")
    flat_idx = flat_idx.to(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    table = torch.rand(16, ATMO_SLOTS, device=dev, generator=gen).requires_grad_(True)
    g = torch.randn(16, e, device=dev, generator=gen)
    before = dict(reweight.LAUNCHES)
    (got,) = torch.autograd.grad(event_gather(table, flat_idx), table, g)
    (want,) = torch.autograd.grad(table.index_select(1, flat_idx), table, g)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert reweight.LAUNCHES["gather_backward"] == before["gather_backward"]
    assert reweight.LAUNCHES["gather_backward_fallback"] == before["gather_backward_fallback"] + 1
    small = table[:, :320].detach().requires_grad_(True)
    idx = flat_idx % 320
    gq = g.clone().requires_grad_(True)
    (gr,) = torch.autograd.grad(event_gather(small, idx), small, gq, create_graph=True)
    assert gr.requires_grad
    assert reweight.LAUNCHES["gather_backward"] == before["gather_backward"]
    assert reweight.LAUNCHES["gather_backward_fallback"] == before["gather_backward_fallback"] + 2


@pytest.mark.cuda
def test_captured_backward_is_bit_identical(dev):
    """Both gathers' backwards captured in one CUDA graph: two replays and
    an eager call give the same bits."""
    e, w, s_norm, s_osc, osc_runs = SHAPES["nue_beam"]
    norm_idx, flat_idx = (t.to(dev) for t in laid_out(e, w, s_norm, s_osc, osc_runs, "runs",
                                                      seed=3))
    gen = torch.Generator(device=dev).manual_seed(4)
    ext = 1.0 + 0.2 * torch.randn(CHAINS, s_norm, device=dev, generator=gen)
    table = torch.rand(CHAINS, s_osc, device=dev, generator=gen)
    g1, g2 = (torch.randn(CHAINS, e, device=dev, generator=gen) for _ in range(2))

    def grads():
        with torch.enable_grad():
            x, t = ext.detach().requires_grad_(True), table.detach().requires_grad_(True)
            y = ((norm_product(x, norm_idx) * g1).sum()
                 + (event_gather(t, flat_idx) * g2).sum())
            return torch.autograd.grad(y, (x, t))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = grads()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = grads()
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([o.clone() for o in out])
    for a, b, c in zip(eager, *replays):
        assert torch.equal(a, b) and torch.equal(b, c)


def beam1det_shaped_model(dev):
    """The reference-scale fixture's two beam samples at beam1det's event
    counts (the builder's default draws select 190,828 numu and 60,000 nue
    events, 191,232 and 60,672 laid out; 43 splines; norm columns and slots
    as ``SHAPES``), as one fit on ``dev``; the atmospheric sample the
    builder makes is left out."""
    from mach3_tpu_torch.fitters.model import FitModel
    from mach3_tpu_torch.tutorial.large import build_large

    exp = build_large(n_atmo=2_000, n_splines=43, low_memory=True, device="cpu")
    assert [(s.norm_idx.shape[1], s.norm_applied.numel() + 1) for s in exp.samples[:2]] == [
        SHAPES[k][1:3] for k in SHAPES]
    return FitModel.build([exp.xsec, exp.osc], exp.samples[:2]).to(dev)


@pytest.mark.cuda
def test_beam1det_gradient_launches(dev):
    """One gradient of ``log_posterior_batch`` at 128 chains on beam1det's
    shapes: two gather backwards a sample, none by ``index_add``."""
    model = beam1det_shaped_model(dev)
    theta = model.prefit_vector().to(dev).expand(CHAINS, -1).clone()
    theta = theta + 1e-3 * torch.randn(theta.shape, dtype=theta.dtype, device=dev,
                                        generator=torch.Generator(device=dev).manual_seed(5))
    before = dict(reweight.LAUNCHES)
    th = theta.requires_grad_(True)
    (grad,) = torch.autograd.grad(model.log_posterior_batch(th).sum(), th)
    torch.cuda.synchronize()
    assert torch.isfinite(grad).all()
    got = {k: reweight.LAUNCHES[k] - before[k] for k in before}
    assert got["gather_backward"] == 4
    assert got["gather_backward_fallback"] == 0
    assert got["reweight_backward"] == 2
