"""The likelihood's event-sized gathers (``mach3_tpu_torch/samples/gather.py``)
on the CPU, where their backwards run the plain versions.

* ``norm_product`` equals ``take(norm_ext, 1, norm_idx).prod(-1)`` bit for
  bit, and its gradient equals native autograd's (advanced indexing and
  ``prod``) bit for bit where no factor is zero (the plain version takes
  ``prod``'s own g · Π / x), and within rtol 1e-6 / atol 1e-6 (f32
  rounding) where one is: there the other factors' product, formed from
  running products from both ends, where ``prod``'s backward has a rule of
  its own. Cases: repeated slots within an event, the padding slot, zero
  norms (one and two in an event), a NaN norm (it stays in its own chain)
  and a [4, 6, 3] product of distinct slots with and without zeros.
* ``event_gather`` equals ``index_select`` forward and backward bit for bit
  (both backwards are the same ``index_add`` here).
* ``gradcheck`` and ``gradgradcheck`` (the minimiser's Hessian runs the
  plain version twice) in f64 on tiny shapes for both.
* ``kernel_blocking``, and the wrapper's choice for a cotangent on the card
  before any launch: the kernel, the plain version for a table too wide for
  a block or under ``create_graph`` (counted as
  ``gather_backward_fallback``), an error for an f64 table or a norm wider
  than the kernel's.
"""
from types import SimpleNamespace

import pytest
import torch

from mach3_tpu_torch.core.device import take
from mach3_tpu_torch.samples import gather
from mach3_tpu_torch.samples.gather import event_gather, kernel_blocking, norm_product

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 1e-6


def _norm_case(name):
    """(norm_ext [C, S] f32, norm_idx [E, W] int64) of a case."""
    gen = torch.Generator().manual_seed(11)
    if name.startswith("distinct"):  # every factor its own slot
        c, s, e, w = 4, 6 * 3, 6, 3
        ext = torch.randn(c, s, generator=gen)
        idx = torch.arange(e * w).reshape(e, w)
        if name.endswith("zeros"):
            ext[0, 1 * 3 + 2] = ext[1, 2 * 3 + 0] = ext[1, 2 * 3 + 1] = 0.0
        return ext, idx
    c, s, e, w = 5, 9, 300, 3
    ext = 1.0 + 0.3 * torch.randn(c, s, generator=gen)
    ext[:, -1] = 1.0  # the padding slot
    idx = torch.randint(0, s - 1, (e, w), generator=gen)
    if name == "repeated":
        idx[::3, 1] = idx[::3, 0]
        idx[::5, 2] = idx[::5, 0]
    elif name == "padding":
        idx[::2, 2] = s - 1
        idx[::7, 1:] = s - 1
    elif name == "zeros":
        ext[0, 3] = 0.0
        ext[2, 3] = ext[2, 4] = 0.0
        idx[:40, 0], idx[:40, 1] = 3, 4  # two zeros in an event of chain 2
    elif name == "nan":
        ext[1, 2] = float("nan")
    return ext, idx


NORM_CASES = ["repeated", "padding", "zeros", "nan", "distinct", "distinct_zeros"]


@pytest.mark.parametrize("case", NORM_CASES)
def test_norm_product(case):
    ext, idx = _norm_case(case)
    a, b = (ext.clone().requires_grad_(True) for _ in range(2))
    got, want = norm_product(a, idx), b[:, idx].prod(-1)
    torch.testing.assert_close(got, take(ext, 1, idx).prod(-1), rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    g = torch.randn(got.shape, generator=torch.Generator().manual_seed(5))
    gg, gw = torch.autograd.grad(got, a, g)[0], torch.autograd.grad(want, b, g)[0]
    if "zeros" in case:
        # prod's backward has its own rule for a zero; ours is the other
        # factors' product there (a zero norm still gets a gradient).
        torch.testing.assert_close(gg, gw, rtol=RTOL, atol=ATOL)
        assert (gg[ext == 0] != 0).any()
    else:  # prod's own g · Π / x: native autograd's bits, NaNs included
        torch.testing.assert_close(gg, gw, rtol=0, atol=0, equal_nan=True)
    if case == "nan":  # the NaN stays in its own chain
        assert torch.isfinite(gg[torch.arange(ext.shape[0]) != 1]).all()
        assert torch.isnan(gg[1]).any()
    small = torch.nan_to_num(ext[:2, :].double(), nan=0.5)  # gradcheck wants finite values
    small[:, -1] = 1.0
    sidx = idx[:7]
    fn = lambda x: norm_product(x, sidx)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (small.requires_grad_(True),))
    assert torch.autograd.gradgradcheck(fn, (small,))  # the minimiser's Hessian


@pytest.mark.parametrize("case", ["random", "runs", "one_slot", "ragged"])
def test_event_gather(case):
    gen = torch.Generator().manual_seed(7)
    c, s, e = 6, 40, {"ragged": 1001}.get(case, 1024)
    table = torch.rand(c, s, generator=gen)
    if case == "runs":
        idx = torch.sort(torch.randint(0, s, (e,), generator=gen)).values
    elif case == "one_slot":
        idx = torch.full((e,), 7)
    else:
        idx = torch.randint(0, s, (e,), generator=gen)
    a, b = (table.clone().requires_grad_(True) for _ in range(2))
    got, want = event_gather(a, idx), b.index_select(1, idx)
    assert torch.equal(got, want)
    g = torch.randn(got.shape, generator=gen)
    assert torch.equal(torch.autograd.grad(got, a, g)[0], torch.autograd.grad(want, b, g)[0])
    sidx = idx[:33]
    fn = lambda x: event_gather(x, sidx)  # noqa: E731
    small = table[:2].double().requires_grad_(True)
    assert torch.autograd.gradcheck(fn, (small,))
    assert torch.autograd.gradgradcheck(fn, (small,))


def test_kernel_blocking():
    # beam1det's four gathers: norm tables of 16 and 23 slots, oscillation
    # tables of 320 and 800; 8 chains a block.
    assert kernel_blocking(16, True) == (8, 1024)
    assert kernel_blocking(23, True) == (8, 1024)
    assert kernel_blocking(320, False) == (8, 2048)
    assert kernel_blocking(800, False) == (8, 2048)
    assert kernel_blocking(2048, False) == (8, 2048)  # 64 KiB of sums
    assert kernel_blocking(1024, True) == (8, 1024)  # and of factors
    # An atmospheric table (NC · NZ · NE slots) is too wide: index_add.
    assert kernel_blocking(2049, False) is None
    assert kernel_blocking(4 * 20 * 50, False) is None
    assert kernel_blocking(1025, True) is None


# The wrapper's choice for a cotangent on the card, before any launch:
# (slots, table dtype, width, product, create_graph) -> the block, None (the
# plain version, counted as a fallback) or an error.
CHOICES = {
    "beam_norm": ((23, torch.float32, 4, True, False), (8, 1024)),
    "beam_osc": ((800, torch.float32, 1, False, False), (8, 2048)),
    "atmo_osc": ((4 * 20 * 50, torch.float32, 1, False, False), None),
    "create_graph": ((16, torch.float32, 3, True, True), None),
    "wide_norm": ((16, torch.float32, 9, True, False), ValueError),
    "f64_table": ((320, torch.float64, 1, False, False), ValueError),
}


@pytest.mark.parametrize("case", list(CHOICES))
def test_kernel_choice_on_the_card(case):
    (n_slots, dtype, width, product, create_graph), want = CHOICES[case]
    g = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32)  # a card's cotangent
    before = gather.LAUNCHES["gather_backward_fallback"]
    try:
        with torch.set_grad_enabled(create_graph):
            if want is ValueError:
                with pytest.raises(ValueError):
                    gather._takes_kernel(g, n_slots, dtype, width, product)
                got = "raised"
            elif gather._graph_wanted(g):
                got = None
            else:
                got = gather._takes_kernel(g, n_slots, dtype, width, product)
        assert got == ("raised" if want is ValueError else want)
        # the plain version on the card is counted; an error or a launch is not
        counted = gather.LAUNCHES["gather_backward_fallback"] - before
        assert counted == (1 if want is None else 0)
    finally:
        gather.LAUNCHES["gather_backward_fallback"] = before
    # On the CPU every call takes the plain version, uncounted.
    cpu = SimpleNamespace(device=torch.device("cpu"), dtype=torch.float32)
    assert gather._takes_kernel(cpu, n_slots, dtype, width, product) is None
    assert gather.LAUNCHES["gather_backward_fallback"] == before
