"""On the card (marked ``cuda``; skips without one): the control, the
reference one step below the configuration's precision put in the
program's place, comes out as not correct, and the program as correct, on
three seeds of the small copy's cells. The cells' own sizes are run by
``python3 -m m3bench --control 1`` (``PERF.md`` gives the readings)."""
from __future__ import annotations

import pytest
import torch

import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bench")
    tiny.make_copy(tmp)
    return tmp


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3_000_000_011, 3_000_000_012, 3_000_000_013])
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_control_fails_where_the_program_passes(card, copy, cell, seed):
    rc, res, err = tiny.run_cell(copy, cell, seed, control=1, cuda=True)
    assert rc == 0, err
    assert res["correct"] is False, res["checks"]
    rc, res, err = tiny.run_cell(copy, cell, seed, cuda=True)
    assert rc == 0, err
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
