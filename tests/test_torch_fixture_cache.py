"""The port's fixture cache (``core/fixture_cache.py``): a built experiment
round-trips through ``torch.save`` / ``torch.load`` bit for bit; a changed
source, version or builder argument misses the cache; an unreadable or
rejected entry is rebuilt; ``MACH3_FIXTURE_CACHE`` and
``MACH3_FIXTURE_CACHE_OFF`` are honoured as in the JAX package
(``mach3_tpu/core/fixture_cache.py``), with the port's entries under
``torch/``."""
import os

import pytest
import torch

from mach3_tpu_torch.core import fixture_cache as fc
from mach3_tpu_torch.tutorial.large import build_large700
from mach3_tpu_torch.tutorial.toy import build_toy

torch.set_num_threads(1)

TOY = dict(n_events=2000, seed=3, e_grid_size=20)


class Builder:
    """A builder that counts its calls."""

    def __init__(self, fn=lambda: build_toy(**TOY, device="cpu")):
        self.fn, self.calls = fn, 0

    def __call__(self):
        self.calls += 1
        return self.fn()


def _same_model(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    th = a.prefit_vector()[None].repeat(3, 1)
    th[1:, :4] += 0.05
    assert torch.equal(a.total_nll_batch(th), b.total_nll_batch(th))


def test_round_trip(tmp_path):
    build = Builder()
    first = fc.load_or_build("toy", build, cache_dir=str(tmp_path), kwargs=TOY)
    again = fc.load_or_build("toy", build, cache_dir=str(tmp_path), kwargs=TOY)
    assert build.calls == 1 and again is not first
    assert len(list(tmp_path.glob("toy-v1-*.pt"))) == 1
    _same_model(first.model, again.model)
    assert [s.kernel_route for s in first.model.samples] == \
        [s.kernel_route for s in again.model.samples]


def test_large700_round_trip_keeps_named_shifts(tmp_path):
    exp = build_large700(n_numu=600, n_nue=300, n_atmo=600, e_grid_size=20,
                         atmo_e_grid_size=8, atmo_cosz_grid_size=6, device="cpu")
    path = str(tmp_path / "l7.pt")
    fc.save_fixture(path, exp)
    back = fc.load_fixture(path, device="cpu")
    _same_model(exp.model, back.model)
    assert back.model.samples[1].shifts[0].kind == "scale"
    assert back.names == exp.names


def test_a_changed_kwarg_or_version_misses(tmp_path):
    build = Builder()
    fc.load_or_build("toy", build, cache_dir=str(tmp_path), kwargs=TOY)
    fc.load_or_build("toy", build, cache_dir=str(tmp_path), kwargs=dict(TOY, seed=4))
    fc.load_or_build("toy", build, cache_dir=str(tmp_path), kwargs=TOY, version="v2")
    assert build.calls == 3


def test_a_changed_source_misses(tmp_path, monkeypatch):
    pkg = tmp_path / "pkg"
    for d in fc.FINGERPRINT_DIRS:
        (pkg / d).mkdir(parents=True)
        (pkg / d / "a.py").write_text("x = 1\n")
    (pkg / "csrc" / "k.cu").write_text("// kernel\n")
    (pkg / "csrc" / "notes.txt").write_text("not a source\n")
    monkeypatch.setattr(fc, "PACKAGE_DIR", pkg)
    build = Builder()
    cache = str(tmp_path / "cache")
    fc.load_or_build("toy", build, cache_dir=cache)
    fc.load_or_build("toy", build, cache_dir=cache)
    assert build.calls == 1
    (pkg / "csrc" / "notes.txt").write_text("edited, still not a source\n")
    fc.load_or_build("toy", build, cache_dir=cache)
    assert build.calls == 1
    (pkg / "csrc" / "k.cu").write_text("// kernel, edited\n")
    fc.load_or_build("toy", build, cache_dir=cache)
    assert build.calls == 2
    (pkg / "samples" / "a.py").write_text("x = 2\n")
    fc.load_or_build("toy", build, cache_dir=cache)
    assert build.calls == 3


def test_an_unreadable_entry_is_rebuilt(tmp_path):
    build = Builder(lambda: {"value": torch.arange(3)})
    path = fc.entry_path("obj", cache_dir=str(tmp_path))
    os.makedirs(tmp_path, exist_ok=True)
    with open(path, "wb") as f:
        f.write(b"not a torch file")
    got = fc.load_or_build("obj", build, cache_dir=str(tmp_path))
    assert build.calls == 1 and torch.equal(got["value"], torch.arange(3))
    assert torch.equal(fc.load_fixture(path)["value"], torch.arange(3))  # overwritten
    fc.load_or_build("obj", build, cache_dir=str(tmp_path), validate=lambda o: False)
    assert build.calls == 2
    fc.load_or_build("obj", build, cache_dir=str(tmp_path), validate=lambda o: True)
    assert build.calls == 2


def test_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("MACH3_FIXTURE_CACHE", str(tmp_path / "shared"))
    assert fc.default_cache_dir() == str(tmp_path / "shared" / "torch")
    build = Builder(lambda: [1, 2])
    fc.load_or_build("obj", build)
    assert len(list((tmp_path / "shared" / "torch").glob("obj-*.pt"))) == 1
    monkeypatch.setenv("MACH3_FIXTURE_CACHE_OFF", "1")
    fc.load_or_build("obj", build)
    assert build.calls == 2
    monkeypatch.delenv("MACH3_FIXTURE_CACHE")
    assert fc.default_cache_dir().endswith(os.path.join(".fixture_cache", "torch"))


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_load_onto_a_device(tmp_path, device):
    path = str(tmp_path / "t.pt")
    fc.save_fixture(path, {"t": torch.ones(4)})
    assert fc.load_fixture(path, device=device)["t"].device.type == device
