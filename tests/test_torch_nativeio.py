"""The port's native event IO (``core/nativeio.py``), its MC files in the
experiment builder, and the experiment registry, against the JAX package's.

* ``.m3evt``: written by one package and read by the other, both ways, every
  column bit-identical (the JAX package's reader and writer here are its
  numpy ones: its native library builds into ``native/``, which nothing
  here writes into).
* ``parse_csv`` against JAX's, f64 exact; the port's native library against
  its numpy readers.
* The library is built from ``native/m3io.cpp`` into the package's
  ``_build/``.
* ``build_experiment`` from ``.m3evt`` and from ``.csv`` MC equals the
  ``.npz`` build: every buffer and the Asimov histograms, bit for bit.
* ``registry.build_experiment("toy")`` builds the toy.
"""
import numpy as np
import pytest
import torch

from mach3_tpu.core import nativeio as jnativeio
from mach3_tpu_torch.core import nativeio
from mach3_tpu_torch.core.config import Config
from mach3_tpu_torch.core.exceptions import ConfigError
from mach3_tpu_torch.samples import registry
from mach3_tpu_torch.samples.experiment import build_experiment
from mach3_tpu_torch.tutorial.experiment_files import convert_mc_files, write_experiment

torch.set_num_threads(1)


@pytest.fixture
def jax_numpy_io(monkeypatch):
    """The JAX module with its library marked unavailable: its numpy reader
    and writer (the same format), and no build into ``native/``."""
    monkeypatch.setattr(jnativeio, "_lib", None)
    monkeypatch.setattr(jnativeio, "_lib_tried", True)
    return jnativeio


def _columns(n=1000, seed=0):
    rng = np.random.default_rng(seed)
    return {"e_reco": rng.gamma(2.0, 0.5, n), "theta": rng.uniform(0, 60, n).astype(np.float32),
            "mode": rng.integers(0, 4, n).astype(np.int32),
            "weight": rng.normal(size=n), "x_long_name_" * 4: rng.normal(size=n)}


def _same(a, b):
    assert list(a) == [k[:63] for k in b]
    for (ka, va), vb in zip(a.items(), b.values()):
        assert va.dtype == vb.dtype and np.array_equal(va, vb), ka


def test_library_builds_into_the_package():
    lib = nativeio.load_library(required=True)
    path = nativeio.library_path()
    assert lib is not None and path.is_file()
    assert path.parent == nativeio.BUILD_DIR and path.parent.parent.name == "mach3_tpu_torch"
    assert nativeio.SOURCE.name == "m3io.cpp" and nativeio.SOURCE.parent.name == "native"


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_m3evt_across_packages(tmp_path, jax_numpy_io, writer):
    cols = _columns()
    path = str(tmp_path / "ev.m3evt")
    (nativeio if writer == "port" else jax_numpy_io).write_events(path, cols)
    before = nativeio.READS["native"]
    _same(nativeio.read_events(path), cols)
    assert nativeio.READS["native"] == before + 1
    _same(jax_numpy_io.read_events(path), cols)


def test_native_and_numpy_readers_agree(tmp_path):
    cols = _columns(n=3001, seed=1)
    path = str(tmp_path / "ev.m3evt")
    nativeio.write_events(path, cols)
    _same(nativeio.read_events(path, n_threads=3), nativeio.read_events_numpy(path))
    with pytest.raises(ValueError):
        nativeio.write_events(path, {"a": np.zeros(3, np.int64)})
    with pytest.raises(ValueError):
        nativeio.write_events(path, {"a": np.zeros(3), "b": np.zeros(4)})


def test_numpy_readers_when_the_library_is_unavailable(tmp_path, monkeypatch):
    monkeypatch.setattr(nativeio, "_lib", None)
    monkeypatch.setattr(nativeio, "_lib_tried", True)
    cols = _columns(n=50, seed=2)
    path = str(tmp_path / "ev.m3evt")
    nativeio.write_events(path, cols)
    before = dict(nativeio.READS)
    _same(nativeio.read_events(path), cols)
    assert nativeio.READS == {"native": before["native"], "numpy": before["numpy"] + 1}


def _write_csv(path, cols):
    table = np.stack([np.asarray(v, np.float64) for v in cols.values()], axis=1)
    np.savetxt(path, table, fmt="%.17g", delimiter=",", header=",".join(cols), comments="")


@pytest.mark.parametrize("n_threads", [1, 4])
def test_parse_csv_matches_jax(tmp_path, jax_numpy_io, n_threads):
    cols = _columns(n=777, seed=3)
    path = str(tmp_path / "ev.csv")
    _write_csv(path, cols)
    names = list(cols)
    got = nativeio.parse_csv(path, names, n_threads=n_threads)
    want = jax_numpy_io.parse_csv(path, names)
    assert list(got) == names
    for k in names:
        assert got[k].dtype == np.float64
        np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got[k], np.asarray(cols[k], np.float64))
    np.testing.assert_array_equal(nativeio.parse_csv_numpy(path, names)["weight"], got["weight"])


@pytest.fixture(scope="module")
def experiment_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("exp")
    y = write_experiment(d, n_events=3000, seed=4)
    return y, {fmt: convert_mc_files(y, fmt) for fmt in ("m3evt", "csv")}


@pytest.mark.parametrize("fmt", ["m3evt", "csv"])
def test_experiment_from_native_files_equals_npz(experiment_files, fmt):
    y, converted = experiment_files
    base = build_experiment(Config.from_file(str(y)), device="cpu").model
    before = nativeio.READS["native"]
    other = build_experiment(Config.from_file(str(converted[fmt])), device="cpu").model
    assert nativeio.READS["native"] == before + len(base.samples)
    for a, b in zip(base.samples, other.samples):
        sa, sb = a.state_dict(), b.state_dict()
        assert sa.keys() == sb.keys()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), (a.name, k)
        assert a.kernel_route == b.kernel_route
    th = base.prefit_vector()[None]
    assert torch.equal(base.total_nll_batch(th), other.total_nll_batch(th))


def test_unknown_mc_format_raises(tmp_path):
    from mach3_tpu_torch.samples.experiment import _load_columns

    with pytest.raises(ConfigError):
        _load_columns(str(tmp_path / "mc.root"))
    with pytest.raises(ValueError):
        convert_mc_files(tmp_path / "experiment.yaml", "root")


def test_registry_builds_the_toy():
    assert "toy" in registry.list_experiments()
    exp = registry.build_experiment("toy", n_events=2000, seed=3, e_grid_size=20, device="cpu")
    assert [s.name for s in exp.samples] == ["numu_sample", "nue_sample"]
    assert abs(float(exp.model.total_nll_batch(exp.model.prefit_vector()[None])[0])) < 1e-6
    with pytest.raises(ConfigError):
        registry.build_experiment("no_such_experiment")
    with pytest.raises(ConfigError):
        registry.register_experiment("toy")(lambda **kw: None)


def test_registry_registers_a_builder(monkeypatch):
    monkeypatch.setattr(registry, "_REGISTRY", dict(registry._REGISTRY))

    @registry.register_experiment("mine")
    def build(**kw):
        return kw

    assert registry.build_experiment("mine", a=1) == {"a": 1}
    assert registry.list_experiments() == ["mine", "toy"]
