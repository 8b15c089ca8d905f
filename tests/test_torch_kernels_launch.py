"""The kernels' launch seam (``mach3_tpu_torch/kernels/launch.py``) on the
CPU, with a stand-in for the ctypes library: how each argument passes to C,
the stream appended last, a failed launch raised and not counted, a
launch counted under its entry or its ``count=`` key, and the registry's
keys against the ``extern "C"`` entries of ``csrc/*.cu``."""
import contextlib
import ctypes
import re
import types

import pytest
import torch

from mach3_tpu_torch.kernels import build, launch

torch.set_num_threads(1)

STREAM = 0x7F00AB


class FakeLibrary:
    """A library whose entries record their arguments and return ``rc``."""

    def __init__(self, rc=0):
        self.calls = []
        self.rc = rc
        # a function attribute, as a ctypes entry is, whose restype can be set
        self.m3_error_string = lambda rc: f"fake error {rc}".encode()

    def __getattr__(self, name):
        if not name.startswith("m3_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append((name, args))
            return self.rc

        return entry


@pytest.fixture()
def fake(monkeypatch):
    lib = FakeLibrary()
    monkeypatch.setattr(launch, "load_library", lambda stem: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: types.SimpleNamespace(cuda_stream=STREAM))
    return lib


def test_arguments_pass_as_their_c_types_and_the_stream_comes_last(fake):
    x = torch.arange(6, dtype=torch.float32)
    desc = (ctypes.c_int * 3)(1, 2, 3)
    launch.launch("reweight_shifted", "reweight_shifted", x.device, x, None, 7, True, desc,
                  count="reweight_shifted")
    (name, args), = fake.calls
    assert name == "m3_reweight_shifted" and len(args) == 6
    ptr, null, n, flag, passed, stream = args
    assert isinstance(ptr, ctypes.c_void_p) and ptr.value == x.data_ptr()
    assert isinstance(null, ctypes.c_void_p) and null.value is None
    assert isinstance(n, ctypes.c_int) and n.value == 7
    assert isinstance(flag, ctypes.c_int) and flag.value == 1
    assert passed is desc
    assert isinstance(stream, ctypes.c_void_p) and stream.value == STREAM
    with pytest.raises(TypeError, match="float"):
        launch.launch("reweight_shifted", "reweight_shifted", x.device, 1.5)
    with pytest.raises(ValueError, match="C int"):
        launch.launch("reweight_shifted", "reweight_shifted", x.device, 2**31)
    assert len(fake.calls) == 1  # a refused argument launches nothing


def test_a_failed_launch_raises_and_counts_nothing(fake):
    fake.rc = 98
    before = dict(launch.LAUNCHES)
    with pytest.raises(RuntimeError,
                       match=re.escape("gather_backward kernel launch failed: fake error 98 (98)")):
        launch.launch("gather_backward", "gather_backward", torch.device("cpu"), 1)
    assert dict(launch.LAUNCHES) == before


@pytest.mark.parametrize("entry,count,key", [
    ("osc_layered", None, "osc_layered"),
    ("reweight_perchain_det", "reweight_perchain_blockdiag", "reweight_perchain_blockdiag"),
])
def test_a_launch_counts_once_under_its_key(fake, entry, count, key):
    before = dict(launch.LAUNCHES)
    launch.launch("reweight_shifted", entry, torch.device("cpu"), 1, count=count)
    after = dict(launch.LAUNCHES)
    assert {k: after[k] - before[k] for k in after if after[k] != before[k]} == {key: 1}


def test_every_launch_key_names_an_entry_of_the_sources():
    entries = set()
    for source in build.CSRC_DIR.glob("*.cu"):
        entries |= set(re.findall(r'extern "C" int m3_(\w+)\(', source.read_text()))
    alias = {"reweight_perchain_blockdiag": "reweight_perchain_det"}
    keys = [k for k in launch.LAUNCHES if not k.endswith("_fallback")]
    assert keys and {alias.get(k, k) for k in keys} <= entries
