"""No JAX in a run: the harness, a configuration and the reference load no
module whose whole top-level name is ``jax``, ``jaxlib``, ``flax`` or
``mach3_tpu``, and the reference loads nothing of ``mach3_tpu_torch``."""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "mach3_tpu"}

_PROBE = """
import sys
{imports}
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(imports: str) -> set[str]:
    proc = subprocess.run([sys.executable, "-c", _PROBE.format(imports=imports)], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return set(proc.stdout.split())


def test_harness_configuration_and_program_load_no_jax():
    mods = _top_level("import m3bench.run, m3bench.port, m3bench.trace, m3bench.counts\n"
                      "import m3bench.configs.large700, m3bench.configs.beam1det\n"
                      "import m3bench.samplers.mr2t2, m3bench.samplers.chees\n"
                      "import mach3_tpu_torch.fitters.mcmc, mach3_tpu_torch.fitters.hmc\n"
                      "import mach3_tpu_torch.samples.events")
    assert "mach3_tpu_torch" in mods  # compared by whole name: not mach3_tpu
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    mods = _top_level("import m3bench.reference.likelihood, m3bench.reference.osc\n"
                      "import m3bench.reference.splines, m3bench.reference.stats")
    assert not mods & (FORBIDDEN | {"mach3_tpu_torch"})


@pytest.mark.parametrize("name,bad", [("jax.numpy", True), ("mach3_tpu.osc", True),
                                      ("mach3_tpu_torch.osc", False), ("flax", True),
                                      ("jaxtyping", False)])
def test_runtime_check_compares_whole_top_level_names(monkeypatch, name, bad):
    import types

    from m3bench.run import forbidden_modules

    monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert (name.split(".")[0] in forbidden_modules()) == bad
