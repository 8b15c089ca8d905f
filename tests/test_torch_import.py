"""The PyTorch port imports with jax blocked, and no source of it names jax."""
import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parent.parent / "mach3_tpu_torch"

_IMPORT_ALL = """
import sys
sys.modules["jax"] = None  # any `import jax` now raises ImportError
import importlib, pkgutil
import mach3_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mach3_tpu_torch.__path__, "mach3_tpu_torch.")]
for name in names:
    importlib.import_module(name)
assert not any(k == "mach3_tpu" or k.startswith("mach3_tpu.") for k in sys.modules)
print(len(names))
"""


def test_port_imports_with_jax_blocked():
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
        cwd=PKG.parent, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 88


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_import_in_source(path):
    src = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax)\b", src, re.M), path
    assert not re.search(r"^\s*(import mach3_tpu|from mach3_tpu)\b(?!_torch)", src, re.M), path
