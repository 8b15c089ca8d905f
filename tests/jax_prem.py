"""The JAX package's PREM paths swapped for the port's while a JAX-side
fixture is built.

The port's ``path_through_earth`` (``mach3_tpu_torch/osc/prem.py``) lists,
on the way up, every crossed shell boundary but the surface; the JAX
package's lists every one but the innermost, so its paths lose the
innermost shell's exit. Tests that hold the port's atmospheric samples equal
to the JAX package's build the JAX side inside :func:`repaired_paths`:
``mach3_tpu/samples/events.py`` imports ``path_through_earth`` inside
``build_atmo_osc_config`` and ``mach3_tpu/osc/prem.py`` calls it by its
module name, so the swap reaches both. The port's function is numpy and
gives arrays of the JAX function's shapes."""
from __future__ import annotations

import contextlib

import pytest


@contextlib.contextmanager
def repaired_paths():
    from mach3_tpu.osc import prem as jprem
    from mach3_tpu_torch.osc.prem import path_through_earth

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jprem, "path_through_earth", path_through_earth)
        yield
