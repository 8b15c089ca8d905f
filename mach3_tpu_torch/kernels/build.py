"""Build and load the hand-written CUDA kernels of ``mach3_tpu_torch/csrc``.

Each ``csrc/<stem>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries are built
at first use from the sources in this package only, into ``_build/`` beside
it (git-ignored), keyed on a hash of every source and the flags; a build is
written under a temporary name and renamed into place, so concurrent
processes never load a half-written file.

Nothing here runs at import time: the CPU tests import this module on
machines with no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

from ..core import tracing

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
#: The CUDA toolkit's default install prefix, searched after PATH and CUDA_HOME.
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOADED: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def find_nvcc() -> str:
    """``nvcc`` on ``PATH``, else under ``CUDA_HOME``/``CUDA_PATH``, else
    under the toolkit's default prefix."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), DEFAULT_CUDA_HOME):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise KernelBuildError(
        f"nvcc not found on PATH or under CUDA_HOME / CUDA_PATH / {DEFAULT_CUDA_HOME}; "
        "the CUDA kernels of mach3_tpu_torch need the CUDA toolkit to build"
    )


def _digest(source: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [source, *sorted(CSRC_DIR.glob("*.cuh"))]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path(stem: str) -> Path:
    """Where the library of ``csrc/<stem>.cu`` lives for the current sources."""
    source = CSRC_DIR / f"{stem}.cu"
    if not source.is_file():
        raise KernelBuildError(f"no kernel source {source}")
    return BUILD_DIR / f"lib{stem}_{_digest(source)}.so"


@tracing.setup_span("kernels.build")
def build_all(stems) -> dict[str, tuple[Path, float, str]]:
    """Compile ``csrc/<stem>.cu`` for every stem whose library does not exist
    yet, one ``nvcc`` per source, all started together.

    Returns {stem: (library path, build seconds (0.0 when it existed),
    nvcc's output, which with ``-Xptxas -v`` lists registers and shared
    memory)}. Raises ``KernelBuildError`` if any source fails. Counts
    ``kernel_builds`` (nvcc ran) and ``kernel_loads`` (the library existed)
    in ``core.tracing.PROGRAM``."""
    out: dict[str, tuple[Path, float, str]] = {}
    running = []
    for stem in stems:
        lib = library_path(stem)
        log = lib.with_suffix(".log")
        if lib.is_file():
            out[stem] = (lib, 0.0, log.read_text() if log.is_file() else "")
            tracing.count("kernel_loads")
            continue
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{lib.name}.", suffix=".tmp")
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{stem}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        running.append((stem, lib, tmp, proc, time.perf_counter()))
    failed = []
    for stem, lib, tmp, proc, t0 in running:
        try:
            output, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}) on {stem}.cu:\n{output}")
                continue
            os.replace(tmp, lib)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        lib.with_suffix(".log").write_text(output)
        out[stem] = (lib, time.perf_counter() - t0, output)
        tracing.count("kernel_builds")
    if failed:
        raise KernelBuildError("\n".join(failed))
    return out


def build(stem: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<stem>.cu`` unless its library exists already (see
    :func:`build_all`)."""
    return build_all([stem])[stem]


def kernel_stems() -> list[str]:
    """The stems of every CUDA source of this package."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def load_library(stem: str) -> ctypes.CDLL:
    """Build (at first use) and load the library of ``csrc/<stem>.cu``."""
    lib = _LOADED.get(stem)
    if lib is None:
        path, _, _ = build(stem)
        lib = ctypes.CDLL(str(path))
        _LOADED[stem] = lib
    return lib
