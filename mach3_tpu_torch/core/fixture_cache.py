"""Disk cache of built fixtures (the port's counterpart of
``mach3_tpu/core/fixture_cache.py``).

A reference-scale build costs minutes of host work (spline coefficients,
event layouts and activity plans, Asimov data); the reference's answer is the
preprocessed-monolith file (``Splines/SplineMonolith.h:48-52``), and this is
the same idea one level up: the whole built experiment (its ``nn.Module``
buffers and host-side settings) is written with ``torch.save`` and read back
with ``torch.load`` onto the device the caller names.

Keying: an entry is found again only while every source that shapes a built
fixture is unchanged (a fingerprint over the port's ``splines/``,
``samples/``, ``osc/``, ``tutorial/`` and ``csrc/``), and under the same name,
version string and builder keyword arguments. A stale or unreadable entry is
rebuilt and overwritten. Entries live in ``$MACH3_FIXTURE_CACHE/torch``, by
default ``.fixture_cache/torch/`` at the repository root, apart from the JAX
package's; ``MACH3_FIXTURE_CACHE_OFF=1`` turns the cache off. An entry is
read with ``weights_only=False`` (it holds Python objects): read only
entries this program wrote.
"""
from __future__ import annotations

import hashlib
import os
import tempfile
from pathlib import Path
from typing import Any, Callable

import torch

from .logging import get_logger

_log = get_logger("fixture_cache")

PACKAGE_DIR = Path(__file__).resolve().parents[1]
#: The package directories whose sources determine a built fixture.
FINGERPRINT_DIRS = ("splines", "samples", "osc", "tutorial", "csrc")
_SUFFIXES = (".py", ".cu", ".cuh")


def default_cache_dir() -> str:
    root = os.environ.get("MACH3_FIXTURE_CACHE") or str(PACKAGE_DIR.parent / ".fixture_cache")
    return os.path.join(root, "torch")


def source_fingerprint() -> str:
    """Hash of every source file under ``FINGERPRINT_DIRS`` (16 hex chars)."""
    h = hashlib.sha256()
    for d in FINGERPRINT_DIRS:
        for f in sorted((PACKAGE_DIR / d).glob("*")):
            if f.suffix in _SUFFIXES:
                h.update(f"{d}/{f.name}".encode())
                h.update(f.read_bytes())
    return h.hexdigest()[:16]


def entry_path(name: str, version: str = "v1", kwargs: dict | None = None,
               cache_dir: str | None = None) -> str:
    """The file of the entry for this name, version, builder kwargs and the
    current sources."""
    key = hashlib.sha256(repr(sorted((kwargs or {}).items())).encode()).hexdigest()[:16]
    return os.path.join(cache_dir or default_cache_dir(),
                        f"{name}-{version}-{source_fingerprint()}-{key}.pt")


def save_fixture(path: str, obj: Any) -> None:
    """Write ``obj`` to ``path`` (``torch.save``), under a temporary name
    renamed into place, so a reader never sees half a file."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(obj, f)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_fixture(path: str, device: str | torch.device | None = None) -> Any:
    """Read an object written by :func:`save_fixture`, its tensors on
    ``device`` (default: where they were)."""
    return torch.load(path, map_location=device, weights_only=False)


def load_or_build(
    name: str,
    builder: Callable[[], Any],
    version: str = "v1",
    cache_dir: str | None = None,
    validate: Callable[[Any], bool] | None = None,
    kwargs: dict | None = None,
    enabled: bool | None = None,
) -> Any:
    """``builder()``'s result, cached on disk across processes (a loaded
    entry's tensors on the devices they were saved from). ``kwargs`` (the
    builder's keyword arguments) is part of the key; ``validate`` runs on a
    loaded entry, which is rebuilt if it says False or raises; ``enabled``
    defaults to ``MACH3_FIXTURE_CACHE_OFF != 1``."""
    if enabled is None:
        enabled = os.environ.get("MACH3_FIXTURE_CACHE_OFF", "0") != "1"
    if not enabled:
        return builder()
    path = entry_path(name, version, kwargs, cache_dir)
    if os.path.exists(path):
        try:
            obj = load_fixture(path)
            if validate is not None and not validate(obj):
                raise ValueError("validation failed")
            _log.info("fixture %s: loaded from cache (%s)", name, path)
            return obj
        except Exception as exc:  # any unreadable entry is rebuilt
            _log.warning("fixture %s: stale or unreadable cache entry (%s): rebuilding", name,
                         exc)
    obj = builder()
    try:
        save_fixture(path, obj)
        _log.info("fixture %s: cached to %s", name, path)
    except Exception as exc:  # a cache that cannot be written is not fatal
        _log.warning("fixture %s: cache write failed (%s)", name, exc)
    return obj
