"""Native columnar event IO (port of ``mach3_tpu/core/nativeio.py``): the
"M3EV" columnar binary format and a multithreaded CSV parser, through
ctypes over the repository's ``native/m3io.cpp``.

The library is compiled with ``g++`` at first use into ``_build/`` beside
this package (git-ignored), keyed on a hash of the source and the flags,
written under a temporary name and renamed into place; nothing is written
into ``native/``. Where it cannot be built or loaded, the numpy readers and
writer below take over (the file format is the same either way). ``READS``
counts the reads each of the two made, so a caller can tell which ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
from pathlib import Path
from typing import Mapping

import numpy as np

from .logging import get_logger

_log = get_logger("nativeio")

SOURCE = Path(__file__).resolve().parents[2] / "native" / "m3io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")

_DTYPE_CODE = {np.dtype(np.float32): 0, np.dtype(np.float64): 1, np.dtype(np.int32): 2}
_CODE_DTYPE = {0: np.float32, 1: np.float64, 2: np.int32}
_MAGIC = b"M3EV0001"
_ALIGN = 64

#: Reads (files and CSVs) made by the native library and by numpy.
READS = {"native": 0, "numpy": 0}

_u64, _u32, _vp = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_void_p
_SIGNATURES = {
    "m3io_write": (ctypes.c_int, [ctypes.c_char_p, _u64, _u32, ctypes.c_char_p,
                                  ctypes.POINTER(_u32), ctypes.POINTER(_vp)]),
    "m3io_read_header": (ctypes.c_int, [ctypes.c_char_p, ctypes.POINTER(_u64),
                                        ctypes.POINTER(_u32)]),
    "m3io_read_columns_meta": (ctypes.c_int, [ctypes.c_char_p, ctypes.c_char_p,
                                              ctypes.POINTER(_u32)]),
    "m3io_read_column": (ctypes.c_int, [ctypes.c_char_p, _u32, _vp, _u32]),
    "m3io_parse_csv": (ctypes.c_long, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_double),
                                       _u64, _u32, _u32]),
}

_lib: ctypes.CDLL | None = None
_lib_tried = False


class NativeBuildError(RuntimeError):
    """The native IO library could not be built or loaded."""


def library_path() -> Path:
    """Where the library of the current ``native/m3io.cpp`` lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libm3io_{h.hexdigest()[:16]}.so"


def build_library() -> Path:
    """Compile ``native/m3io.cpp`` into ``_build/`` unless its library exists;
    raises ``NativeBuildError`` if there is no source or compiler, or the
    compiler refuses it."""
    if not SOURCE.is_file():
        raise NativeBuildError(f"no native IO source {SOURCE}")
    lib = library_path()
    if lib.is_file():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise NativeBuildError("no C++ compiler (g++ or $CXX) for the native IO library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{lib.name}.", suffix=".tmp")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)], capture_output=True,
                              text=True, timeout=300)
        if proc.returncode != 0:
            raise NativeBuildError(f"{cxx} failed ({proc.returncode}) on {SOURCE}:\n"
                                   f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"could not run {cxx} on {SOURCE}: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load_library(required: bool = False) -> ctypes.CDLL | None:
    """The native IO library, built at first use; None where it cannot be
    built or loaded (logged once), or raises ``NativeBuildError`` then if
    ``required``."""
    global _lib, _lib_tried
    if _lib is not None or (_lib_tried and not required):
        return _lib
    _lib_tried = True
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (NativeBuildError, OSError) as e:
        if required:
            raise NativeBuildError(str(e)) from e
        _log.warning("native IO library unavailable (%s); numpy readers in use", e)
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    _lib = lib
    _log.info("Loaded native IO library %s", lib._name)
    return _lib


def _align(x: int) -> int:
    return (x + _ALIGN - 1) // _ALIGN * _ALIGN


def write_events(path: str, columns: Mapping[str, np.ndarray]) -> None:
    """Write a columnar event file (f32, f64 and i32 columns of one length)."""
    names = list(columns)
    arrays = [np.ascontiguousarray(columns[n]) for n in names]
    n_events = len(arrays[0]) if arrays else 0
    for n, a in zip(names, arrays):
        if a.ndim != 1 or len(a) != n_events:
            raise ValueError(f"Column '{n}' must be 1-D of length {n_events}")
        if a.dtype not in _DTYPE_CODE:
            raise ValueError(f"Column '{n}' dtype {a.dtype} unsupported (f32/f64/i32)")
    lib = load_library()
    if lib is not None:
        name_buf = b"".join(n.encode()[:63].ljust(64, b"\0") for n in names)
        dtypes = (_u32 * len(names))(*[_DTYPE_CODE[a.dtype] for a in arrays])
        ptrs = (_vp * len(names))(*[a.ctypes.data for a in arrays])
        rc = lib.m3io_write(os.fsencode(path), n_events, len(names), name_buf, dtypes, ptrs)
        if rc != 0:
            raise OSError(f"m3io_write failed with {rc}")
        return
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<QII", n_events, len(names), 0))
        offset = _align(8 + 16 + len(names) * 80)
        descs = []
        for n, a in zip(names, arrays):
            descs.append((n, _DTYPE_CODE[a.dtype], offset))
            offset = _align(offset + a.nbytes)
        for n, code, off in descs:
            f.write(n.encode()[:63].ljust(64, b"\0"))
            f.write(struct.pack("<IIQ", code, 0, off))
        for a, (_, _, off) in zip(arrays, descs):
            f.seek(off)
            f.write(a.tobytes())


def read_events(path: str, n_threads: int = 4) -> dict[str, np.ndarray]:
    """Read a columnar event file into numpy arrays."""
    lib = load_library()
    if lib is not None:
        READS["native"] += 1
        return _read_native(lib, os.fsencode(path), n_threads)
    READS["numpy"] += 1
    return read_events_numpy(path)


def _read_native(lib, path: bytes, n_threads: int) -> dict[str, np.ndarray]:
    n_events, n_cols = _u64(), _u32()
    rc = lib.m3io_read_header(path, ctypes.byref(n_events), ctypes.byref(n_cols))
    if rc != 0:
        raise OSError(f"m3io_read_header failed with {rc}")
    names = ctypes.create_string_buffer(64 * n_cols.value)
    dtypes = (_u32 * n_cols.value)()
    rc = lib.m3io_read_columns_meta(path, names, dtypes)
    if rc != 0:
        raise OSError(f"m3io_read_columns_meta failed with {rc}")
    out = {}
    for c in range(n_cols.value):
        name = names.raw[64 * c: 64 * (c + 1)].split(b"\0")[0].decode()
        arr = np.empty(n_events.value, dtype=_CODE_DTYPE[dtypes[c]])
        rc = lib.m3io_read_column(path, c, arr.ctypes.data, n_threads)
        if rc != 0:
            raise OSError(f"m3io_read_column({name}) failed with {rc}")
        out[name] = arr
    return out


def read_events_numpy(path: str) -> dict[str, np.ndarray]:
    """The numpy reader of the same format."""
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise OSError(f"{path} is not an M3EV file")
        n_events, n_cols, _ = struct.unpack("<QII", f.read(16))
        descs = []
        for _ in range(n_cols):
            name = f.read(64).split(b"\0")[0].decode()
            code, _, off = struct.unpack("<IIQ", f.read(16))
            descs.append((name, code, off))
        out = {}
        for name, code, off in descs:
            f.seek(off)
            dt = np.dtype(_CODE_DTYPE[code])
            out[name] = np.frombuffer(f.read(n_events * dt.itemsize), dtype=dt).copy()
        return out


def parse_csv(path: str, column_names: list[str], n_threads: int = 4) -> dict[str, np.ndarray]:
    """Parse a numeric CSV with a header line into f64 columns."""
    lib = load_library()
    if lib is None:
        READS["numpy"] += 1
        return parse_csv_numpy(path, column_names)
    READS["native"] += 1
    with open(path, "rb") as f:
        n_lines = sum(1 for _ in f) - 1
    out = np.empty((len(column_names), max(n_lines, 1)), np.float64)
    rc = lib.m3io_parse_csv(os.fsencode(path),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), out.shape[1],
                            len(column_names), n_threads)
    if rc < 0:
        raise OSError(f"m3io_parse_csv failed with {rc}")
    return {n: out[i, :rc].copy() for i, n in enumerate(column_names)}


def parse_csv_numpy(path: str, column_names: list[str]) -> dict[str, np.ndarray]:
    """The numpy parser of the same CSVs."""
    data = np.atleast_2d(np.genfromtxt(path, delimiter=",", skip_header=1, dtype=np.float64))
    return {n: data[:, i].copy() for i, n in enumerate(column_names)}
