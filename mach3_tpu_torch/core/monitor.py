"""System introspection, banners, and progress reporting (port of
``mach3_tpu/core/monitor.py``).

The equivalent of ``Manager/Monitor.h/.cpp``: welcome banner, CPU/RAM/OS/
device introspection, progress bar, and per-process resource usage. The GPU
memory query of the reference (``gpuUtils.cu``) reads ``torch.cuda``.
"""
from __future__ import annotations

import os
import platform
import sys
import time

import torch

from .. import __version__
from .logging import get_logger

_log = get_logger("monitor")


def get_cpu_info() -> dict[str, str]:
    info = {"machine": platform.machine(), "processor": platform.processor() or "unknown"}
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    info["model"] = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    info["count"] = str(os.cpu_count())
    return info


def get_memory_info() -> dict[str, float]:
    out = {}
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                key, val = line.split(":", 1)
                if key in ("MemTotal", "MemAvailable"):
                    out[key] = float(val.strip().split()[0]) / 1e6  # GB
    except OSError:
        pass
    return out


def get_device_info() -> list[dict]:
    """The visible CUDA devices (``checkGpuMem``): id, platform ``gpu``,
    name, and bytes in use / total from ``torch.cuda.mem_get_info``; an
    empty list without a card."""
    devices = []
    if not torch.cuda.is_available():
        return devices
    for i in range(torch.cuda.device_count()):
        entry = {"id": i, "platform": "gpu", "kind": torch.cuda.get_device_name(i)}
        free, total = torch.cuda.mem_get_info(i)
        entry["bytes_in_use"] = total - free
        entry["bytes_limit"] = total
        devices.append(entry)
    return devices


def welcome() -> None:
    """``MaCh3Welcome``: banner + system summary at startup."""
    cpu = get_cpu_info()
    mem = get_memory_info()
    _log.info("mach3_tpu_torch %s  (python %s, torch %s, %s)", __version__,
              sys.version.split()[0], torch.__version__, platform.platform())
    _log.info("CPU: %s x%s", cpu.get("model", cpu["processor"]), cpu["count"])
    if mem:
        _log.info("RAM: %.1f GB total, %.1f GB available", mem.get("MemTotal", 0), mem.get("MemAvailable", 0))
    for d in get_device_info():
        extra = ""
        if "bytes_limit" in d and d["bytes_limit"]:
            extra = f" ({d['bytes_in_use'] / 1e9:.2f}/{d['bytes_limit'] / 1e9:.2f} GB)"
        _log.info("Device %d: %s %s%s", d["id"], d["platform"], d["kind"], extra)


class ProgressBar:
    """Step-loop progress reporting (``PrintProgressBar`` + the per-10%%
    acceptance printout of ``MCMCBase.cpp:96-100``)."""

    def __init__(self, total: int, label: str = "MCMC", every: float = 0.1):
        self.total = total
        self.label = label
        self.every = max(1, int(total * every))
        self.start = time.perf_counter()

    def update(self, done: int, **stats: float) -> None:
        if done % self.every and done != self.total:
            return
        elapsed = time.perf_counter() - self.start
        rate = done / max(elapsed, 1e-9)
        extra = "  ".join(f"{k} {v:.3g}" for k, v in stats.items())
        _log.info(
            "%s %d/%d (%.0f%%)  %.1f steps/s  %s",
            self.label,
            done,
            self.total,
            100.0 * done / self.total,
            rate,
            extra,
        )
