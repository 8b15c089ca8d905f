"""The traced run: ``torch.profiler`` (CPU and CUDA activities) over a few
steps after the window, its Chrome trace read back into device operations,
host launches and idle gaps."""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time

#: Host calls that put work on the card.
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")
_DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function", "user_annotation")


@dataclasses.dataclass
class Trace:
    device: list  # (name, start µs, duration µs) of every device operation
    host: list  # (category, name, start µs, duration µs) of host events
    window_s: float  # host-clock seconds of the traced steps

    def device_seconds(self, names=None) -> float:
        """Device time of the operations whose name holds one of ``names``
        (all without)."""
        return 1e-6 * sum(d for n, _, d in self.device
                          if names is None or any(k in n for k in names))

    def count(self, names=None) -> int:
        return sum(1 for n, _, _ in self.device if names is None or any(k in n for k in names))

    def launches(self) -> int:
        return sum(1 for c, n, _, _ in self.host
                   if c in ("cuda_runtime", "cuda_driver") and n in LAUNCH_CALLS)

    def busy(self) -> tuple[float, list]:
        """(seconds in which a device operation ran, the merged intervals)."""
        spans = sorted((t, t + d) for _, t, d in self.device)
        merged = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return 1e-6 * sum(b - a for a, b in merged), merged

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each labelled by the innermost host event running at its
        start."""
        by_name: dict = {}
        for n, _, d in self.device:
            by_name[n] = by_name.get(n, 0.0) + 1e-6 * d
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        _, merged = self.busy()
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1])
                       for i in range(len(merged) - 1)), reverse=True)[:top]
        labelled = []
        for length, start in gaps:
            around = [(d, n) for c, n, t, d in self.host if t <= start <= t + d and c in _HOST]
            label = min(around)[1] if around else "no host event"
            labelled.append([label[:120], 1e-6 * length])
        return {"device_ops": [[n[:120], s] for n, s in ops], "idle_gaps": labelled}


def traced(run_steps) -> tuple[Trace, object]:
    """``run_steps()`` under the profiler; (its :class:`Trace`, what it returned)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = run_steps()
        if cuda:
            torch.cuda.synchronize()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        if cat in _DEVICE:
            device.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
        elif cat in _HOST:
            host.append((cat, e["name"], float(e["ts"]), float(e.get("dur", 0.0))))
    return Trace(device, host, window), result
