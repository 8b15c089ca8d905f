"""One run of one cell of ``BENCHMARK.json``:

    python3 -m m3bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

It makes the configuration's inputs from the seed, the Asimov data with the
reference, builds the program's model through its constructors, runs the
traffic's sampler through its warm-up (set-up ends there, less the
reference's Asimov pass), measures whole
chunks for ``--seconds``, with ``--trace 1`` then traces a few more steps,
frees the program and compares what the window produced with the plain
reference. The last line of standard output is the result; the numbers
compared, each beside its limit, are the last lines of standard error and
the result's last key.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file found by its name: ``configs/<config>.py`` (and the
configuration's ``file``), ``traffic/<mix>.json``, ``samplers/<kind>.py``
(the mix's ``sampler``), ``metrics/<metric>.py``, ``limits/<cell>.json``.

``--control 1`` puts the reference, computed one step below the precision
the configuration states, in the program's place in the comparison (the
benchmark's own runs never pass it).
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import time
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent
#: Top-level modules a run must not hold: JAX, and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "mach3_tpu")


def _load(path: Path, name: str):
    """The module in ``path`` (names may hold dots), as a submodule of the
    benchmark's package so that its relative imports resolve."""
    package = f"{__package__}.{path.parent.name}"
    spec = importlib.util.spec_from_file_location(f"{package}._{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    mod.__package__ = package
    spec.loader.exec_module(mod)
    return mod


def _entry(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _process_age() -> float | None:
    """Seconds since this process started (Linux), else None."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m m3bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: float | None = None, bench_path: Path | None = None,
         require_cuda: bool = True) -> int:
    t0 = time.perf_counter() if t_start is None else t_start
    age = _process_age()
    if age is not None:
        t0 = min(t0, time.perf_counter() - age)
    args = parse(argv)
    bench_path = bench_path or HERE.parent / "BENCHMARK.json"
    root = bench_path.parent
    bench = json.loads(bench_path.read_text())
    cell = _entry(bench["workloads"], args.workload, "workload")
    config = _entry(bench["configs"], cell["config"], "config")
    # The program's and the libraries' caches: fixed directories inside the checkout.
    cache = root / ".m3bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch

    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell["chips"]):
        print(f"m3bench: cell {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    import numpy as np

    from . import port
    from .compare import judged
    from .counts import distinct_segments, sample_work
    from .fixtures import SIGMA_KNOTS
    from .reference.likelihood import Reference, control_precision, spline_tables
    from .reference.params import read

    spec = json.loads((root / config["file"]).read_text())
    generator = _load(HERE / "configs" / f"{cell['config']}.py", f"config_{cell['config']}")
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    sampler = _load(HERE / "samplers" / f"{traffic['sampler']}.py", f"sampler_{traffic['sampler']}")
    limits = json.loads((HERE / "limits" / f"{cell['name']}.json").read_text())
    dev = torch.device("cuda", 0) if require_cuda else torch.device("cpu")

    marks = [("start", t0), ("imports", time.perf_counter())]
    inputs = generator.build(spec, args.seed)
    params = read(inputs.trees)
    marks.append(("inputs", time.perf_counter()))
    tables = spline_tables(inputs, dev)
    inputs.data = Reference(inputs, dev, tables).asimov(torch.as_tensor(params.prefit))
    tables = [[(p, ev, co.cpu()) for p, ev, co in t] for t in tables]  # off the card
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    marks.append(("asimov data", time.perf_counter()))
    model = port.build_model(inputs, dev)
    _sync(dev)
    marks.append(("program model", time.perf_counter()))
    run = sampler.Run(model, traffic, inputs, args.seed, dev)
    run.warm_up()
    _sync(dev)
    marks.append(("sampler warm-up", time.perf_counter()))
    # The reference's Asimov pass is the benchmark's own work, not set-up.
    at = dict(marks)
    reference_s = at["asimov data"] - at["inputs"]
    setup_s = marks[-1][1] - t0 - reference_s
    print("m3bench: set-up " + ", ".join(f"{name} {b - a:.3f} s" for (_, a), (name, b)
                                         in zip(marks[:-1], marks[1:])), file=sys.stderr)

    clocks = _clocks(dev)
    win = run.window(args.seconds)
    chunk_s = np.diff(run.stamps)
    print(f"m3bench: window chunks {len(chunk_s)}, seconds per chunk min {chunk_s.min():.4f} "
          f"median {np.median(chunk_s):.4f} max {chunk_s.max():.4f}; card before {clocks}, "
          f"after {_clocks(dev)}", file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    e2e_names = {m["name"] for m in bench["end_to_end"]
                 if "workloads" not in m or cell["name"] in m["workloads"]}
    device = {"platform": "gpu" if dev.type == "cuda" else "cpu",
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell["chips"], "memory_peak_bytes": int(peak)}
    breakdown = None
    if args.trace:
        from . import trace as tracing

        tr, traced = tracing.traced(lambda: run.traced(traffic["traced_steps"]))
        segs = [distinct_segments(th, SIGMA_KNOTS) for th in traced["theta"]]
        per_step = traced.get("units_per_step", [traced["units"] / traced["steps"]] * len(segs))
        ctx = types.SimpleNamespace(
            trace=tr, steps=traced["steps"], units=traced["units"], units_per_step=per_step,
            segments=segs, works=sample_work(inputs, params), n_chains=traffic["chains"],
            n_params=inputs.n_params, ms_per_unit=win["ms_per_step"])
        metrics = {}
        for m in bench["per_layer"]:
            if cell["name"] not in m["workloads"]:
                continue
            value = _load(HERE / "metrics" / f"{m['name']}.py", f"metric_{m['name']}").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        busy, _ = tr.busy()
        device.update(busy_s=busy, window_s=tr.window_s)
        breakdown = tr.breakdown()
    else:
        measured = {run.rate_metric: win["rate"], "setup_s": setup_s}
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]}
                   for m in bench["end_to_end"] if m["name"] in e2e_names and m["name"] in measured}

    # The window has closed and the peak is read: free the program, then check.
    run.release()
    del model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref = Reference(inputs, dev, tables)
    control = control_precision(inputs.precision) if args.control else None
    numbers = run.check(ref, np.random.default_rng([args.seed, 2]), traffic["checked_steps"],
                        control=control, tie=limits["tie"])
    numbers.pop("checked_steps", None)
    correct, checks = judged(numbers, {k: v for k, v in limits.items() if k != "tie"})

    found = forbidden_modules()
    if found:
        print(f"m3bench: modules that a run must not load are loaded: {found}", file=sys.stderr)
        return 3
    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(f"m3bench: {cell['name']} seed {args.seed}: {win['steps']} steps in "
          f"{win['seconds']:.3f} s, set-up {setup_s:.3f} s", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


def _clocks(dev) -> str:
    """The card's SM clock, power draw and limit, temperature and throttle
    reasons, as ``nvidia-smi`` reads them ("" without it)."""
    import subprocess

    if dev.type != "cuda":
        return ""
    try:
        return subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=clocks.sm,power.draw,"
             "power.limit,temperature.gpu,clocks_throttle_reasons.active",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
