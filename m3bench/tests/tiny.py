"""A copy of the benchmark in a temporary directory that gains, as new files
and entries only, a small configuration, two small traffic mixes, their
cells with limits, and a per-layer metric; and a run of it on the CPU."""
from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import shutil
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
CELLS = ("tiny.mr2t2", "tiny.chees")


def make_copy(tmp: Path, base: str = "beam2det") -> Path:
    """The copy under ``tmp``, its configuration ``base`` cut to a few
    thousand events (atmospheric ones too, where ``base`` has them);
    returns its BENCHMARK.json."""
    shutil.copytree(REPO / "m3bench", tmp / "m3bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    spec = json.loads((REPO / "m3bench" / "configs" / f"{base}.json").read_text())
    spec.update(name="tiny", n_numu=1500, n_nue=500, n_beam_generated=4000)
    if "n_atmo" in spec:
        spec["n_atmo"] = 1500
    cfg = tmp / "m3bench" / "configs"
    (cfg / "tiny.json").write_text(json.dumps(spec))
    (cfg / "tiny.py").write_text(f"from .{base} import build  # noqa: F401\n")
    traffic = tmp / "m3bench" / "traffic"
    mr = json.loads((traffic / "mr2t2_pooled_512.json").read_text())
    mr.update(chains=8, chunk_steps=10, warm_steps=40, adaption_start_update=5,
              adaption_start_throw=20, adaption_update_step=5, checked_steps=3, traced_steps=2)
    (traffic / "tiny_mr2t2.json").write_text(json.dumps(mr))
    ch = json.loads((traffic / "chees_128.json").read_text())
    ch.update(chains=4, chunk_steps=2, warm_steps=12, adapt_steps=10, max_leapfrog=4,
              checked_steps=2, traced_steps=1)
    (traffic / "tiny_chees.json").write_text(json.dumps(ch))
    (tmp / "m3bench" / "metrics" / "tiny_steps.py").write_text(
        "def read(ctx):\n    return float(ctx.steps)\n")
    limits = tmp / "m3bench" / "limits"
    (limits / "tiny.mr2t2.json").write_text(json.dumps(
        json.loads((limits / "beam2det.mr2t2.json").read_text())))
    (limits / "tiny.chees.json").write_text(json.dumps(
        json.loads((limits / "beam1det.chees.json").read_text())))
    bench["configs"].append({"name": "tiny", "source": "https://github.com/mach3-software/MaCh3",
                             "file": "m3bench/configs/tiny.json", "reduced": [], "why": "test"})
    bench["workloads"] += [
        {"name": "tiny.mr2t2", "config": "tiny", "traffic": "tiny_mr2t2", "chips": 1, "why": "t"},
        {"name": "tiny.chees", "config": "tiny", "traffic": "tiny_chees", "chips": 1, "why": "t"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.chees" if "chees" in m["name"] or m["name"] ==
                                  "grad_evals_per_s" else "tiny.mr2t2")
    bench["per_layer"].append({"name": "tiny_steps", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "chunk runner",
                               "moves": "chain_steps_per_s", "workloads": ["tiny.mr2t2"]})
    path = tmp / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path


def load_copy(tmp: Path):
    """The copy's ``run`` module, imported as a package of its own name."""
    name = f"m3bench_copy_{abs(hash(str(tmp)))}"
    spec = importlib.util.spec_from_file_location(
        name, tmp / "m3bench" / "__init__.py", submodule_search_locations=[str(tmp / "m3bench")])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.run")


def run_cell(tmp: Path, cell: str, seed: int = 2_200_000_001, trace: int = 0,
             control: int = 0, cuda: bool = False) -> tuple[int, dict | None, str]:
    """(exit code, the last line as JSON or None, standard error) of one run
    of ``cell`` in the copy: on the CPU without the look for a card, or
    with ``cuda`` on the card."""
    torch.set_num_threads(2)
    run = load_copy(tmp)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "1",
                       "--trace", str(trace), "--control", str(control)],
                      bench_path=tmp / "BENCHMARK.json", require_cuda=cuda)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()
