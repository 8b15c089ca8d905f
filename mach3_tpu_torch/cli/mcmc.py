"""mach3-mcmc-torch — run an MCMC fit from YAML configs on the card (port of
``mach3_tpu/cli/mcmc.py``).

CLI equivalent of the reference's experiment executables
(``MCMCTutorial config.yaml [overrides]``), with the override styles of
``MaCh3ManagerFactory``: ``General:MCMC:NSteps:50000`` and
``--override extra.yaml``. Fits the built-in toy (``--experiment toy``) or
the experiment of a config with an ``Experiment:`` tree. The chain file has
the JAX package's format; the checkpoint beside it (``<output>.ckpt``) is
this package's own (``diagnostics/chain_io.py``). A parallel-tempering fit
(``General:FittingAlgorithm:PT``) stores its cold level only; with
``General:PT:BetaZero:true`` the log evidence goes into the chain file's
metadata first.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("configs", nargs="*", help="YAML config files and Key:Sub:Value overrides")
    parser.add_argument("--output", "-o", default="chain.npz")
    parser.add_argument("--checkpoint", default=None, help="Resume from this checkpoint file")
    parser.add_argument(
        "--experiment", default="toy",
        help="Experiment to fit: 'toy' (built-in), or any config passed in `configs` "
        "containing an Experiment: tree (config-driven experiments)",
    )
    parser.add_argument(
        "--profile", default=None, metavar="DIR",
        help="Write a torch.profiler trace of one chunk into DIR (Chrome trace format, "
        "trace.json) and the program's own spans, counters and per-layer device ms of "
        "every chunk (spans.json)",
    )
    parser.add_argument(
        "--stream", choices=["auto", "on", "off"], default="auto",
        help="Stream chunks to per-chunk npz shards instead of holding the whole chain in "
        "RAM (the reference's TTree AutoSave role). 'auto' streams when the estimated chain "
        "exceeds General.MCMC.StreamThresholdMB (default 512).",
    )
    from .common import add_common_args, setup_platform

    add_common_args(parser)
    args = parser.parse_args(argv)
    device = setup_platform(args)

    from ..core import tracing
    from ..core.logging import get_logger
    from ..diagnostics.chain_io import (
        ChainShardWriter,
        load_chain,
        load_checkpoint,
        save_chain,
        save_checkpoint,
    )
    from ..fitters.factory import make_fitter, manager_from_args

    log = get_logger("cli.mcmc")
    if args.profile:
        tracing.enable()
    cfg = manager_from_args(args.configs)

    if cfg.has("Experiment"):
        from ..samples.experiment import build_experiment

        exp = build_experiment(cfg, device=device)
        model, param_sets = exp.model, exp.param_sets
        names = [n for ps in param_sets for n in ps.names]
    elif args.experiment == "toy":
        from ..tutorial.toy import build_toy

        toy = build_toy(n_events=int(cfg.get("Toy.NEvents", 20000)),
                        seed=int(cfg.get("Toy.Seed", 1234)), device=device)
        model, param_sets, names = toy.model, [toy.xsec, toy.osc], toy.names
    else:
        log.error("Unknown experiment '%s' ('toy' is built-in; config-driven experiments "
                  "need an Experiment: tree in the YAML)", args.experiment)
        return 2
    fitter = make_fitter(cfg, model, seed=args.seed)
    if not hasattr(fitter, "state"):
        from ..core.exceptions import ConfigError

        raise ConfigError(
            f"General.FittingAlgorithm '{cfg.get('General.FittingAlgorithm')}' is an optimiser, "
            "not a sampler: mach3-mcmc-torch runs samplers; call "
            "fitters.make_fitter(cfg, model).run() for its result")
    n_steps = int(cfg.get("General.MCMC.NSteps", 1000))

    # Streaming: estimated full-chain bytes against the threshold. The
    # hold-in-RAM design cannot hold a 100k-step x 1000-chain chain at all.
    n_chains = int(fitter.state.theta.shape[0])
    est_bytes = n_steps * n_chains * (model.n_params + 3) * 8
    thresh_mb = float(cfg.get("General.MCMC.StreamThresholdMB", 512))
    streaming = args.stream == "on" or (
        args.stream == "auto" and est_bytes > thresh_mb * 1024 * 1024)
    if streaming:
        log.info("Streaming chain storage (%s: est. %.2f GB, threshold %.0f MB) — per-chunk "
                 "shards in %s.d", "forced" if args.stream == "on" else "auto",
                 est_bytes / 1e9, thresh_mb, args.output)

    prefix_draws = None
    if args.checkpoint:
        load_checkpoint(args.checkpoint, fitter)
        # Resume as the reference does (StartFromPreviousFit + stepStart,
        # MCMCBase.cpp:149-173): run the remaining steps and carry the
        # draws already written forward (on disk when streaming).
        done_steps = int(fitter.state.step)
        n_steps = max(0, n_steps - done_steps)
        log.info("Resumed at step %d; %d steps remaining", done_steps, n_steps)
        if os.path.exists(args.output) and not streaming:
            prev_draws, prev_meta, _ = load_chain(args.output)
            if prev_meta.get("names") == names:
                # Crash consistency: a kill can land after a chunk's chain
                # write but before its checkpoint, leaving the chain one
                # chunk ahead of the resumed state: truncate to it.
                prefix_draws = {k: v[:done_steps] for k, v in prev_draws.items()}

    prefit = np.concatenate([np.asarray(ps.prefit) for ps in param_sets])
    prefit_err = np.concatenate([np.asarray(ps.errors) for ps in param_sets])
    extra_meta: dict = {"prefit": prefit.tolist(), "prefit_err": prefit_err.tolist()}
    yaml_text = cfg.to_yaml()

    def write_out(draws: dict, state) -> None:
        """Chain + checkpoint, each written atomically (the reference's
        TTree AutoSave, ``MCMCBase.cpp:119-121``); ``state`` the state at
        the end of ``draws``. Parallel tempering stores its cold level."""
        if hasattr(fitter, "cold_chain"):
            draws = fitter.cold_chain(draws)
        if prefix_draws is not None:
            draws = {k: np.concatenate([prefix_draws[k], v], axis=0) if k in prefix_draws else v
                     for k, v in draws.items()}
        save_chain(args.output, draws, names, config_yaml=yaml_text, extra_meta=extra_meta)
        save_checkpoint(args.output + ".ckpt", fitter, names, yaml_text, state=state)

    auto_save = int(cfg.get("General.MCMC.AutoSave", 500)) > 0
    collected: list[dict] = []
    writer = None
    if streaming:
        writer = ChainShardWriter(args.output, names, config_yaml=yaml_text,
                                  extra_meta=extra_meta)
        if args.checkpoint and writer.parts:
            writer.truncate(int(fitter.state.step))  # crash consistency, as above
        if not writer.parts and os.path.exists(args.output) and args.checkpoint:
            # Resume of a chain written in hold-in-RAM mode: seed the shard
            # directory with the previous draws so the history is kept.
            prev_draws, prev_meta, _ = load_chain(args.output)
            if prev_meta.get("names") == names and prev_draws:
                writer.append(prev_draws)

    def progress(done, state, chunk):
        if prof is not None:
            prof.step()
        try:
            acc = float(state.n_accepted.double().mean()) / max(int(state.step), 1)
            rhat = fitter.online_rhat(chunk)
            log.info("step %d/%d  acc %.3f  nll %.2f  max-Rhat(chunk) %.3f  %.1f ms/step",
                     done, n_steps, acc, float(chunk["nll"][-1].mean()),
                     float(np.nanmax(rhat)), 1e3 * float(chunk["step_time"][0]))
        except (AttributeError, KeyError):  # fitters without MR2T2's telemetry
            log.info("step %d/%d", done, n_steps)
        if streaming:
            writer.append(fitter.cold_chain(chunk) if hasattr(fitter, "cold_chain") else chunk)
            if auto_save:
                writer.finalize()  # the manifest tracks every appended shard
                save_checkpoint(args.output + ".ckpt", fitter, names, yaml_text, state=state)
            return
        collected.append(chunk)
        if auto_save and done < n_steps:  # the final write happens below
            write_out({k: np.concatenate([c[k] for c in collected], axis=0)
                       for k in collected[0]}, state=state)

    if n_steps <= 0:  # resume of an already-complete fit
        log.info("Chain already complete; nothing to do")
        return 0
    prof = chunk_profiler(args.profile, device) if args.profile else None
    out = fitter.run(n_steps=n_steps, callback=progress, collect=not streaming)
    if prof is not None:
        prof.stop()
        tracing.write(os.path.join(args.profile, "spans.json"))
        tracing.enable(False)
        log.info("profiler trace of the second chunk and the run's spans written to %s",
                 args.profile)
    beta_zero = hasattr(fitter, "cold_chain") and getattr(fitter.config, "beta_zero", False)
    if streaming:
        if beta_zero:
            log.warning("log-evidence needs the full multi-level chain; streaming mode stores "
                        "the cold level only — rerun with --stream off or compute evidence "
                        "online in chunks")
        writer.finalize()
        save_checkpoint(args.output + ".ckpt", fitter, names, yaml_text)
        log.info("Wrote %s (+.ckpt): %d shards, %.2f MB on disk, max %.2f MB resident",
                 args.output, len(writer.parts), writer.disk_bytes / 1e6,
                 writer.max_resident_bytes / 1e6)
        return 0
    if beta_zero:
        # A β = 0 ladder gives the marginal likelihood (diagnostics/evidence.py):
        # recorded before write_out drops the hot levels.
        logz = fitter.log_evidence(out)
        extra_meta["log_evidence"] = logz
        log.info("log evidence (stepping-stone, normalised prior): %.4f", logz)
    write_out(out, state=fitter.state)
    log.info("Wrote %s (+.ckpt)", args.output)
    return 0


def chunk_profiler(out_dir: str, device):
    """A started ``torch.profiler`` that traces the second chunk of the run
    (the first builds the kernels and captures the graph) into
    ``out_dir/trace.json`` (Chrome trace format); the run's callback calls
    its ``step()`` at each chunk's end. The program's spans in that chunk
    (``core.tracing``) appear in it as ``record_function`` ranges."""
    from torch.profiler import ProfilerActivity, profile, schedule

    os.makedirs(out_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    # One cycle: with more, each later odd chunk is traced again and the
    # last trace overwrites the second chunk's.
    prof = profile(activities=activities,
                   schedule=schedule(wait=1, warmup=0, active=1, repeat=1),
                   on_trace_ready=lambda p: p.export_chrome_trace(
                       os.path.join(out_dir, "trace.json")))
    prof.start()
    return prof

if __name__ == "__main__":
    sys.exit(main())
