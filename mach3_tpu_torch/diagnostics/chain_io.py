"""Chain storage, merging, and checkpoint/resume (port of
``mach3_tpu/diagnostics/chain_io.py``).

* A chain file is a compressed ``.npz`` with the draws (``draw_<name>``),
  optional sampler state (``state_<name>``) and a JSON metadata header
  (``meta_json``: version, parameter names, the full YAML config): the same
  format as the JAX package's, so either package's ``load_chain`` and the
  JAX package's ``mach3-process`` / ``mach3-diag`` / ``mach3-plot`` read it
  (the reference's "posteriors" TTree, ``Fitters/FitterBase.cpp:153-205``).
* :class:`ChainShardWriter` streams one shard per chunk, with a manifest
  chain file (the reference's TTree AutoSave role).
* :func:`combine_chains` refuses to merge chains of differing versions,
  configs or parameter names (``CombineMaCh3Chains.cpp``).
* :func:`save_checkpoint` / :func:`load_checkpoint` persist the sampler's
  whole state for an exact resume (``StartFromPreviousFit``,
  ``FitterBase.cpp:348+``). The checkpoint is this package's own: it holds
  the ``torch.Generator``'s Philox state, which has no counterpart in the
  JAX package's threefry key, so neither package resumes the other's
  checkpoint.
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any

import numpy as np
import torch

from .. import __version__
from ..core.exceptions import MaCh3Error
from ..core.logging import get_logger

_log = get_logger("chain_io")


def _savez_atomic(directory: str, target: str, payload: dict) -> None:
    """``np.savez_compressed`` into a temporary file of ``directory``, then
    renamed onto ``target``: a reader never sees a half-written file."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    os.close(fd)
    try:
        np.savez_compressed(tmp, **payload)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, target)
    finally:
        for p in (tmp, tmp + ".npz"):
            if os.path.exists(p):
                os.remove(p)


def save_chain(
    path: str,
    draws: dict[str, np.ndarray],
    names: list[str],
    config_yaml: str = "",
    extra_meta: dict[str, Any] | None = None,
    state: dict[str, np.ndarray] | None = None,
) -> None:
    """Atomically write a chain file. draws: the fitter's output arrays
    (theta [S, C, P], nll, acc_prob, ...); state: sampler state arrays."""
    meta = {"version": __version__, "names": names, "config": config_yaml, **(extra_meta or {})}
    payload = {f"draw_{k}": np.asarray(v) for k, v in draws.items()}
    if state:
        payload.update({f"state_{k}": np.asarray(v) for k, v in state.items()})
    payload["meta_json"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    _savez_atomic(d, path, payload)
    _log.info("Saved chain to %s (%d draw arrays)", path, len(draws))


def load_chain(path: str) -> tuple[dict[str, np.ndarray], dict[str, Any], dict[str, np.ndarray]]:
    """Returns (draws, meta, state); a sharded chain's draws are concatenated
    from its part files."""
    with np.load(path, allow_pickle=False) as f:
        meta = json.loads(bytes(f["meta_json"]).decode())
        draws = {k[5:]: f[k] for k in f.files if k.startswith("draw_")}
        state = {k[6:]: f[k] for k in f.files if k.startswith("state_")}
    if meta.get("shards"):
        parts = list(iter_chain_shards(path, meta))
        draws = {k: np.concatenate([p[k] for p in parts], axis=0) for k in parts[0]}
    return draws, meta, state


def iter_chain_shards(path: str, meta: dict | None = None):
    """Stream a sharded chain one chunk at a time (bounded memory): the
    reading twin of :class:`ChainShardWriter`. Yields draw dicts."""
    if meta is None:
        with np.load(path, allow_pickle=False) as f:
            meta = json.loads(bytes(f["meta_json"]).decode())
    for part in meta.get("shards", []):
        with np.load(os.path.join(path + ".d", part), allow_pickle=False) as f:
            yield {k[5:]: f[k] for k in f.files if k.startswith("draw_")}


def _shard_steps(path: str) -> int:
    with np.load(path, allow_pickle=False) as f:
        first = [k for k in f.files if k.startswith("draw_")][0]
        return f[first].shape[0]


class ChainShardWriter:
    """Streaming chain storage: one compressed shard per chunk.

    Holds only the current chunk in host RAM: each ``append`` atomically
    writes ``<path>.d/part-NNNNN.npz``; ``finalize`` writes the manifest
    chain file (meta + shard list, no draws) that ``load_chain`` /
    ``iter_chain_shards`` / ``combine_chains`` resolve. Constructed over an
    existing shard directory it continues the part numbering, so a resumed
    fit appends."""

    def __init__(self, path: str, names: list[str], config_yaml: str = "",
                 extra_meta: dict[str, Any] | None = None) -> None:
        self.path = path
        self.names = names
        self.config_yaml = config_yaml
        self.extra_meta = dict(extra_meta or {})
        self.shard_dir = path + ".d"
        os.makedirs(self.shard_dir, exist_ok=True)
        self.parts: list[str] = sorted(
            p for p in os.listdir(self.shard_dir) if p.startswith("part-") and p.endswith(".npz"))
        self.n_steps = sum(_shard_steps(os.path.join(self.shard_dir, p)) for p in self.parts)
        #: what the bounded-memory contract promises (tested)
        self.max_resident_bytes = 0
        self.disk_bytes = 0

    def append(self, draws: dict[str, np.ndarray]) -> None:
        """Write one chunk as the next shard (atomic), then forget it."""
        payload = {f"draw_{k}": np.asarray(v) for k, v in draws.items()}
        self.max_resident_bytes = max(self.max_resident_bytes,
                                      sum(v.nbytes for v in payload.values()))
        name = f"part-{len(self.parts):05d}.npz"
        _savez_atomic(self.shard_dir, os.path.join(self.shard_dir, name), payload)
        self.parts.append(name)
        self.n_steps += next(iter(draws.values())).shape[0]
        self.disk_bytes += os.path.getsize(os.path.join(self.shard_dir, name))

    def truncate(self, n_steps: int) -> None:
        """Drop shard steps beyond ``n_steps`` (crash consistency: a kill can
        land after a shard write but before its checkpoint, leaving the
        shards one chunk ahead of the resumable state)."""
        if self.n_steps <= n_steps:
            return
        kept: list[str] = []
        cum = 0
        for p in self.parts:
            path = os.path.join(self.shard_dir, p)
            with np.load(path, allow_pickle=False) as f:
                keys = [k for k in f.files if k.startswith("draw_")]
                s = f[keys[0]].shape[0]
                take = min(s, max(0, n_steps - cum))
                partial = {k: f[k][:take] for k in keys} if 0 < take < s else None
            if take == s:
                kept.append(p)
            else:
                os.remove(path)
                if partial is not None:
                    _savez_atomic(self.shard_dir, path, partial)
                    kept.append(p)
            cum += take
        self.parts = kept
        self.n_steps = cum
        _log.info("Truncated chain shards to %d steps (%d parts)", cum, len(kept))

    def finalize(self, state: dict[str, np.ndarray] | None = None) -> None:
        """Write the manifest chain file referencing the shards."""
        save_chain(self.path, {}, self.names, self.config_yaml,
                   extra_meta={**self.extra_meta, "shards": self.parts, "n_steps": self.n_steps},
                   state=state)


def combine_chains(paths: list[str], out_path: str, check: bool = True) -> None:
    """Merge chain files along the step axis, refusing differing versions,
    configs or parameter names (``CombineMaCh3Chains.cpp`` header checks)."""
    if not paths:
        raise MaCh3Error("No chain files to combine")
    all_draws, metas = [], []
    for p in paths:
        draws, meta, _ = load_chain(p)
        all_draws.append(draws)
        metas.append(meta)
    if check:
        ref = metas[0]
        for p, m in zip(paths[1:], metas[1:]):
            if m.get("version") != ref.get("version"):
                raise MaCh3Error(f"Version mismatch: {paths[0]} has {ref.get('version')}, "
                                 f"{p} has {m.get('version')}")
            if m.get("config") != ref.get("config"):
                raise MaCh3Error(f"Config mismatch between {paths[0]} and {p}")
            if m.get("names") != ref.get("names"):
                raise MaCh3Error(f"Parameter-name mismatch between {paths[0]} and {p}")
    merged = {k: np.concatenate([d[k] for d in all_draws], axis=0) for k in all_draws[0]}
    save_chain(out_path, merged, metas[0]["names"], metas[0].get("config", ""),
               extra_meta={"combined_from": paths})


_GENERATOR = "#generator"


def save_checkpoint(path: str, fitter, names: list[str], config_yaml: str = "",
                    state=None) -> None:
    """Persist a sampler's whole state for resume (no draws): every field of
    its state dataclass (``fitters.mcmc.state_leaves``; MR2T2's θ, nll,
    ``n_accepted``, ``step`` and adaptive moments, HMC's as well), the
    generator as its ``get_state()`` bytes. ``state``: the snapshot to save,
    default the fitter's live state; a run's callback passes the state it
    was given."""
    from ..fitters.mcmc import state_leaves

    out = {}
    for k, v in state_leaves(fitter.state if state is None else state).items():
        if isinstance(v, torch.Generator):
            out["st." + k + _GENERATOR] = v.get_state().numpy()
        elif isinstance(v, torch.Tensor):
            out["st." + k] = v.detach().cpu().numpy()
        elif v is not None:
            out["st." + k] = np.asarray(v)
    save_chain(path, {}, names, config_yaml, state=out)


def load_checkpoint(path: str, fitter) -> None:
    """Restore a fitter's state from a checkpoint of this package, in place:
    its tensors are copied into the fitter's (so a captured CUDA graph keeps
    reading them), its generator state set, its host numbers replaced. The
    fitter must have the configuration of the one saved: a field missing on
    either side, or of another shape, raises."""
    from ..fitters.mcmc import state_leaves

    _, _, saved = load_chain(path)
    saved = {k[3:]: v for k, v in saved.items() if k.startswith("st.")}
    live = state_leaves(fitter.state)
    expect = {k + _GENERATOR if isinstance(v, torch.Generator) else k
              for k, v in live.items() if v is not None}
    if set(saved) != expect:
        raise KeyError(
            f"checkpoint {path} does not match the resuming fitter's state: missing "
            f"{sorted(expect - set(saved))}, not declared {sorted(set(saved) - expect)}; "
            "it was written by a fitter with a different configuration")
    for k, v in live.items():
        if isinstance(v, torch.Generator):
            v.set_state(torch.from_numpy(saved[k + _GENERATOR]))
        elif isinstance(v, torch.Tensor):
            if tuple(v.shape) != saved[k].shape:
                raise KeyError(f"checkpoint {path}: {k} has shape {saved[k].shape}, the "
                               f"resuming fitter's {tuple(v.shape)}")
            v.copy_(torch.from_numpy(saved[k]))
        elif v is not None:
            *owners, field = k.split(".")
            holder = fitter.state
            for part in owners:
                holder = getattr(holder, part)
            setattr(holder, field, type(v)(saved[k]))
    step = saved.get("step")
    _log.info("Resumed fit at step %d from %s", int(step) if step is not None else -1, path)
