"""Multi-process runtime: initialisation, per-row chain output and the
offline merge (port of ``mach3_tpu/distributed/multihost.py``).

The reference scales out by launching independent processes and merging
chain files offline (``Diagnostics/CombineMaCh3Chains.cpp``). Here the
processes of a fit form one ``torch.distributed`` world (one process per
card, as ``torchrun`` starts them), its mesh carries the step's collectives
(``mesh.py``, ``shard_step.py``), and each chain row writes its own chains
(:func:`save_host_shard`). Shards merge with the same version and config
checks as single-host combining; the files and their metadata keys
(``host``, ``n_hosts``, ``merged_hosts``) are the JAX package's, so either
package's merge reads the other's shards.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..core.logging import get_logger
from .mesh import even_slice, mesh_coordinate

_log = get_logger("distributed")


def initialise(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, device: str = "cuda",
               backend: str | None = None) -> torch.device | None:
    """Initialise the default process group; returns this process's device,
    or None for a single process (no ``WORLD_SIZE`` and no ``world_size``:
    nothing to initialise).

    Arguments default from ``torchrun``'s variables (``MASTER_ADDR`` /
    ``MASTER_PORT`` through ``env://``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``). On the card (``device="cuda"``) the process takes card
    ``LOCAL_RANK`` and NCCL, its communicator made at once (``device_id``);
    gloo serves ``device="cpu"``, or a caller who asks for it by ``backend``.
    """
    if world_size is None and os.environ.get("WORLD_SIZE"):
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and os.environ.get("RANK"):
        rank = int(os.environ["RANK"])
    if world_size is None:
        _log.info("Single-process run (no WORLD_SIZE)")
        return None
    local_rank = int(os.environ.get("LOCAL_RANK", rank or 0))
    kwargs = {}
    if device == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
        if backend == "nccl":
            kwargs["device_id"] = dev
    elif device == "cpu":
        dev = torch.device("cpu")
        backend = backend or "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, **kwargs)
    _log.info("torch.distributed initialised: rank %d of %d, %s on %s", dist.get_rank(),
              dist.get_world_size(), backend, dev)
    return dev


def local_chain_slice(n_chains_global: int, mesh) -> slice:
    """The chain-index slice of this rank's chain row (event shards of one
    row share its chains)."""
    row, _ = mesh_coordinate(mesh)
    return even_slice(n_chains_global, mesh.size(0), row)


def _host(mesh) -> tuple[int, int, bool]:
    """(host index, host count, whether this rank writes): a chain row of a
    mesh, its event column 0 writing; without a mesh each process."""
    if mesh is not None:
        row, col = mesh_coordinate(mesh)
        return row, mesh.size(0), col == 0
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), True
    return 0, 1, True


def save_host_shard(path_pattern: str, draws: dict[str, np.ndarray], names: list[str],
                    config_yaml: str = "", mesh=None) -> str | None:
    """Write this chain row's shard as ``path_pattern.format(host=row)`` and
    return its path; the row's other ranks (its event shards) write nothing
    and return None. Shards carry their host index and count so the merge
    can check completeness."""
    from ..diagnostics.chain_io import save_chain

    host, n_hosts, writes = _host(mesh)
    if not writes:
        return None
    path = path_pattern.format(host=host)
    save_chain(path, draws, names, config_yaml,
               extra_meta={"host": host, "n_hosts": n_hosts})
    return path


def merge_host_shards(paths: list[str], out_path: str) -> None:
    """Merge per-host shards along the chain axis (axis 1), enforcing
    matching version and config and complete host coverage."""
    from ..core.exceptions import MaCh3Error
    from ..diagnostics.chain_io import load_chain, save_chain

    loaded = [load_chain(p) for p in paths]
    ref_meta = loaded[0][1]
    hosts = sorted(m.get("host", 0) for _, m, _ in loaded)
    n_hosts = ref_meta.get("n_hosts", len(paths))
    if hosts != list(range(n_hosts)):
        raise MaCh3Error(f"Incomplete host shards: got {hosts}, expected 0..{n_hosts - 1}")
    for p, (_, m, _) in zip(paths[1:], loaded[1:]):
        if m.get("version") != ref_meta.get("version") or m.get("config") != ref_meta.get("config"):
            raise MaCh3Error(f"Version/config mismatch in shard {p}")
    order = np.argsort([m.get("host", 0) for _, m, _ in loaded])
    merged = {k: np.concatenate([loaded[i][0][k] for i in order], axis=1) for k in loaded[0][0]}
    save_chain(out_path, merged, ref_meta["names"], ref_meta.get("config", ""),
               extra_meta={"merged_hosts": int(n_hosts)})
