"""Process-group initialization and the multi-host mesh
(counterpart of ``specdec_tpu/parallel/distributed.py``).

The port runs one process per card. ``init_distributed`` joins this
process to the world: from its arguments, from the JAX package's variables
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``) or from
torchrun's (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).
``build_multihost_mesh`` then lays 'model' within a host and 'data'
across hosts, so tensor-parallel collectives stay on a host's NVLink and
only batch-level traffic crosses hosts:

    # on every rank: torchrun --nproc-per-node 8 --nnodes 2 ... script.py
    init_distributed()
    mesh = build_multihost_mesh()        # 'model' = 8 per host, 'data' = 2
"""
from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

from specdec_tpu_torch.parallel.mesh import Mesh, build_mesh


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.getenv(name):
            return int(os.environ[name])
    return None


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device=None) -> bool:
    """``torch.distributed.init_process_group`` with the JAX package's
    environment fallbacks (``COORDINATOR_ADDRESS`` as ``host:port``,
    ``NUM_PROCESSES``, ``PROCESS_ID``) and torchrun's (``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``). Returns False, and joins
    nothing, for a single process; True once the world is up (also when it
    already was).

    ``backend`` defaults to NCCL for a CUDA ``device`` (``None``: the card)
    and to gloo for the CPU; a caller may name either. Under NCCL the rank
    takes card ``LOCAL_RANK`` (default: its rank modulo the cards)."""
    if dist.is_initialized():
        return True
    address = coordinator_address or os.getenv("COORDINATOR_ADDRESS")
    world = num_processes or _env_int("NUM_PROCESSES", "WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("PROCESS_ID",
                                                              "RANK")
    if address is None and os.getenv("MASTER_ADDR"):
        address = (f"{os.environ['MASTER_ADDR']}:"
                   f"{os.getenv('MASTER_PORT', '29500')}")
    if address is None and (world or 1) == 1:
        return False
    if address is None or world is None or rank is None:
        raise ValueError(
            "init_distributed needs a coordinator address, a process count "
            f"and a process id (got {address!r}, {world!r}, {rank!r}): set "
            "COORDINATOR_ADDRESS, NUM_PROCESSES and PROCESS_ID, or launch "
            "with torchrun")
    dev = torch.device("cuda" if device is None else device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device(local if local is not None
                              else rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world, rank=rank)
    return True


def _host_key() -> str:
    """This rank's host: torchrun's node rank where set, else the host
    name."""
    node = os.getenv("GROUP_RANK") or os.getenv("NODE_RANK")
    return f"node {node}" if node is not None else socket.gethostname()


def build_multihost_mesh(tp: Optional[int] = None, device=None) -> Mesh:
    """('data' across hosts) x ('model' within a host). ``tp`` defaults to
    the ranks on this host (``LOCAL_WORLD_SIZE``, else the ranks sharing
    its host), so the model axis never crosses hosts; the ranks are ordered
    host-major (hosts in the order of their lowest rank). ``device`` as
    ``build_mesh``'s (``None``: this rank's card)."""
    world = dist.get_world_size()
    hosts = [None] * world
    dist.all_gather_object(hosts, _host_key())
    by_host: dict = {}
    for r, h in enumerate(hosts):
        by_host.setdefault(h, []).append(r)
    tp = tp or _env_int("LOCAL_WORLD_SIZE") or len(by_host[_host_key()])
    if world % tp:
        raise ValueError(f"ranks ({world}) not divisible by tp ({tp})")
    flat = [r for h in sorted(by_host, key=lambda h: by_host[h][0])
            for r in by_host[h]]
    return build_mesh(flat, tp=tp, device=device)
