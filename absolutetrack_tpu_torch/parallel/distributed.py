"""Process groups and cross-process reductions (port of
``absolutetrack_tpu/parallel/distributed.py``).

JAX runs one process per host, each holding several devices, and
``jax.distributed.initialize`` joins the hosts. PyTorch runs one process
per device: a ``torch.distributed`` process group of one rank per card,
launched by ``torchrun`` (or ``python -m torch.distributed.run``).

  * ``init_distributed``: ``init_process_group`` from explicit arguments
    or torchrun's environment (``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``); with neither it creates no group and
    returns (0, 1), as JAX's single-host no-op does. The backend is a
    parameter: NCCL for a card, gloo for the CPU. NCCL refuses two ranks
    on one card, so two ranks sharing a card run gloo.
  * ``process_shard``: this process's (rank, world size).
  * ``allreduce_metrics``: JAX's float32 gather-then-sum of the metric
    sums, in rank order.
  * ``all_gather``/``all_gather_objects``: the collectives the port's
    sharded paths use.
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..utils.runtime import resolve_device

# a rank that died fails its peers' collectives after this long instead of hanging them
TIMEOUT = datetime.timedelta(seconds=120)


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def default_backend(device) -> str:
    """NCCL for a card, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device=None) -> torch.device:
    """The device of this rank: ``device`` (``cuda`` unless given); a card
    named without an index is the rank's local one, ``LOCAL_RANK`` (else
    the rank) modulo the visible cards, so ranks that share one card all
    take ``cuda:0``."""
    device = resolve_device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def _init_method(address: str) -> str:
    """A JAX-style ``host:port`` becomes ``tcp://host:port``; ``tcp://``,
    ``file://`` and ``env://`` pass as they are."""
    return address if "://" in address else f"tcp://{address}"


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> Tuple[int, int]:
    """Join the process group; returns (rank, world size).

    The explicit arguments come first, then torchrun's environment. With
    nothing configured it creates no group and returns (0, 1). A group
    that exists already is returned as it is (its world size must agree).
    ``backend`` defaults to NCCL for a CUDA ``device`` (``cuda`` unless
    given) and gloo for the CPU.
    """
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = "env://"  # torchrun's store, at MASTER_ADDR:MASTER_PORT
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if initialized():
        if num_processes is not None and num_processes != dist.get_world_size():
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks exists; {num_processes} were asked for"
            )
        return dist.get_rank(), dist.get_world_size()
    if coordinator_address is None and num_processes is None:
        return 0, 1  # one process
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("a process group needs the coordinator's address, the number of processes and this rank")
    backend = backend or default_backend(resolve_device(device))
    if backend == "nccl":
        # NCCL's collectives run on the current card
        local = int(env.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend,
        init_method=_init_method(coordinator_address),
        world_size=num_processes,
        rank=process_id,
        timeout=TIMEOUT,
    )
    return dist.get_rank(), dist.get_world_size()


def process_shard() -> Tuple[int, int]:
    """(rank, world size) for dataset sharding on this process; (0, 1)
    without a process group."""
    if not initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order, (world, ...), on ``x``'s
    device. gloo implements only some of its collectives for CUDA tensors,
    so under gloo a card's tensor is copied to the host for the exchange
    and back (both ranks of a shared card run gloo); NCCL exchanges on the
    current card."""
    world = dist.get_world_size()
    if dist.get_backend() == "nccl":
        staged = x.to(torch.device("cuda", torch.cuda.current_device()))
    else:
        staged = x.cpu()
    staged = staged.contiguous()
    out = [torch.empty_like(staged) for _ in range(world)]
    dist.all_gather(out, staged)
    return torch.stack(out).to(x.device)


def all_gather_objects(obj) -> List:
    """Every rank's picklable ``obj`` in rank order."""
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def allreduce_metrics(metrics: Dict[str, float]) -> Dict[str, float]:
    """Sum per-process scalar metric dicts over every process.

    Each process passes its local sums (e.g. err_sum, err_count); the
    result is identical on every process. As JAX computes it: the keys
    sorted, one float32 vector a process, gathered in rank order and
    summed over processes by numpy in float32 (not an all-reduce, whose
    summation order is the library's). One process: the input.
    """
    if process_shard()[1] == 1:
        return dict(metrics)
    keys = sorted(metrics)
    local = torch.from_numpy(np.asarray([metrics[k] for k in keys], np.float32))
    gathered = all_gather(local).numpy()  # (n_proc, n_keys)
    total = np.sum(gathered, axis=0)
    return {k: float(total[i]) for i, k in enumerate(keys)}
