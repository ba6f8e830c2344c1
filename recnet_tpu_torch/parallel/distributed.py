"""Multi-process training over ``torch.distributed``: the bootstrap, the
rank's device and the host-side helpers.

Port of ``recnet_tpu.parallel.distributed``. One process per device, every
process running the same loop (``training.loop.train(use_mesh=True)``);
``parallel.mesh`` names the processes' axes and the step sums over them.
What is particular to several processes lives here:

* :func:`initialize` joins the process group (flags, or torchrun's
  environment: ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``,
  ``MASTER_PORT``) and fixes the rank's device;
* :func:`put_global` hands a rank its slice of a global batch;
* :func:`is_primary` gates host-side side effects (checkpoint writes, logs,
  stdout, predictions.txt) to rank 0; :func:`barrier` lets the ranks leave
  together.

As in the JAX package, every process loads the whole dataset and builds the
whole global batch from the same seed, then keeps only its slice: the batch
composition and the shuffle order are those of a single-process run, so
runs over different numbers of processes can be compared number for
number.

The backend is NCCL when the device is the card and gloo on the CPU;
``cpu_collectives="gloo"`` asks for gloo on the card by name (it stages
CUDA tensors through host memory, and takes more than one rank on one
card, which NCCL refuses). Nothing falls back: a rank without its card
raises, and an NCCL failure is not retried on gloo.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist

_DEVICE: Optional[torch.device] = None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               cpu_collectives: Optional[str] = None,
               device: str = "cuda") -> None:
    """Join the process group; a no-op for a single-process run.

    Call it before anything touches a device. Any one signal engages a
    group: a process count (``num_processes`` or ``WORLD_SIZE``), a
    coordinator (``coordinator_address`` "host:port", or ``MASTER_ADDR``)
    or a process id (``process_id`` or ``RANK``). A count of 1 or less is a
    single-process run. A process id without a count or a coordinator
    raises ``ValueError``, as does a coordinator without a count: each
    process would otherwise train a detached model of its own.

    With ``device="cuda"`` the rank's device is the card named by the
    first of ``local_device_ids``, else by ``LOCAL_RANK``, else by the rank
    modulo the host's cards; with ``device="cpu"`` it is the CPU. The
    backend is NCCL on the card, gloo on the CPU, or gloo where
    ``cpu_collectives="gloo"`` asks for it."""
    env = os.environ
    count = (num_processes if num_processes is not None
             else int(env["WORLD_SIZE"]) if "WORLD_SIZE" in env else None)
    rank = (process_id if process_id is not None
            else int(env["RANK"]) if "RANK" in env else None)
    coord = coordinator_address
    if coord is None and "MASTER_ADDR" in env:
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if count is None and coord is None and rank is None:
        return                                  # single-process run
    if count is not None and count <= 1:
        return
    if count is None:
        raise ValueError(
            "distributed.initialize: a process id or a coordinator is set "
            "but no process count (--num_processes / WORLD_SIZE); each "
            "process would train a model of its own")
    if rank is None:
        raise ValueError(
            "distributed.initialize: a process count is set but no process "
            "id (--process_id / RANK)")
    if coord is None:
        raise ValueError(
            "distributed.initialize: no coordinator address "
            "(--coordinator host:port / MASTER_ADDR and MASTER_PORT)")
    if cpu_collectives not in (None, "gloo"):
        raise ValueError(f"cpu_collectives {cpu_collectives!r}: only "
                         "'gloo' is supported")
    global _DEVICE
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"rank {rank}: device 'cuda' requested but CUDA is not "
                "available; pass device='cpu' to run the group on the CPU")
        local = (local_device_ids[0] if local_device_ids
                 else int(env["LOCAL_RANK"]) if "LOCAL_RANK" in env
                 else rank % torch.cuda.device_count())
        _DEVICE = torch.device("cuda", local)
        torch.cuda.set_device(_DEVICE)
        backend = cpu_collectives or "nccl"
    else:
        _DEVICE = torch.device("cpu")
        backend = "gloo"
    tdist.init_process_group(backend, init_method=f"tcp://{coord}",
                             world_size=count, rank=rank)


def is_initialized() -> bool:
    """Whether this process is a rank of a process group."""
    return tdist.is_available() and tdist.is_initialized()


def device() -> torch.device:
    """This rank's device: the one :func:`initialize` fixed; for a group
    the caller made itself (``init_process_group``), the current card
    under NCCL and the CPU under gloo."""
    if _DEVICE is not None:
        return _DEVICE
    if not is_initialized():
        raise RuntimeError("this process is not a rank of a process group")
    if tdist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def process_count() -> int:
    return tdist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return tdist.get_rank() if is_initialized() else 0


def is_primary() -> bool:
    """True on the process that owns host-side side effects (rank 0)."""
    return process_index() == 0


def is_multihost() -> bool:
    return process_count() > 1


def barrier() -> None:
    """Wait for every rank (the JAX loop's ``sync_global_devices``)."""
    if is_initialized():
        tdist.barrier()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    global _DEVICE
    if is_initialized():
        tdist.destroy_process_group()
    _DEVICE = None


def put_global(x, sharding) -> torch.Tensor:
    """This rank's part of ``x``, the FULL global array that every rank
    builds alike, on the rank's device: its slice under
    ``mesh.batch_sharding`` or the whole array under ``mesh.replicated``.
    The copy to a card goes through pinned memory without blocking."""
    return to_device(sharding.part(x), sharding.mesh.device)


def to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A numpy array as a tensor on ``dev``; to a card through pinned
    memory, without blocking (the caching host allocator keeps the pinned
    block until the copy that reads it has run)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t.to(dev)


def fetch_replicated(x) -> np.ndarray:
    """Device -> host for a value every rank holds in full (a replicated
    leaf, a loss). A vocab shard is gathered with ``mesh.gather_params``
    first."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)
