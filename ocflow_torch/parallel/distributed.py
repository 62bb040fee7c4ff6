"""Multi-process start-up and the rank-wide metrics (port of
``ocflow_tpu/parallel/distributed.py``): one process per rank, joined by
``torch.distributed``.

``initialize`` joins the process group: from explicit arguments (a
``tcp://host:port`` or ``file://path`` store, the world size and this
process's rank), or from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); with
neither it logs a single-process run and returns False. An explicit
configuration that fails raises: a mistyped address must not turn a
planned multi-process job into one process.

Backends: ``nccl`` when every rank has a GPU of its own (the default on
CUDA), ``gloo`` on the CPU and for ranks that share one GPU. NCCL refuses
two ranks on one GPU, so ``nccl`` with more local ranks than GPUs raises
and names ``backend="gloo"``; choosing gloo is printed (rank, backend,
device), never silent. Under gloo, CUDA tensors take part in ``all_reduce``
and ``broadcast``; ``all_gather`` and point-to-point go through the host
(``parallel.mesh.Mesh``).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

BACKENDS = ("nccl", "gloo")


def _init_method(address: str) -> str:
    if "://" in address:
        return address
    host, sep, port = address.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r}: want host:port, tcp://host:port "
                         "or file://path")
    return f"tcp://{address}"


def local_device(device=None, backend: str | None = None) -> torch.device:
    """The device of this rank: ``device`` when the caller names a CPU (or
    an indexed) device; else ``cuda:LOCAL_RANK`` under ``nccl`` (raising
    when there is no such GPU) and ``cuda:(LOCAL_RANK % device_count)``
    under gloo, ranks sharing the GPUs. Without CUDA, the CPU under gloo."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != "cuda" or dev.index is not None:
            return dev
    backend = backend or (dist.get_backend() if dist.is_initialized() else None)
    local = int(os.environ.get("LOCAL_RANK", 0))
    if not torch.cuda.is_available():
        if backend == "nccl" or (device is not None and torch.device(device).type == "cuda"):
            raise RuntimeError("CUDA is not available; pass device='cpu' (backend gloo) to "
                               "run on the CPU")
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if backend == "nccl" and local >= count:
        raise RuntimeError(f"local rank {local} has no GPU of its own ({count} GPUs): NCCL "
                           "refuses two ranks on one GPU; pass backend=\"gloo\" to share")
    return torch.device("cuda", local % count)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None, device=None,
               timeout: datetime.timedelta | None = None) -> bool:
    """Join the process group. Returns True when more than one process runs.

    - Explicit arguments (``coordinator_address``, ``num_processes``,
      ``process_id``): all three are needed, and a failure raises.
    - None of them: ``torchrun``'s environment when ``WORLD_SIZE`` is set
      (``env://``); otherwise a single-process run, logged, returning False.
    - Already initialized: nothing to do.

    ``backend``: ``nccl`` | ``gloo``, default ``nccl`` when ``device`` is
    CUDA (or unnamed and CUDA is available) and ``gloo`` otherwise. ``nccl``
    with more local ranks (``LOCAL_WORLD_SIZE``, else the world size) than
    GPUs raises. Under gloo the rank, the backend and the rank's device are
    printed once.
    """
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    if explicit:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError(
                "initialize: an explicit cluster configuration needs coordinator_address, "
                f"num_processes and process_id (got {coordinator_address!r}, "
                f"{num_processes!r}, {process_id!r})")
        if num_processes < 1 or not 0 <= process_id < num_processes:
            raise ValueError(f"initialize: process_id {process_id} outside a world of "
                             f"{num_processes}")
        init, world, rank = _init_method(coordinator_address), num_processes, process_id
    elif "WORLD_SIZE" in os.environ:
        init, world, rank = "env://", int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    else:
        log.info("single-process run: no cluster configuration and no torchrun environment")
        return False
    if backend is None:
        on_cuda = (torch.device(device).type == "cuda" if device is not None
                   else torch.cuda.is_available())
        backend = "nccl" if on_cuda else "gloo"
    if backend not in BACKENDS:
        raise ValueError(f"initialize: backend {backend!r}, want one of {BACKENDS}")
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        gpus = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if local_world > gpus:
            raise RuntimeError(
                f"initialize: backend nccl with {local_world} ranks on this host and {gpus} "
                "GPUs: NCCL refuses two ranks on one GPU; pass backend=\"gloo\" for ranks "
                "that share a GPU")
    dev = local_device(device, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"timeout": timeout} if timeout is not None else {}
    try:
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                **kwargs)
    except (RuntimeError, ValueError) as e:
        raise RuntimeError(
            f"initialize: init_process_group failed with {init!r}, world {world}, rank "
            f"{rank}, backend {backend}: {e}") from e
    if backend == "gloo":
        print(f"initialize: rank {rank} of {world}, backend gloo, device {dev}", flush=True)
    return world > 1


@contextlib.contextmanager
def process_group(backend: str | None = None, device=None):
    """:func:`initialize` from the environment for an entry point; yields
    whether several processes run, and destroys on exit the group it made
    (one that was running before is left as it is)."""
    made = not dist.is_initialized()
    multi = initialize(backend=backend, device=device)
    try:
        yield multi
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """Rank 0, or a single process: the one that logs and saves."""
    return not dist.is_initialized() or dist.get_rank() == 0


def local_shard_info() -> tuple[int, int]:
    """``(shard_index, num_shards)`` for per-process data loading."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def global_mean_metrics(metrics: dict, mesh=None) -> dict:
    """The mean over the ranks of each rank's ``{name: float}`` means, on
    every rank (all-gathered in fp64): decisions taken from them (the best
    checkpoint, early stopping) are the same on every rank. The identity
    for one process."""
    from ocflow_torch.parallel.mesh import make_mesh

    if world_size() == 1 or not metrics:
        return dict(metrics)
    mesh = mesh if mesh is not None else make_mesh()
    keys = list(metrics)
    vec = torch.tensor([float(metrics[k]) for k in keys], dtype=torch.float64,
                       device=mesh.device)
    mean = mesh.all_gather(vec[None]).mean(0)
    return dict(zip(keys, mean.tolist()))
