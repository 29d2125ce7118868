"""Process-group set-up (counterpart of the JAX ``parallel/multihost.py``).

Every process runs the same program; :func:`initialize_from_env` joins them
into one default process group from explicit arguments or from the
environment that ``torchrun`` (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``) or SLURM (``SLURM_PROCID``,
``SLURM_NTASKS``, ``SLURM_LOCALID``) sets. The backend is NCCL for ranks on
cards and gloo where the caller asks for the CPU or for gloo (ranks that
share one card must use gloo: NCCL refuses two ranks of one communicator on
one device). Unlike JAX's, a failed initialization raises: a run that was
asked for several processes never goes on as one.

Each rank loads only its own events (:func:`local_batch_to_global`);
:func:`spawn` starts a group of ranks on one machine over a ``FileStore``
(tests, ``chip_smoke.py``).

Typical use, one process per card::

    torchrun --nproc-per-node 4 train.py   # in train.py:
    initialize_from_env()                  # False (a no-op) in one process
    mesh = make_mesh(n_data=2, n_graph=2)
"""

from __future__ import annotations

import datetime
import logging
import os

import torch
import torch.distributed as dist

from gnn_tracking_tpu_torch.parallel.mesh import all_reduce_

logger = logging.getLogger(__name__)


def _env_int(*names: str) -> int | None:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def initialize(rank: int, world_size: int, init_method: str, *, backend: str | None = None,
               device: str | torch.device = "cuda", timeout_s: float = 600.0) -> str:
    """``dist.init_process_group`` for rank ``rank`` of ``world_size`` (at
    any size, one included) at ``init_method`` (``file://...``,
    ``tcp://host:port`` or ``env://``); ``backend`` None takes NCCL for a
    CUDA ``device`` and gloo for the CPU. Sets this rank's card. Returns the
    backend."""
    dev = torch.device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK", "SLURM_LOCALID")
        torch.cuda.set_device((rank if local is None else local) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    logger.info("process group up: rank %d of %d, %s", rank, world_size, backend)
    return backend


def initialize_from_env(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    device: str | torch.device = "cuda",
) -> bool:
    """Join the default process group from explicit arguments or the
    environment; True if this is a multi-process run.

    ``coordinator_address`` is ``host:port`` (-> ``tcp://``) or a URL
    (``file://...``, ``tcp://...``); without it ``MASTER_ADDR`` /
    ``MASTER_PORT`` are read (``env://``). One process (``num_processes``,
    ``WORLD_SIZE`` or ``SLURM_NTASKS`` at most 1, or none of them set) is a
    no-op returning False. Raises where the group cannot be made."""
    n = num_processes if num_processes is not None else _env_int("WORLD_SIZE", "SLURM_NTASKS")
    if n is None or n <= 1:
        logger.debug("single-process run: no process group")
        return False
    if dist.is_initialized():
        return True
    rank = process_id if process_id is not None else _env_int("RANK", "SLURM_PROCID")
    if rank is None:
        msg = f"{n} processes but no rank: pass process_id or set RANK / SLURM_PROCID"
        raise ValueError(msg)
    if coordinator_address is None:
        if not {"MASTER_ADDR", "MASTER_PORT"} <= set(os.environ):
            msg = "no coordinator: pass coordinator_address or set MASTER_ADDR and MASTER_PORT"
            raise ValueError(msg)
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    initialize(rank, n, init_method, backend=backend, device=device)
    return True


def local_batch_to_global(local_batch: list, mesh) -> list:
    """This rank's part of the global batch: each rank loads only its own
    events (JAX assembles a global array from them; here the data group's
    gradient mean makes the step global). Checks that every data rank has
    as many events as this one."""
    counts = torch.tensor([len(local_batch), -len(local_batch)], device=mesh.device)
    all_reduce_(counts, mesh.group("data"), dist.ReduceOp.MAX)
    if int(counts[0]) != -int(counts[1]):
        msg = f"data ranks hold {-int(counts[1])} to {int(counts[0])} events; each must hold as many"
        raise ValueError(msg)
    return list(local_batch)


def _rank_main(rank, fn, nprocs, init_method, backend, device, timeout_s, args):
    initialize(rank, nprocs, init_method, backend=backend, device=device, timeout_s=timeout_s)
    try:
        fn(rank, nprocs, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, nprocs: int, args: tuple = (), *, store_file: str, backend: str = "gloo",
          device: str | torch.device = "cuda", timeout_s: float = 300.0) -> None:
    """Run ``fn(rank, nprocs, *args)`` in ``nprocs`` fresh processes
    (``spawn``), each a rank of one default process group over a
    ``FileStore`` at ``store_file`` (no port), on the card unless ``device``
    asks for the CPU; waits for all, and raises with a rank's traceback
    where one fails. ``fn`` must be importable by name (a module-level
    function)."""
    import torch.multiprocessing as mp

    mp.start_processes(
        _rank_main, args=(fn, nprocs, f"file://{store_file}", backend, device, timeout_s, args),
        nprocs=nprocs, join=True, start_method="spawn",
    )
