"""Process-group bootstrap — counterpart of ``parallel/distributed.py`` in
the JAX package (``maybe_initialize``, ``:20-41``).

A rank is one process driving one device. Two launchers start ranks:

  * ``torchrun`` (or any launcher that sets ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``, the roles
    of the JAX package's ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``
    and ``JAX_PROCESS_ID``): ``maybe_initialize()`` joins its group;
  * ``launch_local``, which the CLIs call when ``--mesh_devices`` or
    ``--spatial_shards`` wants N > 1 ranks and no launcher started the
    process: N local processes joined through a file under a fresh
    temporary directory.

The backend is explicit (``backend_for``): NCCL for ranks on distinct CUDA
devices, gloo for CPU ranks and for ranks that share a card (NCCL refuses
two ranks on one device; gloo stages CUDA tensors through the host). A
group that fails to start raises: nothing falls back to another backend.
Every group has a finite timeout, so a rank that never joins, or a
collective that a peer never enters, raises instead of hanging.
"""

from __future__ import annotations

import datetime
import importlib
import os
import shutil
import tempfile
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0


def _timeout(seconds: Optional[float]) -> datetime.timedelta:
    return datetime.timedelta(seconds=DEFAULT_TIMEOUT_S if seconds is None else seconds)


def rank_devices(gpu_ids: str, world_size: int) -> List[torch.device]:
    """The device of each rank: the CPU under ``--gpu_ids -1``; else rank r
    takes the r-th listed CUDA id when ``--gpu_ids`` lists enough ids, and
    ``cuda:r`` otherwise."""
    ids = [int(i) for i in str(gpu_ids).split(",") if i.strip() != ""]
    if not ids or ids[0] < 0:
        return [torch.device("cpu")] * world_size
    return [torch.device("cuda", ids[r] if r < len(ids) else r) for r in range(world_size)]


def backend_for(devices: Sequence[torch.device]) -> str:
    """gloo for CPU ranks and for ranks that share a card, NCCL otherwise."""
    if devices[0].type != "cuda":
        return "gloo"
    if len(set(devices)) < len(devices):
        print(f"[dist] {len(devices)} ranks on {len(set(devices))} card(s): NCCL cannot place "
              "two ranks on one device, so the group runs over gloo", flush=True)
        return "gloo"
    return "nccl"


def maybe_initialize(init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None,
                     device: Optional[torch.device] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Join the process group from the arguments, else from the standard
    launcher environment; returns True when this call started the group.
    Idempotent (False once a group exists) and a no-op returning False for a
    single-process job (no ``init_method`` and no ``MASTER_ADDR`` /
    ``WORLD_SIZE``), as the JAX function is. ``backend`` defaults to NCCL
    for a CUDA ``device`` and gloo otherwise; under NCCL the rank's device
    becomes the current CUDA device first."""
    if dist.is_initialized():
        return False
    env = os.environ
    if init_method is None:
        if not env.get("MASTER_ADDR") or not env.get("WORLD_SIZE"):
            return False
        init_method = "env://"
    world_size = int(env["WORLD_SIZE"] if world_size is None else world_size)
    rank = int(env.get("RANK", "0") if rank is None else rank)
    device = torch.device("cpu") if device is None else torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=_timeout(timeout_s))
    return True


def initialize_for(gpu_ids: str) -> bool:
    """``maybe_initialize`` from a launcher's environment, with the device
    ``--gpu_ids`` gives this local rank (``rank_devices``) and the backend
    those devices call for (``backend_for``); False with no launcher."""
    env = os.environ
    if dist.is_initialized() or not env.get("MASTER_ADDR") or not env.get("WORLD_SIZE"):
        return False
    local = int(env.get("LOCAL_RANK", env.get("RANK", "0")))
    devices = rank_devices(gpu_ids, int(env.get("LOCAL_WORLD_SIZE", env["WORLD_SIZE"])))
    return maybe_initialize(backend=backend_for(devices), device=devices[local])


def local_rank() -> int:
    """This process's rank on its host (0 outside a group)."""
    return int(os.environ.get("LOCAL_RANK", "0")) if dist.is_initialized() else 0


def shutdown(started: bool) -> None:
    """Destroy the group if ``maybe_initialize`` started it in this call."""
    if started and dist.is_initialized():
        dist.destroy_process_group()


def _rank_entry(rank: int, module: str, argv: Sequence[str], world_size: int, init_method: str,
                backend: str, devices: Sequence[torch.device], timeout_s: Optional[float]):
    """One spawned rank: the launcher environment set as ``torchrun`` sets
    it, the group joined, ``module.main(argv)`` run, the group destroyed."""
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world_size))
    if devices[rank].type == "cpu":
        torch.set_num_threads(1)
    maybe_initialize(init_method, world_size, rank, backend, devices[rank], timeout_s)
    try:
        importlib.import_module(module).main(list(argv))
    finally:
        shutdown(True)


def spawn(fn, nprocs: int, args=(), join_timeout_s: Optional[float] = None):
    """``fn(rank, *args)`` in ``nprocs`` fresh (spawned) processes, joined:
    a rank that raises ends the others and raises here; past
    ``join_timeout_s`` every rank is ended and TimeoutError raised."""
    import time

    import torch.multiprocessing as mp

    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False, start_method="spawn")
    deadline = None if join_timeout_s is None else time.monotonic() + join_timeout_s
    try:
        while not ctx.join(timeout=5.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after {join_timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)


def launch_local(module: str, argv: Sequence[str], world_size: int, gpu_ids: str,
                 timeout_s: Optional[float] = None) -> None:
    """Run ``module.main(argv)`` as ``world_size`` local ranks (the CLIs'
    launcher when no ``torchrun`` started them), joined through a file
    under a temporary directory that is removed afterwards."""
    devices = rank_devices(gpu_ids, world_size)
    backend = backend_for(devices)
    tmp = tempfile.mkdtemp(prefix="himan_dist_")
    try:
        spawn(_rank_entry, world_size, args=(module, list(argv), world_size,
                                             f"file://{os.path.join(tmp, 'init')}", backend,
                                             devices, timeout_s))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
