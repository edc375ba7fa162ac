"""Process groups and the local launcher (port of
``commefficient_tpu/parallel/distributed.py``).

The reference joins a JAX cluster with ``jax.distributed.initialize()``
and then sees every chip of the slice in one program. PyTorch runs one
process per rank instead, joined by ``torch.distributed``:

* under ``torchrun`` (``WORLD_SIZE`` set) ``initialize()`` joins through
  ``env://``;
* otherwise ``launch(target, nprocs, args)`` starts ``nprocs`` local
  ranks itself with the ``spawn`` method, each joining through
  ``tcp://localhost:<free port>``, and runs ``target(*args)`` in each.
  ``target`` is a module-level function of this package, so a child
  imports torch and the port only. A group of one runs in the calling
  process.

The backend follows the device: ``nccl`` for ``cuda``, ``gloo`` for
``cpu``. A caller may ask for ``gloo`` on CUDA tensors (``backend=``):
gloo stages them through the host, which lets several ranks share one
card, where NCCL refuses a second rank on a device it already holds.
Rank ``r`` runs on ``cuda:{local_rank}``; more ranks than cards raises
under NCCL, and shares the cards round-robin under gloo.

Every rank must feed identical batches (the same sampler seed), the
reference's multi-host contract; each takes its own slice of them.
"""

from __future__ import annotations

import ctypes
import os
import signal
import socket
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist


def default_backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


def free_port() -> int:
    """A free TCP port on localhost for the rendezvous."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def rank_device(device_type: str, local_rank: int,
                backend: Optional[str] = None) -> torch.device:
    """The device rank ``local_rank`` runs on, made current on CUDA."""
    if device_type != "cuda":
        return torch.device(device_type)
    count = torch.cuda.device_count()
    backend = backend or default_backend(device_type)
    if local_rank >= count and backend == "nccl":
        raise RuntimeError(
            f"rank {local_rank} needs cuda:{local_rank}, but only {count} "
            f"CUDA device(s) are visible; NCCL cannot put two ranks on one "
            f"device (pass backend='gloo' to share a card)")
    dev = torch.device("cuda", local_rank % count)
    torch.cuda.set_device(dev)
    return dev


def initialize(init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               backend: Optional[str] = None,
               device_type: str = "cpu") -> None:
    """Join the process group; a no-op when this process has joined one.

    With no ``init_method``, ``WORLD_SIZE``/``RANK`` come from the
    environment (``torchrun``'s ``env://``); without them this process is
    a group of one on a free local port."""
    if dist.is_initialized():
        return
    backend = backend or default_backend(device_type)
    if init_method is None:
        if "WORLD_SIZE" in os.environ:
            init_method = "env://"
        else:
            init_method = f"tcp://localhost:{free_port()}"
            world_size, rank = 1, 0
    local_rank = int(os.environ.get("LOCAL_RANK", rank or 0))
    rank_device(device_type, local_rank, backend)
    kw = {} if init_method == "env://" else dict(world_size=world_size,
                                                 rank=rank)
    dist.init_process_group(backend, init_method=init_method, **kw)


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0 (or no group): the one process that prints and logs."""
    return rank() == 0


def is_multihost() -> bool:
    """Whether the group spans more than this host's processes."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size()))
    return world_size() > local


def local_worker_slice(num_workers: int) -> slice:
    """This process's slice of the per-round worker batch."""
    n = world_size()
    if num_workers % n:
        raise ValueError(f"num_workers ({num_workers}) must be divisible "
                         f"by process_count ({n})")
    per = num_workers // n
    i = rank()
    return slice(i * per, (i + 1) * per)


def _die_with_parent() -> None:
    """SIGKILL this child when its parent dies (Linux ``PR_SET_PDEATHSIG``),
    so that no rank outlives a killed launcher."""
    try:
        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)
    except OSError:
        pass


def _rank_entry(rank_: int, nprocs: int, init_method: str, backend: str,
                device_type: str, target: Callable, args: tuple,
                child: bool) -> None:
    if child:
        _die_with_parent()
        if device_type == "cpu":
            # nprocs ranks of many intra-op threads each oversubscribe the
            # cores, and OpenMP's spinning threads then slow every rank
            torch.set_num_threads(1)
    os.environ.update(RANK=str(rank_), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank_), LOCAL_WORLD_SIZE=str(nprocs))
    initialize(init_method, nprocs, rank_, backend, device_type)
    try:
        target(*args)
    finally:
        dist.destroy_process_group()


def launch(target: Callable, nprocs: int, args: tuple = (),
           backend: Optional[str] = None, device_type: str = "cpu") -> None:
    """Run ``target(*args)`` on ``nprocs`` local ranks joined in one group.

    A group of one runs in this process; otherwise every rank is a
    spawned child (SIGTERM to the launcher reaches every child: the
    preemption contract holds for all ranks). A rank that fails stops the
    others, and the launcher then raises."""
    backend = backend or default_backend(device_type)
    init_method = f"tcp://localhost:{free_port()}"
    env_keys = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
    if nprocs == 1:
        saved = {k: os.environ.get(k) for k in env_keys}
        try:
            _rank_entry(0, 1, init_method, backend, device_type, target,
                        args, child=False)
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, nprocs, init_method, backend, device_type,
                               target, args, True))
             for r in range(nprocs)]
    for p in procs:
        p.start()

    def forward(signum, frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signum)
    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old[sig] = signal.signal(sig, forward)
        except ValueError:
            pass   # not the main thread
    try:
        while True:
            codes = [p.exitcode for p in procs]
            if any(c not in (None, 0) for c in codes):
                for p in procs:
                    if p.is_alive():
                        p.kill()
                for p in procs:
                    p.join()
                codes = [p.exitcode for p in procs]
                raise RuntimeError(f"a rank failed (exit codes {codes})")
            if all(c == 0 for c in codes):
                return
            time.sleep(0.05)
    finally:
        for sig, h in old.items():
            signal.signal(sig, h)


def run(target: Callable, nprocs: int, args: tuple = (),
        backend: Optional[str] = None, device_type: str = "cpu") -> None:
    """``target(*args)`` on every rank: in this process when ``torchrun``
    started it (``WORLD_SIZE`` set; it must match ``nprocs``), else on
    ``nprocs`` ranks from ``launch``."""
    if "WORLD_SIZE" not in os.environ:
        launch(target, nprocs, args, backend=backend,
               device_type=device_type)
        return
    if int(os.environ["WORLD_SIZE"]) != nprocs:
        raise ValueError(f"--mesh asks for {nprocs} ranks, torchrun "
                         f"started {os.environ['WORLD_SIZE']}")
    initialize(backend=backend, device_type=device_type)
    try:
        target(*args)
    finally:
        dist.destroy_process_group()
