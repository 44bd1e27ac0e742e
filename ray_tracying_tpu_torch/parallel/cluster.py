"""Process-group setup for multi-device rendering, on torch.distributed.

One process a rank: every rank runs the same program, `initialize` joins
them in one process group, and the rays of a batch are split over the
ranks in equal, contiguous shares (`local_ray_slice`, sharding.py).  The
same code runs one rank, several ranks on one host and ranks on several
hosts.

Backends are chosen, never swapped: NCCL on CUDA tensors, one card a rank;
gloo on CPU tensors, or on CUDA tensors when several ranks share a card
(gloo reduces CUDA tensors through the host).  Every init and every
collective of the group carries `timeout_s` (at most two minutes by
default), so a rank that dies makes its peers fail instead of waiting out
the caller's clock.

`launch` starts the ranks of one host from a parent process, by spawn
(never fork: a parent that has touched CUDA cannot fork a child that uses
it), and fails if a rank fails or outlives its time.  It gives each rank
LOCAL_RANK and LOCAL_WORLD_SIZE, as torchrun does.

Port of the JAX package's parallel/cluster.py.
"""

from __future__ import annotations

import datetime
import logging
import os
import queue
import socket
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

log = logging.getLogger("ray_tracying_tpu_torch.cluster")

# Seconds an init or a collective may wait on a peer before it fails.
DEFAULT_TIMEOUT_S = 120.0


def choose_backend(backend: Optional[str], device_type: str, ranks_on_host: Optional[int],
                   n_cards: int) -> str:
    """The backend for `ranks_on_host` ranks on `device_type`: None is
    "nccl" on cuda and "gloo" on cpu.  NCCL takes CUDA tensors and one card
    a rank; asked for more ranks on this host than it has cards it raises
    (put several ranks on one card with backend="gloo").  ranks_on_host
    None: not known (ranks started by hand), so not checked."""
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {device_type!r}")
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be nccl or gloo, not {backend!r}")
    if backend == "nccl" and device_type != "cuda":
        raise ValueError("NCCL reduces CUDA tensors only; device='cpu' takes backend='gloo'")
    if backend == "nccl" and ranks_on_host is not None and ranks_on_host > n_cards:
        raise ValueError(
            f"NCCL needs one card a rank: {ranks_on_host} ranks on this host, "
            f"{n_cards} card(s); pass backend='gloo' to put several ranks on one card"
        )
    return backend


def host_layout(rank: int, n_cards: int) -> Tuple[int, Optional[int]]:
    """(this rank's index on its host, the ranks on its host or None), from
    torchrun's LOCAL_RANK / LOCAL_WORLD_SIZE.  Without them the ranks were
    started by hand on one host or several, which this process cannot tell
    apart: the local rank is taken as rank % n_cards (each host runs one
    rank a card, in rank order) and the ranks on the host as unknown."""
    local_rank = os.environ.get("LOCAL_RANK")
    on_host = os.environ.get("LOCAL_WORLD_SIZE")
    return (int(local_rank) if local_rank is not None else (rank % n_cards if n_cards else rank),
            int(on_host) if on_host is not None else None)


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise ValueError(
            f"{name} is not set: pass init_method, world_size and rank, or start the "
            "ranks with torchrun"
        )
    return int(value)


def initialize(
    init_method: Optional[str] = None,
    world_size: Optional[int] = None,
    rank: Optional[int] = None,
    backend: Optional[str] = None,
    retries: int = 5,
    backoff_s: float = 2.0,
    timeout_s: float = DEFAULT_TIMEOUT_S,
    device=None,
) -> str:
    """torch.distributed.init_process_group with retry and backoff; returns
    the backend.

    With no init_method, world_size or rank, reads torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT); LOCAL_RANK and
    LOCAL_WORLD_SIZE place the rank on its host (`host_layout`; ranks
    started by hand, one a card, need neither).  device: None =
    "cuda" (raises without a card); on cuda the rank's card is made current
    (its local rank, modulo the cards when gloo puts several ranks on one),
    and the kernels are built once a host (local rank 0 builds, the group
    waits at a barrier).  backend: `choose_backend`, which checks NCCL's
    one card a rank when the ranks on the host are known.  A peer that is
    slow to start, or a store that refuses, is retried `retries` times
    with exponential backoff; then a RuntimeError chained to the last
    error."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to join a gloo group on the host")
    if init_method is None:
        init_method = f"tcp://{os.environ.get('MASTER_ADDR', '')}:{_env_int('MASTER_PORT')}"
        if init_method.startswith("tcp://:"):
            raise ValueError("MASTER_ADDR is not set: pass init_method, or start with torchrun")
    world_size = _env_int("WORLD_SIZE") if world_size is None else world_size
    rank = _env_int("RANK") if rank is None else rank
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    local_rank, on_host = host_layout(rank, n_cards)
    backend = choose_backend(backend, dev.type, on_host, n_cards)
    if dev.type == "cuda":
        torch.cuda.set_device(local_rank % n_cards)
    last = None
    for attempt in range(retries):
        try:
            dist.init_process_group(
                backend, init_method=init_method, world_size=world_size, rank=rank,
                timeout=datetime.timedelta(seconds=timeout_s),
            )
            break
        except RuntimeError as e:  # DistNetworkError, DistStoreError, timeouts
            last = e
            wait = backoff_s * (2 ** attempt)
            log.warning("process-group init failed (attempt %d/%d): %s; retrying in %.1fs",
                        attempt + 1, retries, e, wait)
            time.sleep(wait)
    else:
        raise RuntimeError(
            f"torch.distributed.init_process_group failed after {retries} attempts"
        ) from last
    if dev.type == "cuda":
        # One build of the kernels a host: local rank 0 compiles (or finds)
        # the library, the others wait, then load it at their first launch.
        from ray_tracying_tpu_torch.kernels import _build

        if local_rank == 0:
            _build.build()
        dist.barrier(device_ids=[torch.cuda.current_device()] if backend == "nccl" else None)
    log.info("cluster up: rank %d/%d, %s", rank, world_size, backend)
    return backend


def destroy() -> None:
    """Leave the process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def local_ray_slice(n_rays_global: int, rank: Optional[int] = None,
                    world_size: Optional[int] = None) -> slice:
    """The contiguous slice of a global ray batch owned by `rank` (default:
    this process's rank in the group) of `world_size` (default: the
    group's); ranks own equal shares, so n_rays_global must divide."""
    rank = dist.get_rank() if rank is None else rank
    world_size = dist.get_world_size() if world_size is None else world_size
    if n_rays_global % world_size:
        raise ValueError(f"{n_rays_global} rays do not split over {world_size} ranks")
    per = n_rays_global // world_size
    return slice(rank * per, (rank + 1) * per)


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free when asked."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world_size, init_method, args, results):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)
    value = fn(rank, world_size, init_method, *args)
    destroy()
    results.put((rank, value))


def launch(fn: Callable[..., Any], world_size: int, args: Sequence = (),
           timeout_s: float = 600.0) -> List[Any]:
    """Run fn(rank, world_size, init_method, *args) in `world_size` spawned
    processes of this host, init_method a free tcp:// address on
    127.0.0.1; returns the ranks' results (picklable values) in rank order.
    fn must be importable by the children (a module-level function); each
    child leaves its process group after fn returns.  Raises as soon as a
    rank raises or exits non-zero (torch.multiprocessing's
    ProcessRaisedException / ProcessExitedException, naming the rank), or
    RuntimeError when the ranks are still running after timeout_s; every
    child is gone on return."""
    import torch.multiprocessing as mp

    results = mp.get_context("spawn").Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    ctx = mp.start_processes(_rank_main, args=(fn, world_size, init_method, tuple(args), results),
                             nprocs=world_size, join=False, start_method="spawn")
    got = {}
    deadline = time.time() + timeout_s
    try:
        # drain while waiting: a rank whose result is still in the pipe
        # does not exit
        while not ctx.join(timeout=1.0):
            _drain(results, got)
            if time.time() > deadline:
                raise RuntimeError(f"ranks still running after {timeout_s} s")
        while len(got) < world_size:
            rank, value = results.get(timeout=10.0)
            got[rank] = value
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(10)
    return [got[r] for r in range(world_size)]


def _drain(results, got: dict) -> None:
    while True:
        try:
            rank, value = results.get_nowait()
        except queue.Empty:
            return
        got[rank] = value
