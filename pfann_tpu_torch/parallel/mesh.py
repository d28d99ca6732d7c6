"""Devices and process groups (port of ``pfann_tpu/parallel/mesh.py``).

The JAX package names two axes of one device mesh: ``db`` (the song set
sharded over the chips, ``parallel/sharded_search.py``) and ``dp`` (the
training batch split over them, ``train/trainer.py``).  Here each is its
own thing:

  * ``db``: a list of devices, one per shard (``local_devices``); one
    process drives them all.
  * ``dp``: one process per rank in a ``torch.distributed`` group
    (``init_data_parallel``), NCCL between cards and gloo on the CPU, or
    whichever backend the caller names.  ``spawn_ranks`` starts the ranks
    and fails as soon as one of them does.

Nothing here picks another device or backend than the one asked for: a
failing NCCL group fails the run.
"""

from __future__ import annotations

import datetime
import multiprocessing.connection
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a collective that waits longer than this fails the group's ranks
GROUP_TIMEOUT = datetime.timedelta(minutes=30)


def local_devices(n: int | None = None, device: str | torch.device = "cuda"
                  ) -> list[torch.device]:
    """The first ``n`` (default: all) visible cards, in order; with
    ``device="cpu"``, ``[cpu] * n`` (n shards in one CPU process)."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * (1 if n is None else n)
    if dev.type != "cuda":
        raise ValueError("unsupported device %r (cuda or cpu)" % (device,))
    if not torch.cuda.is_available():
        raise RuntimeError("no card visible: torch.cuda.is_available() is false")
    count = torch.cuda.device_count()
    n = count if n is None else n
    if not 1 <= n <= count:
        raise ValueError("asked for %d cards, %d visible" % (n, count))
    return [torch.device("cuda", i) for i in range(n)]


def row_block(n: int, rank: int, world_size: int) -> tuple[int, int]:
    """Rank's contiguous block [r0, r1) of n global rows (sizes differ by
    at most one)."""
    return rank * n // world_size, (rank + 1) * n // world_size


def pair_block(n_pairs: int, rank: int, world_size: int) -> tuple[int, int, int, int]:
    """The (org, aug) pairs [p0, p1) holding rank's block of the 2 * n_pairs
    interleaved rows, and the block's rows [lo, hi) among those pairs' rows
    (a pair may straddle two ranks)."""
    r0, r1 = row_block(2 * n_pairs, rank, world_size)
    p0, p1 = r0 // 2, -(-r1 // 2)
    return p0, p1, r0 - 2 * p0, r1 - 2 * p0


def free_port() -> int:
    """A free TCP port on localhost for a group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_data_parallel(rank: int, world_size: int, port: int, *,
                       device: torch.device, backend: str | None = None) -> None:
    """Join rank ``rank`` of a ``world_size`` group at tcp://localhost:port.
    The backend is NCCL for a card and gloo for the CPU unless named (gloo
    also carries CUDA tensors: two ranks on one card, which NCCL refuses)."""
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method="tcp://localhost:%d" % port, world_size=world_size,
        rank=rank, timeout=GROUP_TIMEOUT)


def _rank_entry(rank, fn, world_size, port, args):
    fn(rank, world_size, port, *args)


def spawn_ranks(fn, world_size: int, args: tuple = (), timeout: float | None = None
                ) -> None:
    """Run ``fn(rank, world_size, port, *args)`` in ``world_size`` fresh
    processes (``fn`` importable, so the spawn start method can find it),
    ``port`` a free one for ``init_data_parallel``.  Returns when all exit
    0; raises as soon as one fails (the others are killed) or when
    ``timeout`` seconds pass."""
    ctx = mp.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_entry, args=(r, fn, world_size, port, args),
                         daemon=False) for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        live = list(procs)
        while live:
            wait = None if deadline is None else max(0.0, deadline - time.monotonic())
            multiprocessing.connection.wait([p.sentinel for p in live], wait)
            for p in [p for p in live if p.exitcode is not None]:
                live.remove(p)
                if p.exitcode != 0:
                    raise RuntimeError("rank %d of %d exited with code %d"
                                       % (procs.index(p), world_size, p.exitcode))
            if live and deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError("ranks %s still running after %.0f s"
                                   % ([procs.index(p) for p in live], timeout))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
