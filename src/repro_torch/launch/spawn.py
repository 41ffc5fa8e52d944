"""Spawn a ``torch.distributed`` world on one host and collect each rank's
result: the port's counterpart of the reference's virtual host devices
(``--xla_force_host_platform_device_count``), for tests and for
``chip_smoke.py``.

    results = run_world(fn, 4, x, y)     # [fn(0, 4, x, y), ..., fn(3, ...)]

Each rank is a fresh process (the ``spawn`` start method) with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``
(``localhost``) and ``MASTER_PORT`` set as ``torchrun`` sets them, so
``launch.mesh.make_process_mesh`` joins the world from them.  ``fn`` must
be importable by name (a module-level function) and its result picklable;
each rank writes its result to a file in a temporary directory that the
caller reads back after every rank has ended.  A rank that raises ends the
world: the others are stopped and the caller gets the rank's traceback.
"""
from __future__ import annotations

import os
import pickle
import shutil
import socket
import tempfile
import time
from typing import Any, Callable, List, Optional


def free_port() -> int:
    """A TCP port on ``localhost`` that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn: Callable, world: int, port: int, out_dir: str,
               threads: Optional[int], args: tuple) -> None:
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world),
                       "LOCAL_RANK": str(rank),
                       "LOCAL_WORLD_SIZE": str(world),
                       "MASTER_ADDR": "localhost",
                       "MASTER_PORT": str(port)})
    import torch
    import torch.distributed as dist
    if threads is not None:
        torch.set_num_threads(threads)
    try:
        result = fn(rank, world, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.tmp"), "wb") as f:
        pickle.dump(result, f)
    os.replace(os.path.join(out_dir, f"rank{rank}.tmp"),
               os.path.join(out_dir, f"rank{rank}.pkl"))


def run_world(fn: Callable, world: int, *args: Any,
              timeout: float = 600.0, threads: Optional[int] = None
              ) -> List[Any]:
    """Run ``fn(rank, world, *args)`` in ``world`` spawned processes.

    Args:
        fn: a module-level function; it joins the world itself (through
            ``make_process_mesh``).
        world: the number of ranks.
        args: picklable arguments, the same for every rank.
        timeout: seconds the world may take; past it every rank is
            stopped and ``TimeoutError`` raised.
        threads: ``torch.set_num_threads`` in each rank (None: torch's
            default of one thread per core).

    Returns:
        Each rank's result, in rank order.

    Raises:
        torch.multiprocessing.ProcessRaisedException: a rank raised.
        torch.multiprocessing.ProcessExitedException: a rank died.
        TimeoutError: the world outlived ``timeout``.
    """
    import torch.multiprocessing as mp
    out_dir = tempfile.mkdtemp(prefix="repro-world-")
    try:
        ctx = mp.start_processes(
            _rank_main, args=(fn, world, free_port(), out_dir, threads,
                              args),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=0.2):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the world of {world} ranks ran "
                                       f"past {timeout:.0f}s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
            for p in ctx.processes:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
        results = []
        for r in range(world):
            with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
