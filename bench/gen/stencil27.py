"""HPCG's 27-point stencil on an ``nx x ny x nz`` grid (HPCG 3.1's
``GenerateProblem_ref``): row ``p = (z * ny + y) * nx + x`` holds one entry
for each neighbour ``(z + dz, y + dy, x + dx)``, ``dz, dy, dx`` in ``{-1, 0,
1}``, that lies inside the grid: ``(3nx - 2)(3ny - 2)(3nz - 2)`` entries on
27 diagonals, at offsets ``dz * nx * ny + dy * nx + dx``.

On the card the generator also starts a watchdog (:func:`watch_host_memory`)
that ends the process, with exit code 1 and a message on standard error,
once its resident memory passes what it held when the operator was made by
:data:`HOST_BUDGET_GIB`.  A run of this operator holds a few GiB on the
host; a program that asks it for much more (a DIA pack through a block
band, ~100 GB at 104^3) then fails soon with an error of its own, instead
of being killed by the host's out-of-memory handling.  A process limit
would not do everywhere: a user-space kernel such as gVisor enforces no
``RLIMIT_DATA`` on ``mmap`` and counts the card's mappings in
``RLIMIT_AS``.
"""
from __future__ import annotations

import itertools
import os
import threading
import time

import torch

#: Host memory a run may add to what it held when the operator was made:
#: several times what a run of a 104^3 grid holds, and a third of the
#: 96 GiB host of a one-card H100 machine.
HOST_BUDGET_GIB = 32
#: Seconds between two readings of the watchdog.
WATCH_INTERVAL_S = 0.2

_watching = threading.Event()


def resident_bytes() -> int:
    """The process's resident memory now (``VmRSS``), in bytes."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    raise RuntimeError("no VmRSS in /proc/self/status")


def watch_host_memory(budget_gib: float,
                      interval_s: float = WATCH_INTERVAL_S) -> int:
    """Start the watchdog (once a process): it ends the process with exit
    code 1 once ``resident_bytes()`` passes its reading now plus
    ``budget_gib`` GiB.  Returns that limit, in bytes (0 when a watchdog
    already runs)."""
    if _watching.is_set():
        return 0
    _watching.set()
    limit = resident_bytes() + int(budget_gib * 2**30)

    def watch():
        while True:
            held = resident_bytes()
            if held > limit:
                os.write(2, (
                    f"bench: the run holds {held / 2**30:.1f} GiB of host "
                    f"memory, over its budget of {limit / 2**30:.1f} GiB "
                    f"({budget_gib:g} GiB above what it held when the "
                    f"operator was made); ending it\n").encode())
                os._exit(1)
            time.sleep(interval_s)

    threading.Thread(target=watch, name="bench-host-memory",
                     daemon=True).start()
    return limit


def generate(n: int, params: dict, gen: torch.Generator):
    """``(rows, cols)`` of the pattern on ``gen``'s device, int32, sorted by
    row and then column (the pattern is the grid's alone; ``gen`` only
    names the device).  On a CUDA device the watchdog starts first
    (:func:`watch_host_memory`, :data:`HOST_BUDGET_GIB`).

    Raises:
        ValueError: when ``n`` is not ``nx * ny * nz``.
    """
    nx, ny, nz = (int(params[k]) for k in ("nx", "ny", "nz"))
    if n != nx * ny * nz:
        raise ValueError(f"n = {n} is not nx * ny * nz = {nx * ny * nz}")
    if gen.device.type == "cuda":
        watch_host_memory(HOST_BUDGET_GIB)
    p = torch.arange(n, device=gen.device)
    x, y, z = p % nx, (p // nx) % ny, p // (nx * ny)
    cols, keep = [], []
    # (dz, dy, dx) in this order gives increasing columns within a row.
    for dz, dy, dx in itertools.product((-1, 0, 1), repeat=3):
        keep.append((x + dx >= 0) & (x + dx < nx) & (y + dy >= 0)
                    & (y + dy < ny) & (z + dz >= 0) & (z + dz < nz))
        cols.append((p + (dz * ny * nx + dy * nx + dx)).to(torch.int32))
    keep = torch.stack(keep, 1)
    cols = torch.stack(cols, 1)[keep]
    rows = p.to(torch.int32)[:, None].expand(n, 27)[keep]
    return rows, cols
