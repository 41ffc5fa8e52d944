"""What one run measured, as the metric readers see it."""
from __future__ import annotations

import dataclasses
import random
from typing import Optional


@dataclasses.dataclass
class Served:
    """A closed loop's requests over one window.

    ``window_s`` runs from the first request's call until every request
    sent has completed; ``host_s`` is each request's time inside the
    program's call; ``latency_s`` each request's time from the call until
    its answer was synchronised (only where the traffic waits on each).
    """

    requests: int
    window_s: float
    host_s: list
    latency_s: Optional[list]
    t_first: float


@dataclasses.dataclass
class TraceReading:
    """What the profiler saw over the traced part of a run."""

    window_s: float
    busy_s: float
    requests: int
    port_kernel_s: float
    port_launches: int
    device_ops: list
    idle_gaps: list


@dataclasses.dataclass
class RunRecord:
    """Everything a metric reader may read (``bench/metrics/<name>.py``)."""

    cell: str
    n: int
    nnz: int
    d: int
    bound_s: float          # the fixed roofline of one request
    flops: int              # useful operations of one request
    setup_s: float
    served: Served
    plan_s: Optional[float] = None
    pack_s: Optional[float] = None
    trace: Optional[TraceReading] = None


class Reservoir:
    """A uniform sample of ``k`` of a stream's answers, drawn from a seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self._rng = random.Random(seed)
        self.items: list = []

    def offer(self, index: int, b_index: int, c) -> None:
        """Consider request ``index`` (0-based, in order) with its answer."""
        if len(self.items) < self.k:
            self.items.append((index, b_index, c))
            return
        j = self._rng.randrange(index + 1)
        if j < self.k:
            self.items[j] = (index, b_index, c)
