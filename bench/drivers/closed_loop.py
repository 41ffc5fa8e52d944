"""Closed loop with one caller: the traffic driver of ``stream-*`` and
``solve-*`` mixes.

The caller sends request i with B = ``pool[i % len(pool)]`` through the
plan and keeps at most ``in_flight`` requests unanswered:

* ``in_flight`` > 1 enqueues with ``StreamPlan.execute_async`` and records
  a CUDA event after each; before it sends request i + ``in_flight`` it
  waits on the event of request i.
* ``in_flight`` == 1 with ``"wait": "sync"`` calls ``StreamPlan.execute``
  and waits with ``torch.cuda.synchronize()`` before the next request;
  each request's latency runs from the call until the synchronise returns.

Traffic parameters (``bench/traffic/<name>.json``): ``d``, ``pool``,
``in_flight``, ``wait`` (``"event"`` or ``"sync"``), ``warmup`` (requests
sent in set-up), ``sample`` (answers kept for the check) and
``trace_requests`` (requests in the traced segment).
"""
from __future__ import annotations

import collections
import contextlib
import time

import torch

from bench.record import Served


def make_pool(n: int, traffic: dict, gen: torch.Generator) -> list:
    """The traffic's distinct right-hand sides, ``pool`` float32 ``[n, d]``
    tensors drawn from ``gen`` on its device."""
    d = int(traffic["d"])
    return [torch.randn((n, d), generator=gen, device=gen.device,
                        dtype=torch.float32)
            for _ in range(int(traffic["pool"]))]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _event(device: torch.device):
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def serve(plan, pool: list, traffic: dict, *, until: float = None,
          count: int = None, sample=None, annotate: bool = False) -> Served:
    """Send requests until the host clock reads ``until`` or ``count`` were
    sent, then wait for all of them.

    Args:
        plan: the program's ``StreamPlan``.
        pool: the right-hand sides, from :func:`make_pool`.
        traffic: the mix's parameters.
        until: ``time.perf_counter()`` value after which no request is sent.
        count: the most requests to send.
        sample: a ``Reservoir`` offered every answer, or None.
        annotate: mark the host's phases for the profiler
            (``bench.enqueue``, ``bench.wait``).
    """
    in_flight = int(traffic["in_flight"])
    sync_each = traffic["wait"] == "sync"
    if sync_each and in_flight != 1:
        raise ValueError("a synchronous caller keeps one request in flight")
    call = plan.execute if sync_each else plan.execute_async
    device = plan.device
    mark = torch.profiler.record_function if annotate \
        else (lambda _name: contextlib.nullcontext())
    pending = collections.deque()
    host, latency = [], []
    sent = 0
    t_first = time.perf_counter()
    while ((count is None or sent < count)
           and (until is None or time.perf_counter() < until)):
        if len(pending) >= in_flight:
            with mark("bench.wait"):
                ev = pending.popleft()
                if ev is not None:
                    ev.synchronize()
        b_index = sent % len(pool)
        with mark("bench.enqueue"):
            t0 = time.perf_counter()
            c = call(pool[b_index])
            t1 = time.perf_counter()
        if sync_each:
            with mark("bench.wait"):
                _sync(device)
            latency.append(time.perf_counter() - t0)
        else:
            pending.append(_event(device))
        host.append(t1 - t0)
        if sample is not None:
            sample.offer(sent, b_index, c)
        sent += 1
    with mark("bench.wait"):
        _sync(device)
    return Served(requests=sent, window_s=time.perf_counter() - t_first,
                  host_s=host, latency_s=latency if sync_each else None,
                  t_first=t_first)
