"""Read a ``torch.profiler`` trace: device busy time, the program's kernels,
the top device operations and the longest idle gaps.

The traced window is the host annotation ``bench.traced``. Device activity
is every kernel, copy and set on the card (the profiler's mirrored host
annotations excluded), clipped to that window. The program's kernels are
the ``__global__`` functions of its CUDA sources, matched by name.
"""
from __future__ import annotations

import collections
import pathlib
import re

from bench.record import TraceReading

WINDOW = "bench.traced"
#: Entries kept in each list of the breakdown.
TOP = 10

_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^()]*\)\s*)?(\w+)\s*\(")


def port_kernel_names(csrc: pathlib.Path) -> frozenset:
    """Names of the ``__global__`` functions in the program's CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_GLOBAL.findall(path.read_text()))
    return frozenset(names)


def _is_port_kernel(name: str, names: frozenset) -> bool:
    return any(re.search(rf"\b{k}\b", name) for k in names)


def _is_annotation(event) -> bool:
    """A host range the profiler mirrors onto the device's timeline."""
    kind = getattr(event, "activity_type", None)
    return (event.is_user_annotation() or event.name().startswith("bench.")
            or (kind is not None and "annotation" in kind()))


def _union(intervals):
    """Merged ``[start, end)`` intervals, sorted."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_activity(host, t: int) -> str:
    """What the host was doing at ``t``: its outer ``bench.*`` phase and
    the innermost event then open."""
    open_ = [(s, e, name) for s, e, name in host if s <= t < e]
    if not open_:
        return "host: between events"
    outer = [x for x in open_ if x[2].startswith("bench.")
             and x[2] != WINDOW]
    inner = max(open_, key=lambda x: x[0])[2]
    phase = min(outer, key=lambda x: x[0])[2] if outer else "host"
    return phase if inner == phase else f"{phase} > {inner}"


def read(prof, *, requests: int, port_names: frozenset,
         port_launches: int) -> TraceReading:
    """Reduce the profiler's events over the ``bench.traced`` window.

    Args:
        prof: a stopped ``torch.profiler.profile``.
        requests: requests sent inside the window.
        port_names: the program's kernel names (:func:`port_kernel_names`).
        port_launches: the program's kernel launches counted in the window
            (``repro_torch.kernels.launch_counts``).
    """
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == WINDOW
              and not str(e.device_type()).endswith("CUDA")]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW!r} annotation")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    device, host = [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if str(e.device_type()).endswith("CUDA"):
            if _is_annotation(e):
                continue
            s, t = max(s, w0), min(t, w1)
            if t > s:
                device.append((s, t, e.name()))
        else:
            host.append((s, t, e.name()))
    busy = _union((s, t) for s, t, _ in device)
    by_name = collections.Counter()
    port_ns = 0
    for s, t, name in device:
        by_name[name] += t - s
        if _is_port_kernel(name, port_names):
            port_ns += t - s
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    return TraceReading(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        requests=requests,
        port_kernel_s=port_ns / 1e9,
        port_launches=port_launches,
        device_ops=[[name, ns / 1e9] for name, ns in by_name.most_common(TOP)],
        idle_gaps=[[_host_activity(host, s), (e - s) / 1e9]
                   for s, e in gaps[:TOP]])
