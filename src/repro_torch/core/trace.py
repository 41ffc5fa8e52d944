"""Spans inside the port: where the plan, the pack and each request spend
their host time.

A span is one timed interval of one thread: its name, its start and end on
``time.perf_counter_ns()``, its id, its parent's id (the span open beneath
it on the same thread; None for a root), the id of the request it belongs
to (a root's own id, inherited by everything under it) and a few
attributes, counts such as the bytes a copy moved.

Two kinds of span, by what they cost:

* **Set-up spans** (the roots :data:`SETUP_ROOTS` and everything opened
  under them) run once per operator and always record.
* **Request spans** (``spmm.execute`` and its children) record only while a
  ``torch.profiler`` records.  Their sites test :func:`recording`, one read
  of the profiler's module flag, and do nothing else when it is off.

While the profiler records, every span that :meth:`Tracer.begin` opens
also opens a profiler range of its name, which puts it on the profiler's
clock beside the device's kernels.  The range is
``torch._C._profiler._RecordFunctionFast``, the form torch's own compiler
opens: about a tenth of ``torch.profiler.record_function``'s cost, and a
host event only (no annotation mirrored onto the device's timeline).

A request opens one such span, its root.  Its parts (``spmm.check``,
``spmm.alloc``, ``spmm.launch``) are timed with clock reads only and
recorded by :func:`record_launch` / :meth:`Tracer.record` once the kernel
is launched, with no range: their bookkeeping then runs while the card
works instead of delaying the launch, and the root's range names the
request on the profiler's timeline.

Recorded spans stay in memory, in a bounded buffer (a deque, the oldest
dropped first and counted); :meth:`Tracer.spans` and :func:`summary` read
it.  The names are a contract with the benchmark's readers
(``bench/metrics/``):

* plan: ``spmm.plan`` (root), ``spmm.plan.classify``, ``spmm.plan.stat``,
  ``spmm.plan.policy``, ``spmm.plan.candidate``;
* pack: ``spmm.pack`` (root), ``spmm.pack.convert``, ``spmm.pack.layout``,
  ``spmm.pack.diagonals``, ``spmm.pack.quadrants``, ``spmm.pack.copy``;
* request: ``spmm.execute`` (root), ``spmm.check``, ``spmm.alloc``,
  ``spmm.launch``.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Iterable, Optional

from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _profiler

#: Spans the buffer holds before it drops the oldest.
MAX_SPANS = 65536

#: Root spans of the one-time work: they and every span under them record
#: whether or not a profiler records.
SETUP_ROOTS = ("spmm.plan", "spmm.pack")


def recording() -> bool:
    """True while a ``torch.profiler`` records: the test every request
    span site makes, one read of a module flag."""
    return _profiler._is_profiler_enabled


@dataclasses.dataclass(eq=False, slots=True)
class Span:
    """One recorded (or still open) interval of one thread."""

    name: str
    start_ns: int = 0
    end_ns: int = 0
    span_id: int = 0
    parent_id: Optional[int] = None
    request_id: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)
    #: The profiler range opened beside the span, while open.
    _range: object = dataclasses.field(default=None, repr=False)

    @property
    def duration_ns(self) -> int:
        """End minus start."""
        return self.end_ns - self.start_ns


class Tracer:
    """A bounded buffer of recorded spans and a stack of open ones per
    thread."""

    def __init__(self, max_spans: int = MAX_SPANS):
        """Keep at most ``max_spans`` recorded spans."""
        self._buffer: collections.deque = collections.deque(maxlen=max_spans)
        self._local = threading.local()
        self._ids = itertools.count(1)
        #: Recorded spans pushed out of the full buffer.
        self.dropped = 0

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def begin(self, name: str, *, request: bool = False, **attrs) -> Span:
        """Open span ``name`` on this thread, under the span open there.

        Args:
            name: the span's name.
            request: open a request root (``spmm.execute``), whose id is
                the request id of everything under it; other spans inherit
                their parent's, and a span with no parent takes its own id.
            attrs: the span's first attributes.
        """
        stack = self._stack()
        sid = next(self._ids)
        if stack:
            parent = stack[-1]
            span = Span(name, 0, 0, sid, parent.span_id,
                        sid if request else parent.request_id, attrs)
        else:
            span = Span(name, 0, 0, sid, None, sid, attrs)
        if _profiler._is_profiler_enabled:
            span._range = _RecordFunctionFast(name)
            span._range.__enter__()
        stack.append(span)
        span.start_ns = time.perf_counter_ns()
        return span

    def end(self, span: Span, **attrs) -> None:
        """Close ``span``, add ``attrs`` to it and record it.

        Spans opened after it on this thread and still open (an exception
        between their ``begin`` and ``end``) close with it, unrecorded.
        """
        t = time.perf_counter_ns()
        stack = self._stack()
        if span not in stack:
            raise ValueError(f"span {span.name!r} is not open on this "
                             f"thread")
        _close(stack, span)
        span.end_ns = t
        if attrs:
            span.attrs.update(attrs)
        self._keep(span)

    def record(self, name: str, start_ns: int, end_ns: int) -> None:
        """Record a finished span ``name``, from ``start_ns`` to ``end_ns``
        on :func:`now`'s clock, under the span open on this thread.

        For parts that their caller times with two clock reads and records
        later, as the request path records its parts once the kernel is
        launched; such a span opens no profiler range.
        """
        stack = self._stack()
        sid = next(self._ids)
        if stack:
            parent = stack[-1]
            span = Span(name, start_ns, end_ns, sid, parent.span_id,
                        parent.request_id, {})
        else:
            span = Span(name, start_ns, end_ns, sid, None, sid, {})
        self._keep(span)

    def _keep(self, span: Span) -> None:
        if len(self._buffer) == self._buffer.maxlen:
            self.dropped += 1
        self._buffer.append(span)

    def span(self, name: str, *, request: bool = False, **attrs) -> "_Scope":
        """``with tracer.span(name, **attrs) as s:``: :meth:`begin` on entry,
        :meth:`end` on exit; ``s.attrs`` takes attributes inside.  An
        exception that leaves the block is named in ``attrs["error"]``."""
        return _Scope(self, name, request, attrs)

    def in_setup(self) -> bool:
        """True while a set-up root (:data:`SETUP_ROOTS`) is open on this
        thread."""
        stack = self._stack()
        return bool(stack) and stack[0].name in SETUP_ROOTS

    def spans(self) -> list:
        """The recorded spans, oldest first."""
        return list(self._buffer)

    def clear(self) -> None:
        """Forget every recorded span and the dropped count."""
        self._buffer.clear()
        self.dropped = 0


class _Scope:
    __slots__ = ("_tracer", "_name", "_request", "_attrs", "_span")

    def __init__(self, tracer: Tracer, name: str, request: bool,
                 attrs: dict):
        self._tracer, self._name = tracer, name
        self._request, self._attrs = request, attrs

    def __enter__(self) -> Span:
        self._span = self._tracer.begin(self._name, request=self._request,
                                        **self._attrs)
        return self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self._tracer.end(self._span)
        else:
            self._tracer.end(self._span, error=exc_type.__name__)
        return False


def _close(stack: list, span: Span) -> None:
    """Pop ``stack`` down to and including ``span``, leaving the profiler
    range of each span popped."""
    while True:
        top = stack.pop()
        if top._range is not None:
            top._range.__exit__(None, None, None)
            top._range = None
        if top is span:
            return


def _covered_ns(span: Span, children: Iterable[Span]) -> int:
    """Nanoseconds of ``span`` that the union of ``children`` covers."""
    covered, reach = 0, span.start_ns
    for c in sorted(children, key=lambda c: c.start_ns):
        s, e = max(c.start_ns, reach), min(c.end_ns, span.end_ns)
        if e > s:
            covered += e - s
            reach = e
    return covered


def summary(recorded: Iterable[Span]) -> dict:
    """``name -> {"count", "total_s", "self_s"}`` over ``recorded``.

    A span's self time is its duration less the part of it that its
    children among ``recorded`` cover.
    """
    recorded = list(recorded)
    children = collections.defaultdict(list)
    for s in recorded:
        if s.parent_id is not None:
            children[s.parent_id].append(s)
    out: dict = {}
    for s in recorded:
        row = out.setdefault(s.name, {"count": 0, "total_s": 0.0,
                                      "self_s": 0.0})
        row["count"] += 1
        row["total_s"] += s.duration_ns / 1e9
        row["self_s"] += (s.duration_ns
                          - _covered_ns(s, children.get(s.span_id, ()))) / 1e9
    return out


#: The process's tracer: every span site of the port records here.
TRACER = Tracer()
begin = TRACER.begin
end = TRACER.end
span = TRACER.span
record = TRACER.record
in_setup = TRACER.in_setup
spans = TRACER.spans

#: The spans' clock.
now = time.perf_counter_ns


def record_launch(t_check: int, t_alloc: int, t_launch: int) -> None:
    """Record a kernel wrapper's parts under the open request, once it has
    launched: ``spmm.check`` from ``t_check``, ``spmm.alloc`` from
    ``t_alloc`` and ``spmm.launch`` from ``t_launch`` to now."""
    t = now()
    record("spmm.check", t_check, t_alloc)
    record("spmm.alloc", t_alloc, t_launch)
    record("spmm.launch", t_launch, t)
