"""Continuous-batching serving engine over persistent plans.

``repro_torch.sparse.stream`` replays one plan synchronously: the caller
owns the loop and every ``execute`` serves one right-hand side.  Production
traffic is many concurrent streams with mixed widths and deadlines, the
regime this module serves:

    engine = ServingEngine(max_queue=256, policy="wait")
    engine.register("moe", sparse.plan(m, BSpec(d=64, reuse=4096)))
    engine.start()                        # worker thread
    t = engine.submit("moe", b)           # any thread; bounded queue
    c = t.result()                        # per-request future, host tensor
    print(engine.summary())               # batches, latency, goodput

The serving loop is the reference package's, in four stages:

1. **Admission.**  ``submit`` tags each request ``(operator, d,
   deadline)`` and appends it to a bounded queue.  A full queue applies
   the backpressure policy: ``"wait"`` blocks the submitter (optionally up
   to a timeout), ``"shed"`` rejects at once with :class:`ShedError`.
2. **Micro-batch coalescing.**  The queue head and every other queued
   request for the *same operator* (FIFO within the operator) join one
   batch up to the plan's column budget (:func:`coalesce_budget`); their
   right-hand sides are concatenated column-wise and replayed through one
   ``execute_wide`` call at the plan's ``coalesce_block_d``.  Columns of B
   are independent, so coalescing is exact.
3. **Double-buffered staging.**  After enqueueing batch *i* the engine
   drafts and stages batch *i+1* before waiting on *i*.  On the card a
   batch is staged in pinned host memory (a pinned operand of the staging
   dtype is sent as is) and copied ``non_blocking`` on a side CUDA stream;
   the compute stream waits on the copy through an event, and the staged
   tensor is ``record_stream``-ed onto the compute stream before use.
4. **Completion + plan swap.**  The batch's C is copied behind the
   kernels, on the compute stream, into pinned host memory: the batch's
   own staged operand when the engine built it (C has B's shape and
   dtype, and the copy back is ordered after the copy out), else a buffer
   pinned while the kernels run; one ``event.synchronize()`` per batch
   waits for it; each ticket gets its columns as a host tensor.  Between
   batches the engine polls ``plan.maybe_replan()`` and swaps a fresh
   plan in under the queue lock.

**The current CUDA stream is per thread.**  The kernels launch on
``torch.cuda.current_stream(device)``, so the engine enters its own
compute stream explicitly in :meth:`ServingEngine.step`, whichever thread
calls it (the worker or a caller of ``drain``).

Latency accounting is the reference's: from the ``submit`` call's entry
(backpressure wait included) to the completion of the request's batch;
p50/p99 over served requests; goodput counts requests that met their
deadline over the span from the first admission to the last completion.
On the card every batch also gets a :class:`TransferRecord`: its H2D,
kernel and D2H times from CUDA events, and whether the next batch's copy
was enqueued before this batch's end event completed.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device import synchronize
from repro_torch.core.precision import as_precision
from repro_torch.sparse.stream import StreamPlan

#: Default cap on the staged host->device buffer per micro-batch, in
#: bytes.  Two batches are in flight under double buffering, so the
#: engine's staging footprint is at most twice this.
DEFAULT_STAGE_BYTES: int = 8 * 2 ** 20

#: Default bounded-queue depth (requests).
DEFAULT_MAX_QUEUE: int = 256


class ShedError(RuntimeError):
    """A request was refused at admission (queue full under ``"shed"``,
    or the ``"wait"`` timeout expired before space opened up)."""


def _stage_dtype(plan: StreamPlan) -> torch.dtype:
    """The dtype batches are staged (and executed) at for ``plan``: the
    reduced value dtype of a bf16 plan, whose kernels would cast B anyway
    (half the host->device bytes), else the stream's declared dtype."""
    prec = as_precision(plan.dispatch.precision)
    return prec.value_torch if prec.reduced else plan.spec.dtype


def coalesce_budget(plan: StreamPlan, *,
                    stage_bytes: int = DEFAULT_STAGE_BYTES) -> int:
    """Max total RHS columns one micro-batch may carry for ``plan``.

    The staged operand, ``[n, cols]`` at the plan's staging dtype, must fit
    the staging budget; the batch replays through ``execute_wide`` at the
    plan's ``coalesce_block_d``, so per-launch tiling is unchanged by
    coalescing.  The result is floored at the planned width (a
    planned-width request is always servable) and rounded down to a
    multiple of it when possible.

    Args:
        plan: the bound :class:`~repro_torch.sparse.stream.StreamPlan`.
        stage_bytes: staging-buffer budget in bytes.

    Returns:
        The column budget (>= ``plan.spec.d``).
    """
    itemsize = _stage_dtype(plan).itemsize
    cap = max(int(stage_bytes) // (plan.n * itemsize), 1)
    d = max(plan.spec.d, 1)
    return max(d, (cap // d) * d)


@dataclasses.dataclass
class Ticket:
    """Per-request handle: the future plus the request's audit record.

    Attributes:
        id: admission sequence number (unique per engine).
        operator: the registered plan the request was tagged with.
        d: the request's RHS width (requests of mixed widths coalesce).
        deadline_s: absolute deadline on the engine clock, or None.
        submitted_s: clock at ``submit`` entry (latency starts here).
        batched_s: clock when the request was drafted into a micro-batch.
        done_s: clock when its batch completed.
        batch_seq: sequence number of the batch that served it.
    """

    id: int
    operator: str
    d: int
    deadline_s: Optional[float] = None
    submitted_s: float = 0.0
    batched_s: Optional[float] = None
    done_s: Optional[float] = None
    batch_seq: Optional[int] = None
    _event: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    _result: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False)
    _error: Optional[BaseException] = dataclasses.field(
        default=None, repr=False)

    def done(self) -> bool:
        """Whether the request finished (result or error is available)."""
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> torch.Tensor:
        """Block until served and return this request's ``[n, d]`` result.

        The value is a host (CPU) tensor, a view of its batch's output
        copied back from the device.

        Args:
            timeout: seconds to wait; None waits forever.

        Raises:
            TimeoutError: the request did not complete in time.
            BaseException: whatever the execution raised, re-raised here.
        """
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request {self.id} ({self.operator}, d={self.d}) not "
                f"served within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        """submit-to-completion latency; None until served."""
        if self.done_s is None:
            return None
        return self.done_s - self.submitted_s

    @property
    def met_deadline(self) -> Optional[bool]:
        """Whether completion beat the deadline (None = no deadline)."""
        if self.deadline_s is None or self.done_s is None:
            return None
        return self.done_s <= self.deadline_s


@dataclasses.dataclass
class _Request:
    """A queued request: the ticket plus its host-side operand."""

    ticket: Ticket
    b: object


@dataclasses.dataclass(frozen=True)
class BatchRecord:
    """One executed micro-batch's audit row (``ServingEngine.batch_log``):
    which operator, which requests, how wide, how long."""

    seq: int
    operator: str
    chosen: str                   # format the plan executed
    request_ids: Tuple[int, ...]
    widths: Tuple[int, ...]       # per-request d
    cols: int                     # total columns incl. padding
    block_d: int                  # per-launch width the batch replayed at
    queued_s: float               # oldest member's admission->draft wait
    exec_s: float                 # draft -> completed


@dataclasses.dataclass(frozen=True)
class TransferRecord:
    """One batch's split on the card (``ServingEngine.transfer_log``),
    from CUDA events.

    Attributes:
        seq: the batch's :class:`BatchRecord` sequence number.
        h2d_ms: the staged operand's copy on the side stream.
        kernel_ms: ``execute_wide`` on the compute stream, from the copy's
            arrival to the last kernel's end.
        d2h_ms: C's copy into pinned host memory, from its enqueue (or
            the kernels' end, if later) to its end.
        bytes_in: bytes copied to the device.
        bytes_out: bytes copied back.
        next_staged_early: the next batch's copy was enqueued before this
            batch's end event completed (None: no next batch was staged
            while this one ran).
        stage_host_ms: host clock from the draft to the staged batch:
            concatenation into pinned memory (none for a lone pinned
            operand) and the copy's launch.
        result_alloc_host_ms: host clock spent pinning a buffer for C
            after the kernels' launch (0 where C goes back into the
            engine's own staged operand).
    """

    seq: int
    h2d_ms: float
    kernel_ms: float
    d2h_ms: float
    bytes_in: int
    bytes_out: int
    next_staged_early: Optional[bool]
    stage_host_ms: float
    result_alloc_host_ms: float


@dataclasses.dataclass
class _Staged:
    """A drafted batch staged on its plan's device, awaiting dispatch; on
    the card ``h2d`` holds the copy's start and end events, ``host_out``
    the pinned buffer its C is copied back into (the staged operand when
    the engine built it, else None until the kernels launch), and
    ``copied_early`` whether the copy was enqueued while the previous
    batch still ran."""

    plan: StreamPlan
    requests: List[_Request]
    b_dev: Optional[torch.Tensor]
    block_d: int
    cols: int
    h2d: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None
    nbytes: int = 0
    host_out: Optional[torch.Tensor] = None
    copied_early: Optional[bool] = None
    stage_host_ms: float = 0.0
    result_alloc_host_ms: float = 0.0


def _timing_event() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True)


class ServingEngine:
    """Request-queue serving loop over registered persistent plans.

    Deterministic core + optional worker thread: :meth:`submit` /
    :meth:`step` / :meth:`drain` are a single-threaded API (tests drive
    it with an injected fake clock); :meth:`start` runs the same loop on a
    daemon thread so ``submit`` becomes fire-and-forget from any thread.

    Args:
        max_queue: bounded-queue depth; admission beyond it applies the
            backpressure policy.
        policy: ``"wait"`` (block the submitter until space) or ``"shed"``
            (raise :class:`ShedError` immediately).
        max_batch_cols: column budget per micro-batch; None derives it per
            plan from the staging budget (:func:`coalesce_budget`).
        stage_bytes: staging-buffer budget behind the derived budget.
        clock: monotonic-seconds callable; injectable for deterministic
            latency tests (default ``time.monotonic``).
        double_buffer: stage the next batch between dispatching and
            waiting on the current one (off automatically when the plan's
            kernel reports ``async_dispatch=False``).
        auto_replan: poll ``plan.maybe_replan()`` after each batch and swap
            the fresh plan in when the reuse audit fires.
        batch_log_depth: how many :class:`BatchRecord` (and
            :class:`TransferRecord`) rows to retain.
    """

    def __init__(self, *, max_queue: int = DEFAULT_MAX_QUEUE,
                 policy: str = "wait",
                 max_batch_cols: Optional[int] = None,
                 stage_bytes: int = DEFAULT_STAGE_BYTES,
                 clock: Callable[[], float] = time.monotonic,
                 double_buffer: bool = True,
                 auto_replan: bool = True,
                 batch_log_depth: int = 64):
        if policy not in ("wait", "shed"):
            raise ValueError(
                f"policy must be 'wait' or 'shed', got {policy!r}")
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self._plans: Dict[str, StreamPlan] = {}
        self._queue: Deque[_Request] = collections.deque()
        self._lock = threading.RLock()
        self._space = threading.Condition(self._lock)   # waiters on a full q
        self._work = threading.Condition(self._lock)    # worker wake-up
        self.max_queue = max_queue
        self.policy = policy
        self.max_batch_cols = max_batch_cols
        self.stage_bytes = stage_bytes
        self.clock = clock
        self.double_buffer = double_buffer
        self.auto_replan = auto_replan
        self.batch_log: Deque[BatchRecord] = collections.deque(
            maxlen=batch_log_depth)
        self.transfer_log: Deque[TransferRecord] = collections.deque(
            maxlen=batch_log_depth)
        self._streams: Dict[str, Tuple[torch.cuda.Stream,
                                       torch.cuda.Stream]] = {}
        self._staged: Optional[_Staged] = None
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self._drain_on_stop = True
        self._seq = 0
        self._batch_seq = 0
        self._latencies: List[float] = []
        self._counts = {"admitted": 0, "served": 0, "shed": 0,
                        "batches": 0, "coalesced": 0, "replans": 0,
                        "deadline_miss": 0}
        self._first_submit_s: Optional[float] = None
        self._last_done_s: Optional[float] = None

    # ------------------------------------------------------------- #
    # Operators
    # ------------------------------------------------------------- #

    def register(self, name: str, plan: StreamPlan) -> StreamPlan:
        """Register ``plan`` as operator ``name``; returns the plan.

        A sharded plan (``sparse.plan(m, spec, mesh=...)``) registers the
        same way; the engine consults its ``exec_hints`` and
        ``coalesce_block_d`` overrides.
        """
        with self._lock:
            self._plans[name] = plan
        return plan

    def plan_for(self, name: str) -> StreamPlan:
        """The plan currently serving operator ``name`` (post any swaps)."""
        with self._lock:
            return self._plans[name]

    def budget_for(self, name: str) -> int:
        """The micro-batch column budget applied to operator ``name``."""
        plan = self.plan_for(name)
        if self.max_batch_cols is not None:
            return max(self.max_batch_cols, plan.spec.d)
        return coalesce_budget(plan, stage_bytes=self.stage_bytes)

    def _streams_for(self, device: torch.device
                     ) -> Tuple[torch.cuda.Stream, torch.cuda.Stream]:
        """The (staging, compute) CUDA streams of ``device``, created on
        first use."""
        key = str(device)
        with self._lock:
            if key not in self._streams:
                self._streams[key] = (torch.cuda.Stream(device),
                                      torch.cuda.Stream(device))
            return self._streams[key]

    def _compute_stream(self, device: torch.device):
        """Context that makes the engine's compute stream current in the
        calling thread (nothing on the CPU)."""
        if device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.stream(self._streams_for(device)[1])

    def warmup(self, name: str, *, max_cols: Optional[int] = None) -> int:
        """Run every launch width a batch of operator ``name`` can take.

        One zero-operand ``execute_wide`` per size class up to the column
        budget (or ``max_cols``), on the engine's compute stream, then the
        plan's execution counter is reset so the warm-up doesn't skew its
        reuse audit.

        Args:
            name: a registered operator.
            max_cols: cap on the largest class to warm; defaults to the
                operator's coalescing budget.

        Returns:
            Number of distinct launch widths warmed.
        """
        plan = self.plan_for(name)
        cap = self.budget_for(name) if max_cols is None else max(
            int(max_cols), plan.spec.d)
        classes = []
        cols = plan.spec.d
        while True:
            block = plan.coalesce_block_d(cols)
            if block not in classes:
                classes.append(block)
            if cols >= cap:
                break
            cols = min(cols * 2, cap)
        for block in classes:
            b = torch.zeros((plan.n, block), dtype=_stage_dtype(plan),
                            device=plan.device)
            with self._compute_stream(plan.device):
                plan.execute_wide(b, block_d=block)
            synchronize(plan.device)
        plan.reset_stats()
        return len(classes)

    def reset_stats(self) -> None:
        """Zero latency/counter accounting (e.g. after a warm-up wave).

        Registered plans, queue contents, and ticket-id numbering are
        untouched; only the served-request accounting (latencies,
        counters, batch and transfer logs, goodput span) restarts.
        """
        with self._lock:
            self._latencies.clear()
            self.batch_log.clear()
            self.transfer_log.clear()
            for k in self._counts:
                self._counts[k] = 0
            self._first_submit_s = None
            self._last_done_s = None

    # ------------------------------------------------------------- #
    # Admission (stage 1)
    # ------------------------------------------------------------- #

    def submit(self, operator: str, b, *,
               deadline_s: Optional[float] = None,
               timeout: Optional[float] = None) -> Ticket:
        """Admit one request; returns its :class:`Ticket`.

        Args:
            operator: a name previously :meth:`register`-ed.
            b: dense right-hand side ``[n, d]`` on the host (a CPU tensor or
                a numpy array; any width: mixed widths coalesce).
            deadline_s: optional deadline in seconds *from admission*;
                missed deadlines are counted (and excluded from goodput)
                but the request is still served.
            timeout: under ``policy="wait"``, how long to block for queue
                space before shedding anyway; None waits forever.

        Raises:
            KeyError: unknown operator.
            ValueError: operand shape incompatible with the plan.
            ShedError: queue full under ``"shed"``, or wait timed out.
        """
        t0 = self.clock()
        with self._lock:
            plan = self._plans[operator]        # KeyError = unknown operator
        if getattr(b, "ndim", 0) != 2 or b.shape[0] != plan.n:
            raise ValueError(
                f"operand shape {tuple(getattr(b, 'shape', ()))} "
                f"incompatible with operator {operator!r} for "
                f"[{plan.n}, {plan.n}] matrix; expected [{plan.n}, d]")
        ticket = Ticket(
            id=-1, operator=operator, d=int(b.shape[1]),
            deadline_s=None if deadline_s is None else t0 + deadline_s,
            submitted_s=t0)
        with self._space:
            while len(self._queue) >= self.max_queue:
                if self.policy == "shed":
                    self._counts["shed"] += 1
                    raise ShedError(
                        f"queue full ({self.max_queue}); request for "
                        f"{operator!r} shed at admission")
                if not self._space.wait(timeout):
                    self._counts["shed"] += 1
                    raise ShedError(
                        f"queue full ({self.max_queue}) for {timeout}s; "
                        f"request for {operator!r} shed after waiting")
            ticket.id = self._seq
            self._seq += 1
            self._counts["admitted"] += 1
            if self._first_submit_s is None:
                self._first_submit_s = t0
            self._queue.append(_Request(ticket=ticket, b=b))
            self._work.notify_all()
        return ticket

    def pending(self) -> int:
        """Requests admitted but not yet drafted into a batch."""
        with self._lock:
            return len(self._queue)

    # ------------------------------------------------------------- #
    # Coalescing + staging (stages 2-3)
    # ------------------------------------------------------------- #

    def _draft(self) -> Optional[Tuple[StreamPlan, List[_Request]]]:
        """Pop the next micro-batch from the queue (stage 2, under lock).

        The queue head anchors the batch; every other queued request for
        the same operator joins in FIFO order until the column budget is
        hit.  Requests for other operators keep their relative order and
        wait for a later batch: the head is always served, so no operator
        starves.
        """
        with self._lock:
            if not self._queue:
                return None
            head = self._queue.popleft()
            op = head.ticket.operator
            plan = self._plans[op]
            budget = self.budget_for(op)
            batch = [head]
            cols = head.ticket.d
            rest: List[_Request] = []
            while self._queue:
                req = self._queue.popleft()
                if (req.ticket.operator == op
                        and cols + req.ticket.d <= budget):
                    batch.append(req)
                    cols += req.ticket.d
                else:
                    rest.append(req)
            self._queue.extend(rest)
            self._space.notify_all()
            return plan, batch

    def _stage(self, busy: Optional[torch.cuda.Event] = None
               ) -> Optional[_Staged]:
        """Draft the next batch and move its operand to the device (stage 3).

        Column concatenation at the staging dtype, padding to a multiple of
        the plan's ``coalesce_block_d``, then on the card a ``non_blocking``
        copy from pinned host memory on the side stream: called between
        dispatching and waiting on the previous batch, the copy overlaps
        device compute.  A lone pinned operand of the staging dtype (or, on
        the CPU, any lone operand of that dtype) is used as is.  ``busy``
        is the running batch's end event: whether it was still pending
        when this batch's copy was enqueued goes to ``copied_early``.
        """
        drafted = self._draft()
        if drafted is None:
            return None
        plan, batch = drafted
        t0 = time.perf_counter()
        t_batch = self.clock()
        for req in batch:
            req.ticket.batched_s = t_batch
        cols = sum(r.ticket.d for r in batch)
        block_d = plan.coalesce_block_d(cols)
        pad = (-cols) % block_d
        dtype, dev = _stage_dtype(plan), plan.device
        on_card = dev.type == "cuda"
        parts = [torch.as_tensor(r.b) for r in batch]
        head = parts[0]
        own = not (len(parts) == 1 and not pad and head.dtype == dtype
                   and head.device.type == "cpu"
                   and (not on_card or head.is_pinned()))
        if not own:
            wide = head
        else:
            # One serial row-by-row cat on the host (a strided copy_ per
            # part runs several times slower from the worker thread).
            parts = [p.to("cpu", dtype) for p in parts]
            if pad:
                parts.append(torch.zeros((plan.n, pad), dtype=dtype))
            wide = torch.empty((plan.n, cols + pad), dtype=dtype,
                               pin_memory=on_card)
            torch.cat(parts, dim=1, out=wide)
        staged = _Staged(plan=plan, requests=batch, b_dev=wide,
                         block_d=block_d, cols=cols + pad)
        if on_card:
            copy, _ = self._streams_for(dev)
            start, end = _timing_event(), _timing_event()
            with torch.cuda.stream(copy):
                start.record(copy)
                staged.b_dev = wide.to(dev, non_blocking=True)
                end.record(copy)
            if busy is not None:
                staged.copied_early = not busy.query()
            staged.h2d = (start, end)
            staged.nbytes = wide.numel() * wide.element_size()
            if own:
                # C has B's shape and dtype (every kernel returns B's
                # dtype), and its copy back is ordered after this copy out:
                # the engine's own pinned operand takes C in place.
                staged.host_out = wide
            staged.stage_host_ms = (time.perf_counter() - t0) * 1e3
        return staged

    # ------------------------------------------------------------- #
    # Execution (stage 4)
    # ------------------------------------------------------------- #

    def step(self) -> int:
        """Execute one micro-batch; returns the number of requests served.

        Consumes the staged batch if double buffering left one, else drafts
        fresh; dispatches its one ``execute_wide`` call on the engine's
        compute stream and, on the card, the copy of C back into pinned
        host memory; stages the *next* batch while the device computes
        (when the plan's kernel dispatches asynchronously); waits once;
        then hands each ticket its columns.  Returns 0 when the queue is
        idle.
        """
        staged = self._staged
        self._staged = None
        if staged is None:
            staged = self._stage()
        if staged is None:
            return 0
        plan, batch = staged.plan, staged.requests
        hints = plan.exec_hints()
        dev = plan.device
        try:
            events = None
            with self._compute_stream(dev):
                if staged.h2d is not None:
                    compute = torch.cuda.current_stream(dev)
                    compute.wait_event(staged.h2d[1])
                    staged.b_dev.record_stream(compute)
                    events = tuple(_timing_event() for _ in range(4))
                    events[0].record(compute)
                out = plan.execute_wide(staged.b_dev, block_d=staged.block_d)
                if events is not None:
                    events[1].record(compute)
                    host = staged.host_out
                    if host is None:
                        # A caller's operand: pin a buffer for C while the
                        # kernels run.
                        t_alloc = time.perf_counter()
                        host = torch.empty(out.shape, dtype=out.dtype,
                                           pin_memory=True)
                        staged.result_alloc_host_ms = \
                            (time.perf_counter() - t_alloc) * 1e3
                    events[2].record(compute)
                    host.copy_(out, non_blocking=True)
                    events[3].record(compute)
                else:
                    host = out
            if hints.get("donate_b"):
                staged.b_dev = None
            early = None
            if self.double_buffer and hints.get("async_dispatch", True):
                # Overlaps device compute.
                self._staged = self._stage(
                    busy=None if events is None else events[3])
                if self._staged is not None:
                    early = self._staged.copied_early
            if events is not None:
                events[3].synchronize()
        except Exception as exc:               # noqa: BLE001 - delivered
            t_done = self.clock()
            for req in batch:
                req.ticket._error = exc
                req.ticket.done_s = t_done
                req.ticket._event.set()
            raise
        t_done = self.clock()
        lo = 0
        for req in batch:
            tk = req.ticket
            tk._result = host[:, lo:lo + tk.d]
            lo += tk.d
            tk.done_s = t_done
            tk.batch_seq = self._batch_seq
            tk._event.set()
        with self._lock:
            self._batch_seq += 1
            self._counts["batches"] += 1
            self._counts["served"] += len(batch)
            if len(batch) > 1:
                self._counts["coalesced"] += len(batch)
            self._counts["deadline_miss"] += sum(
                1 for r in batch if r.ticket.met_deadline is False)
            self._latencies.extend(r.ticket.latency_s for r in batch)
            self._last_done_s = t_done
            oldest = min(r.ticket.submitted_s for r in batch)
            self.batch_log.append(BatchRecord(
                seq=self._batch_seq - 1, operator=batch[0].ticket.operator,
                chosen=plan.chosen,
                request_ids=tuple(r.ticket.id for r in batch),
                widths=tuple(r.ticket.d for r in batch),
                cols=staged.cols, block_d=staged.block_d,
                queued_s=batch[0].ticket.batched_s - oldest,
                exec_s=t_done - batch[0].ticket.batched_s))
            if events is not None:
                self.transfer_log.append(TransferRecord(
                    seq=self._batch_seq - 1,
                    h2d_ms=staged.h2d[0].elapsed_time(staged.h2d[1]),
                    kernel_ms=events[0].elapsed_time(events[1]),
                    d2h_ms=events[2].elapsed_time(events[3]),
                    bytes_in=staged.nbytes,
                    bytes_out=host.numel() * host.element_size(),
                    next_staged_early=early,
                    stage_host_ms=staged.stage_host_ms,
                    result_alloc_host_ms=staged.result_alloc_host_ms))
        if self.auto_replan:
            self._maybe_swap(batch[0].ticket.operator)
        return len(batch)

    def _maybe_swap(self, operator: str) -> None:
        """Atomic mid-stream plan swap when the reuse audit fired.

        ``maybe_replan`` rebuilds the plan *outside* the serving lock; only
        the reference swap happens under it, so admission never stalls
        behind a re-plan.  Batches already staged against the old plan run
        to completion on it.
        """
        with self._lock:
            plan = self._plans.get(operator)
        if plan is None:
            return
        fresh = plan.maybe_replan()
        if fresh is None:
            return
        with self._lock:
            # Swap only if nobody else swapped meanwhile.
            if self._plans.get(operator) is plan:
                self._plans[operator] = fresh
                self._counts["replans"] += 1

    def drain(self) -> int:
        """Serve until the queue (and any staged batch) is empty.

        Returns:
            Total requests served by this call.
        """
        total = 0
        while True:
            served = self.step()
            if served == 0 and self._staged is None:
                with self._lock:
                    if not self._queue:
                        return total
            total += served

    # ------------------------------------------------------------- #
    # Worker thread
    # ------------------------------------------------------------- #

    def start(self) -> None:
        """Spawn the worker thread consuming the queue (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stopping = False
            self._thread = threading.Thread(
                target=self._worker, name="serving-engine", daemon=True)
            self._thread.start()

    def stop(self, *, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop the worker thread.

        Args:
            drain: serve everything already admitted before exiting; False
                abandons queued requests (their tickets never complete:
                ``result(timeout=...)`` raises ``TimeoutError``).
            timeout: join timeout in seconds.
        """
        with self._lock:
            self._stopping = True
            self._drain_on_stop = drain
            self._work.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def _worker(self) -> None:
        """Worker loop: wait for admissions, serve batches until stopped.

        The wake condition covers the staged batch too: double buffering
        can leave a drafted batch in ``self._staged`` after the queue
        empties, and waiting on admissions alone would strand it until the
        next submit.
        """
        while True:
            with self._work:
                while (not self._queue and self._staged is None
                       and not self._stopping):
                    self._work.wait(0.1)
                if self._stopping and (not self._drain_on_stop
                                       or not self._queue):
                    if self._staged is None:
                        return
            self.step()

    # ------------------------------------------------------------- #
    # Accounting
    # ------------------------------------------------------------- #

    def stats(self) -> dict:
        """Counters + latency percentiles + goodput, as one dict.

        Keys: ``admitted`` / ``served`` / ``shed`` / ``batches`` /
        ``coalesced`` (requests that shared a batch) / ``replans`` /
        ``deadline_miss`` / ``queue_depth`` / ``mean_batch_cols`` /
        ``p50_us`` / ``p99_us`` (percentiles over served requests'
        submit-to-completion latencies) / ``goodput_rps`` (deadline-meeting
        completions per second of serving wall time) / ``operators`` (each
        registered plan's own ``stats()``).
        """
        with self._lock:
            lats = list(self._latencies)
            counts = dict(self._counts)
            depth = len(self._queue)
            log = list(self.batch_log)
            span = ((self._last_done_s - self._first_submit_s)
                    if self._latencies and self._first_submit_s is not None
                    else 0.0)
            ops = {name: p.stats() for name, p in self._plans.items()}
        good = counts["served"] - counts["deadline_miss"]
        out = dict(counts)
        out.update({
            "queue_depth": depth,
            "mean_batch_cols": (float(np.mean([r.cols for r in log]))
                                if log else 0.0),
            "p50_us": float(np.percentile(lats, 50) * 1e6) if lats else 0.0,
            "p99_us": float(np.percentile(lats, 99) * 1e6) if lats else 0.0,
            "goodput_rps": good / span if span > 0 else 0.0,
            "operators": ops,
        })
        return out

    def summary(self) -> str:
        """Human-readable audit: counters plus the recent batch log."""
        s = self.stats()
        lines = [
            f"ServingEngine(policy={self.policy}, "
            f"max_queue={self.max_queue}): "
            f"admitted={s['admitted']} served={s['served']} "
            f"shed={s['shed']} batches={s['batches']} "
            f"coalesced={s['coalesced']} replans={s['replans']}",
            f"  latency p50={s['p50_us']:.0f}us p99={s['p99_us']:.0f}us  "
            f"goodput={s['goodput_rps']:.1f} req/s  "
            f"deadline_miss={s['deadline_miss']}",
        ]
        for rec in list(self.batch_log)[-8:]:
            lines.append(
                f"  batch {rec.seq:4d} {rec.operator:>12s}[{rec.chosen}] "
                f"x{len(rec.request_ids)} widths={list(rec.widths)} "
                f"cols={rec.cols} block_d={rec.block_d} "
                f"queued={rec.queued_s * 1e6:.0f}us "
                f"exec={rec.exec_s * 1e6:.0f}us")
        return "\n".join(lines)
