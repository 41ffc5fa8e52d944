"""The port's serving engine on the CPU, case for case with the reference.

The reference's ``tests/test_engine.py`` cases run against
``repro_torch.sparse.ServingEngine`` (coalescing, backpressure, the
fake-clock latency arithmetic, warm-up, re-plan swap, the worker thread).
A differential test then sends one seeded sequence of submissions (two
operators, mixed widths, an injected fake clock, deterministic
``submit``/``step``/``drain``) through the reference's engine and the
port's, on two plan pairs: the port's ``torch`` plan against the
reference's ``jax`` plan, and the port's ``cuda`` plan (plain versions on
the CPU) against the reference's ``pallas`` plan (interpret mode).  The
batch logs, the counters and the latency percentiles must be equal, and
every result within ``4 * eps * (|A| @ |B|) + ATOL + RTOL * |C|`` per side.
Every ``result()`` and ``join()`` of a threaded test has a timeout.
"""
from __future__ import annotations

import dataclasses
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparse as ref_sparse
from repro.core import hardware as ref_hw
from repro.core import patterns as ref_patterns
from repro.sparse import formats as ref_fmt
from repro.sparse.dispatch import Dispatcher as RefDispatcher

from repro_torch import interop
from repro_torch import sparse
from repro_torch.core import hardware as port_hw
from repro_torch.core.patterns import blocked
from repro_torch.sparse.dispatch import Dispatcher

N = 256
RTOL = ATOL = 5e-4
PAIRS = [("torch", "jax"), ("cuda", "pallas")]


class FakeClock:
    """Injectable monotonic clock: advances only when the test says so."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def tick(self, dt):
        self.t += dt


def _disp(backend="auto"):
    return Dispatcher(port_hw.HOST_CPU, backend=backend, device="cpu",
                      calibration=False, tree=False)


def _mat(seed=3):
    return blocked(N, t=32, num_blocks=8, nnz_per_block=64, seed=seed)


def _b(d, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(N, d)).astype(np.float32))


def _plan(m=None, d=8, reuse=64, backend="auto"):
    return sparse.plan(_mat() if m is None else m,
                       sparse.BSpec(d=d, reuse=reuse),
                       dispatcher=_disp(backend))


def _engine(plan=None, **kw):
    kw.setdefault("clock", FakeClock())
    eng = sparse.ServingEngine(**kw)
    eng.register("spmm", _plan(reuse=1024) if plan is None else plan)
    return eng


def _spmm(m, b):
    return _disp().spmm(m, b)


# --------------------------------------------------------------------- #
# Numerics: coalesced batches must match per-request execution.
# --------------------------------------------------------------------- #

def test_engine_matches_per_request_execution():
    """Mixed-width coalesced serving == per-call spmm."""
    m = _mat()
    eng = _engine(plan=_plan(m))
    bs = [_b(8, seed=0), _b(4, seed=1), _b(8, seed=2), _b(4, seed=3)]
    tickets = [eng.submit("spmm", b) for b in bs]
    assert eng.drain() == len(bs)
    for tk, b in zip(tickets, bs):
        got = tk.result(timeout=0)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        assert tuple(got.shape) == (N, b.shape[1])
        torch.testing.assert_close(got, _spmm(m, b), rtol=1e-5, atol=1e-5)
    # All four shared one launch: coalescing, not width, did the batching.
    assert eng.stats()["batches"] == 1
    assert eng.stats()["coalesced"] == 4
    assert not eng.transfer_log          # no card, no transfer record


def test_numpy_operands_are_staged_at_the_plan_dtype():
    m = _mat()
    eng = _engine(plan=_plan(m))
    b = np.random.default_rng(9).normal(size=(N, 8))        # float64
    t = eng.submit("spmm", b)
    eng.drain()
    got = t.result(timeout=0)
    assert got.dtype == torch.float32
    ref = _spmm(m, torch.from_numpy(b.astype(np.float32)))
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- #
# Coalescing invariants: operator purity, budget, FIFO.
# --------------------------------------------------------------------- #

def test_batches_never_mix_operators_and_respect_budget():
    eng = _engine(max_batch_cols=16, double_buffer=False)
    eng.register("other", _plan(_mat(seed=7)))
    order = ["spmm", "other", "spmm", "other", "spmm", "spmm", "other"]
    for i, op in enumerate(order):
        eng.submit(op, _b(8, seed=i))
    assert eng.drain() == len(order)
    assert len(eng.batch_log) >= 4       # 16-col budget = 2 requests max
    for rec in eng.batch_log:
        assert sum(rec.widths) <= 16
        assert len(set(rec.request_ids)) == len(rec.request_ids)
    for op in ("spmm", "other"):
        ids = [rid for rec in eng.batch_log if rec.operator == op
               for rid in rec.request_ids]
        assert ids == sorted(ids)
    served_ids = sorted(rid for rec in eng.batch_log
                        for rid in rec.request_ids)
    assert served_ids == list(range(len(order)))


def test_head_of_queue_anchors_the_batch():
    """The queue head is always in the next batch: no operator starves."""
    eng = _engine(double_buffer=False)
    eng.register("other", _plan(_mat(seed=7)))
    eng.submit("other", _b(8, seed=0))
    for i in range(3):
        eng.submit("spmm", _b(8, seed=1 + i))
    eng.step()
    first = eng.batch_log[-1]
    assert first.operator == "other" and first.request_ids == (0,)
    eng.drain()
    assert eng.stats()["served"] == 4


def test_budget_floors_at_planned_width():
    """A planned-width request is always servable, whatever the cap."""
    eng = _engine(max_batch_cols=1)
    assert eng.budget_for("spmm") == 8
    t = eng.submit("spmm", _b(8))
    eng.drain()
    assert tuple(t.result(timeout=0).shape) == (N, 8)


def test_coalesce_budget_properties():
    plan = _plan()
    small = sparse.coalesce_budget(plan, stage_bytes=1)
    assert small == plan.spec.d          # floored at the planned width
    big = sparse.coalesce_budget(plan, stage_bytes=8 * 2 ** 20)
    assert big >= small and big % plan.spec.d == 0
    assert big == (8 * 2 ** 20 // (plan.n * 4)) // 8 * 8


# --------------------------------------------------------------------- #
# Backpressure: bounded queue, shed vs wait.
# --------------------------------------------------------------------- #

def test_shed_policy_rejects_at_admission():
    eng = _engine(max_queue=2, policy="shed")
    eng.submit("spmm", _b(8, seed=0))
    eng.submit("spmm", _b(8, seed=1))
    with pytest.raises(sparse.ShedError):
        eng.submit("spmm", _b(8, seed=2))
    s = eng.stats()
    assert s["admitted"] == 2 and s["shed"] == 1
    assert eng.drain() == 2              # admitted requests still serve


def test_wait_policy_timeout_sheds():
    eng = _engine(max_queue=1, policy="wait")
    eng.submit("spmm", _b(8, seed=0))
    with pytest.raises(sparse.ShedError):
        eng.submit("spmm", _b(8, seed=1), timeout=0.01)
    assert eng.stats()["shed"] == 1


def test_bad_submissions_raise():
    eng = _engine()
    with pytest.raises(KeyError):
        eng.submit("nope", _b(8))
    with pytest.raises(ValueError):
        eng.submit("spmm", torch.zeros((N + 1, 8)))
    with pytest.raises(ValueError):
        sparse.ServingEngine(policy="drop")
    with pytest.raises(ValueError):
        sparse.ServingEngine(max_queue=0)


# --------------------------------------------------------------------- #
# Latency accounting: hand-computed percentiles and goodput.
# --------------------------------------------------------------------- #

def test_latency_and_goodput_match_hand_computed_values():
    clock = FakeClock()
    eng = _engine(clock=clock, double_buffer=False)
    # r0 at t=0 with a deadline it will miss; r1 at t=0.5; batch at t=1.
    t0 = eng.submit("spmm", _b(8, seed=0), deadline_s=0.4)
    clock.tick(0.5)
    t1 = eng.submit("spmm", _b(8, seed=1))
    clock.tick(0.5)
    assert eng.step() == 2
    assert t0.latency_s == pytest.approx(1.0)
    assert t1.latency_s == pytest.approx(0.5)
    assert t0.met_deadline is False and t1.met_deadline is None
    s = eng.stats()
    lats_us = [0.5e6, 1.0e6]
    assert s["p50_us"] == pytest.approx(np.percentile(lats_us, 50))
    assert s["p99_us"] == pytest.approx(np.percentile(lats_us, 99))
    assert s["deadline_miss"] == 1
    assert s["goodput_rps"] == pytest.approx(1.0)
    rec = eng.batch_log[-1]
    assert rec.queued_s == pytest.approx(1.0)    # oldest member waited 1s
    assert rec.exec_s == pytest.approx(0.0)
    assert t0.batch_seq == t1.batch_seq == 0


def test_reset_stats_clears_accounting_only():
    eng = _engine()
    eng.submit("spmm", _b(8))
    eng.drain()
    assert eng.stats()["served"] == 1
    eng.reset_stats()
    s = eng.stats()
    assert s["served"] == s["batches"] == 0
    assert s["p50_us"] == s["goodput_rps"] == 0.0
    t = eng.submit("spmm", _b(8))        # plans + id numbering survive
    eng.drain()
    assert t.id == 1 and eng.stats()["served"] == 1


# --------------------------------------------------------------------- #
# Warm-up, re-plan swap, summary, errors.
# --------------------------------------------------------------------- #

def test_warmup_primes_size_classes_without_skewing_reuse():
    eng = _engine()
    warmed = eng.warmup("spmm")
    assert warmed >= 1
    assert eng.plan_for("spmm").executed == 0
    assert eng.stats()["served"] == 0


def test_auto_replan_swaps_plan_atomically():
    plan = _plan(reuse=1)
    eng = _engine(plan=plan, max_batch_cols=8, double_buffer=False,
                  auto_replan=True)
    for i in range(6):                   # single-request batches drift
        eng.submit("spmm", _b(8, seed=i))
    eng.drain()
    assert eng.stats()["replans"] >= 1
    fresh = eng.plan_for("spmm")
    assert fresh is not plan
    assert fresh.spec.reuse >= plan.spec.reuse
    t = eng.submit("spmm", _b(8))        # fresh plan serves
    eng.drain()
    assert tuple(t.result(timeout=0).shape) == (N, 8)


def test_summary_renders_batch_log():
    eng = _engine()
    eng.submit("spmm", _b(8, seed=0))
    eng.submit("spmm", _b(4, seed=1))
    eng.drain()
    text = eng.summary()
    assert "admitted=2" in text and "batch " in text
    assert "widths=[8, 4]" in text


def test_failed_launch_reaches_every_ticket_of_its_batch():
    plan = _plan()
    eng = _engine(plan=plan, double_buffer=False)
    tickets = [eng.submit("spmm", _b(8, seed=s)) for s in range(3)]

    def boom(b, *, block_d=None):
        raise RuntimeError("launch failed")
    plan.execute_wide = boom
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.step()
    for t in tickets:
        assert t.done()
        with pytest.raises(RuntimeError, match="launch failed"):
            t.result(timeout=0)
    assert eng.stats()["served"] == 0


def test_sharded_plan_registers_like_any_other():
    from repro_torch.launch.mesh import ShardMesh
    m = _mat()
    plan = sparse.plan(m, sparse.BSpec(d=8, reuse=64),
                       mesh=ShardMesh(["cpu"] * 2), dispatcher=_disp())
    eng = _engine(plan=plan)
    bs = [_b(8, seed=0), _b(4, seed=1), _b(8, seed=2)]
    tickets = [eng.submit("spmm", b) for b in bs]
    assert eng.drain() == 3
    for rec in eng.batch_log:
        assert rec.block_d == 8          # sharded replay: planned width
    for t, b in zip(tickets, bs):
        torch.testing.assert_close(t.result(timeout=0), _spmm(m, b),
                                   rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------- #
# Worker thread: real clock, real threads, every wait bounded.
# --------------------------------------------------------------------- #

def test_worker_thread_serves_submissions():
    eng = sparse.ServingEngine(max_queue=4, policy="wait")
    m = _mat()
    eng.register("spmm", _plan(m))
    eng.warmup("spmm")
    eng.start()
    eng.start()                          # idempotent
    thread = eng._thread
    try:
        bs = [_b(8, seed=s) for s in range(8)]   # > max_queue: wait kicks in
        tickets = [eng.submit("spmm", b) for b in bs]
        outs = [t.result(timeout=120.0) for t in tickets]
    finally:
        eng.stop(timeout=120.0)
    assert not thread.is_alive()
    for out, b in zip(outs, bs):
        torch.testing.assert_close(out, _spmm(m, b), rtol=1e-5, atol=1e-5)
    assert eng.stats()["served"] == 8 and eng.pending() == 0


def test_concurrent_submitters_lose_no_request():
    """More submitter threads than cores, a short switch interval: every
    admitted request is served once, with its own columns."""
    m = _mat()
    eng = sparse.ServingEngine(max_queue=8, policy="wait")
    eng.register("spmm", _plan(m))
    eng.start()
    threads_n, per = 12, 4
    results: dict = {}
    lock = threading.Lock()

    def submitter(k: int) -> None:
        for j in range(per):
            seed = 100 * k + j
            b = _b(4 + (seed % 3) * 2, seed=seed)
            t = eng.submit("spmm", b, timeout=60.0)
            with lock:
                results[seed] = (t, b)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter, args=(k,))
                   for k in range(threads_n)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120.0)
        assert not any(th.is_alive() for th in threads)
        outs = {s: t.result(timeout=120.0) for s, (t, _) in results.items()}
    finally:
        sys.setswitchinterval(old)
        eng.stop(timeout=120.0)
    assert len(results) == threads_n * per
    s = eng.stats()
    assert s["admitted"] == s["served"] == threads_n * per
    ids = [t.id for t, _ in results.values()]
    assert sorted(ids) == list(range(threads_n * per))
    for seed, (_, b) in results.items():
        torch.testing.assert_close(outs[seed], _spmm(m, b), rtol=1e-5,
                                   atol=1e-5)


# --------------------------------------------------------------------- #
# The reference's engine and the port's, on one sequence of submissions.
# --------------------------------------------------------------------- #

def _ref_mats():
    return {"a": ref_patterns.block_diagonal(N, t=32, seed=5),
            "b": ref_patterns.scale_free(N, avg_degree=6, seed=6)}


#: (operator, width, seed) submissions, ticks and steps.
SCRIPT = (
    [("submit", "a", 8, 0), ("submit", "b", 4, 1), ("tick", 0.25),
     ("submit", "a", 4, 2), ("submit", "a", 8, 3), ("step",),
     ("tick", 0.5), ("submit", "b", 8, 4), ("submit", "b", 8, 5),
     ("submit", "a", 16, 6), ("step",), ("tick", 0.125)]
    + [("submit", "a" if i % 3 else "b", (4, 8, 12)[i % 3], 10 + i)
       for i in range(14)]
    + [("step",), ("tick", 1.0), ("drain",),
       ("submit", "b", 8, 40), ("tick", 0.5), ("drain",)])


def _assert_within(m, b, got, ref, eps, what):
    dense = np.asarray(ref_fmt.coo_to_dense(m), np.float64)
    absprod = 4.0 * eps * (np.abs(dense) @ np.abs(b.astype(np.float64)))
    g = np.asarray(got, np.float64)
    r = np.asarray(ref, np.float64)
    assert g.shape == r.shape and np.isfinite(g).all(), what
    bound = 2 * (absprod + ATOL) + RTOL * (np.abs(g) + np.abs(r))
    assert np.all(np.abs(g - r) <= bound), (
        f"{what}: exceeds the bound by "
        f"{float(np.max(np.abs(g - r) - bound)):.3e}")


def _bridge(m):
    return interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                  m.meta)


_COUNT_KEYS = ("admitted", "served", "shed", "batches", "coalesced",
               "replans", "deadline_miss", "queue_depth", "mean_batch_cols",
               "p50_us", "p99_us", "goodput_rps")


@pytest.mark.parametrize("max_queue,reuse_a", [(256, 4), (3, 1024)])
@pytest.mark.parametrize("port_backend,ref_backend", PAIRS)
def test_engine_equals_reference_on_one_sequence(port_backend, ref_backend,
                                                 max_queue, reuse_a):
    mats = _ref_mats()
    ref_disp = RefDispatcher(ref_hw.HOST_CPU, backend=ref_backend,
                             calibration=False, tree=False)
    port_disp = Dispatcher(port_hw.HOST_CPU, backend=port_backend,
                           device="cpu", calibration=False, tree=False)
    engines = []
    for pkg, disp, mk in ((ref_sparse, ref_disp, jnp.asarray),
                          (sparse, port_disp, torch.from_numpy)):
        clock = FakeClock()
        eng = pkg.ServingEngine(max_queue=max_queue, policy="shed",
                                clock=clock, stage_bytes=64 * N * 4)
        for op, m in mats.items():
            mm = m if pkg is ref_sparse else _bridge(m)
            eng.register(op, pkg.plan(
                mm, pkg.BSpec(d=8, reuse=reuse_a if op == "a" else 1024),
                dispatcher=disp))
        tickets = []
        shed = 0
        for ev in SCRIPT:
            try:
                tickets.extend(_run_script_event(eng, clock, ev, mk))
            except pkg.ShedError:
                shed += 1
        engines.append((eng, tickets, shed))
    (ref_eng, ref_tk, ref_shed), (port_eng, port_tk, port_shed) = engines
    assert port_shed == ref_shed
    ref_log = [dataclasses.asdict(r) for r in ref_eng.batch_log]
    port_log = [dataclasses.asdict(r) for r in port_eng.batch_log]
    assert port_log == ref_log
    rs, ps = ref_eng.stats(), port_eng.stats()
    for k in _COUNT_KEYS:
        assert ps[k] == rs[k], k
    for op in mats:
        assert port_eng.plan_for(op).chosen == ref_eng.plan_for(op).chosen
        assert port_eng.budget_for(op) == ref_eng.budget_for(op)
    assert len(port_tk) == len(ref_tk)
    for (pt, op, b), (rt, _, _) in zip(port_tk, ref_tk):
        assert (pt.id, pt.d, pt.batch_seq, pt.latency_s, pt.met_deadline) \
            == (rt.id, rt.d, rt.batch_seq, rt.latency_s, rt.met_deadline)
        _assert_within(mats[op], b, pt.result(timeout=0).numpy(),
                       np.asarray(rt.result(timeout=0)), 2.0 ** -23,
                       f"ticket {pt.id}")


def _run_script_event(engine, clock, ev, make_b):
    """One scripted event; returns the (ticket, operator, b) it admitted."""
    if ev[0] == "submit":
        _, op, d, seed = ev
        b = np.random.default_rng(seed).normal(size=(N, d)).astype(
            np.float32)
        deadline = 0.6 if seed % 4 == 0 else None
        return [(engine.submit(op, make_b(b), deadline_s=deadline), op, b)]
    if ev[0] == "tick":
        clock.tick(ev[1])
    elif ev[0] == "step":
        engine.step()
    else:
        engine.drain()
    return []


@pytest.mark.parametrize("stage_bytes", [1, 8 * 2 ** 20, 3 * 2 ** 20 + 7])
@pytest.mark.parametrize("token", ["f32i32", "bf16i32", "bf16i16"])
@pytest.mark.parametrize("structure",
                         sorted(ref_patterns.serving_suite(N)))
def test_coalesce_budget_equals_reference(structure, token, stage_bytes):
    m = ref_patterns.serving_suite(N)[structure]()
    for port_backend, ref_backend in PAIRS:
        if token == "bf16i16" and port_backend == "torch":
            continue                  # torch specs keep int32 indices
        ref = ref_sparse.plan(
            m, ref_sparse.BSpec(d=16, reuse=8), precision=token,
            dispatcher=RefDispatcher(ref_hw.HOST_CPU, backend=ref_backend,
                                     calibration=False, tree=False))
        port = sparse.plan(
            _bridge(m), sparse.BSpec(d=16, reuse=8), precision=token,
            dispatcher=Dispatcher(port_hw.HOST_CPU, backend=port_backend,
                                  device="cpu", calibration=False,
                                  tree=False))
        assert port.precision == ref.precision == token
        assert sparse.coalesce_budget(port, stage_bytes=stage_bytes) == \
            ref_sparse.coalesce_budget(ref, stage_bytes=stage_bytes)
