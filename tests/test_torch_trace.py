"""The port's spans (``repro_torch.core.trace``) and the benchmark's readers
of them (``bench/metrics/``), on the CPU.

Request spans record only while a ``torch.profiler`` records; set-up spans
(``spmm.plan``, ``spmm.pack`` and what runs under them) always do.
"""
from __future__ import annotations

import pathlib
import threading
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import sparse
from repro_torch.core import patterns, trace
from repro_torch.sparse import formats

ROOT = pathlib.Path(__file__).resolve().parents[1]

SETUP_READERS = ("classify_s", "plan_stats_s", "pack_copy_s", "pack_host_s")
REQUEST_READERS = ("check_us.solve", "alloc_us.solve", "launch_us.solve")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cpu_plan():
    m = patterns.scale_free(2048, 8, seed=3)
    return m, sparse.plan(m, 8, device="cpu")


def _spans_since(n0: int) -> list:
    return trace.spans()[n0:]


def _reader(name: str):
    from bench import spec
    return spec.load_module(ROOT, "metrics", name).read


# ---------------------------------------------------------------------- #
# The request path
# ---------------------------------------------------------------------- #

def test_request_spans_need_the_profiler(cpu_plan):
    m, plan = cpu_plan
    b = torch.randn(m.n, 8)
    n0 = len(trace.spans())
    plan.execute(b)
    plan.execute_many_async([b, b])
    plan.execute_wide(torch.randn(m.n, 16))
    assert not trace.recording()
    assert len(trace.spans()) == n0

    # A disabled site: one flag read, no span, and no more allocated than
    # by a call that does nothing.
    def site():
        if trace.recording():
            trace.end(trace.begin("spmm.check"))

    def nothing():
        pass

    def allocated(fn):
        fn()
        tracemalloc.start()
        try:
            before = tracemalloc.get_traced_memory()[0]
            for _ in range(10_000):
                fn()
            return tracemalloc.get_traced_memory()[0] - before
        finally:
            tracemalloc.stop()

    assert allocated(site) <= allocated(nothing)
    assert len(trace.spans()) == n0


# execute_wide checks the whole B once, before the requests, so its slices
# have no spmm.check span.
@pytest.mark.parametrize("call,requests,checked", [
    (lambda plan, b: plan.execute(b), 1, True),
    (lambda plan, b: plan.execute_many_async([b, b]), 2, True),
    (lambda plan, b: plan.execute_wide(torch.cat([b, b, b], dim=1)), 3,
     False),
], ids=["execute", "execute_many_async", "execute_wide"])
def test_request_spans_under_the_profiler(cpu_plan, call, requests, checked):
    m, plan = cpu_plan
    b = torch.randn(m.n, 8)
    n0 = len(trace.spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert trace.recording()
        call(plan, b)
    assert not trace.recording()
    new = _spans_since(n0)
    roots = [s for s in new if s.name == "spmm.execute"]
    checks = [s for s in new if s.name == "spmm.check"]
    assert len(roots) == requests
    assert len(checks) == (requests if checked else 0)
    assert len({s.request_id for s in roots}) == requests
    for root in roots:
        assert root.parent_id is None and root.request_id == root.span_id
    for root, check in zip(roots, checks):
        assert check.parent_id == root.span_id
        assert check.request_id == root.request_id
        assert root.start_ns <= check.start_ns <= check.end_ns <= root.end_ns
    # The root opens a profiler range; its parts are recorded after the
    # launch, with none.
    names = {e.name for e in prof.events()}
    assert "spmm.execute" in names and "spmm.check" not in names


def test_a_wrapper_that_raises_leaves_no_span_open():
    """A kernel wrapper reached outside ``StreamPlan`` (as ``KernelSpec.run``
    reaches it) that raises in its checks under the profiler opens no span,
    so the plan, the pack and the request after it are roots and every
    reader reports."""
    from repro_torch.kernels import bcsr_spmm
    m = patterns.scale_free(1024, 8, seed=4)
    disp = sparse.Dispatcher(device="cpu", calibration=False, tree=False)
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError, match="block edge"):
            bcsr_spmm.bcsr_spmm_cuda(SimpleNamespace(t=0), torch.zeros(4, 2))
        assert trace.TRACER._stack() == []
        n0 = len(trace.spans())
        with trace.span("spmm.pack"):
            assert trace.in_setup()
        plan = sparse.plan(m, 8, dispatcher=disp)
        plan.execute(torch.randn(m.n, 8))
    new = _spans_since(n0)
    for name in ("spmm.plan", "spmm.pack", "spmm.execute"):
        assert all(s.parent_id is None for s in new if s.name == name)
    assert all(s.parent_id is not None for s in new
               if s.name == "spmm.check")
    for name in SETUP_READERS + REQUEST_READERS:
        assert _reader(name)(None) is not None


@pytest.mark.parametrize("cell,readers", [
    ("fem-small.solve-d4", SETUP_READERS + REQUEST_READERS),
    ("scalefree-small.stream-d64", SETUP_READERS),
])
def test_the_benchmark_reports_the_readers_of_its_cells(tmp_path, cell,
                                                        readers):
    """A traced run of the benchmark's small CPU cells through
    ``bench/run.py::run_cell``: each reader the cell lists reports."""
    import importlib.util
    import time
    from bench import run, spec
    src = importlib.util.spec_from_file_location(
        "bench_test_cells", ROOT / "bench" / "tests" / "conftest.py")
    cells = importlib.util.module_from_spec(src)
    src.loader.exec_module(cells)
    root = cells.add_small_cells(cells.copy_checkout(tmp_path))
    res = run.run_cell(root, spec.load_cell(root, cell), seed=2**31 + 17,
                       seconds=0.3, trace=True, device=torch.device("cpu"),
                       t0=time.perf_counter(), log=lambda s: None)
    assert res["correct"] is True
    for name in readers:
        assert res["metrics"][name]["value"] >= 0.0
    assert res["metrics"]["classify_s"]["value"] > 0.0
    if "check_us.solve" in readers:
        assert res["metrics"]["check_us.solve"]["value"] > 0.0


# ---------------------------------------------------------------------- #
# Plan and pack
# ---------------------------------------------------------------------- #

def test_plan_and_pack_spans_record_without_the_profiler():
    m = patterns.blocked(1024, 16, 64, 60.0, seed=5)
    disp = sparse.Dispatcher(device="cpu", calibration=False, tree=False)
    n0 = len(trace.spans())
    sparse.plan(m, 4, dispatcher=disp)
    assert not trace.recording()
    new = _spans_since(n0)
    (plan_root,) = [s for s in new if s.name == "spmm.plan"]
    (pack_root,) = [s for s in new if s.name == "spmm.pack"]
    assert plan_root.parent_id is None and pack_root.parent_id is None
    assert plan_root.attrs == {"d": 4, "strategy": "auto", "cached": False}
    assert pack_root.attrs["format"] in sparse.FORMATS
    by_id = {s.span_id: s for s in new}
    for s in new:
        top = s
        while top.parent_id is not None:
            top = by_id[top.parent_id]
        assert top in (plan_root, pack_root)
        assert s.request_id == top.request_id
        assert s.duration_ns <= top.duration_ns
    names = {s.name for s in new}
    assert {"spmm.plan.classify", "spmm.plan.stat", "spmm.plan.policy",
            "spmm.plan.candidate", "spmm.pack.convert",
            "spmm.pack.layout"} <= names
    summary = trace.summary(new)
    for root in (plan_root, pack_root):
        direct = sum(s.duration_ns for s in new
                     if s.parent_id == root.span_id)
        assert direct <= root.duration_ns
        row = summary[root.name]
        assert 0.0 <= row["self_s"] <= row["total_s"]
        for name in names:
            if name.startswith(root.name + "."):
                assert summary[name]["total_s"] <= row["total_s"]
    policies = [s for s in new if s.name == "spmm.plan.policy"]
    assert [s.attrs["format"] for s in policies] == list(sparse.FORMATS)
    for c in (s for s in new if s.name == "spmm.plan.candidate"):
        assert set(c.attrs) == {"format", "precision"}

    n1 = len(trace.spans())
    disp.plan(m, 4, reuse=sparse.BSpec(d=4).reuse)
    (again,) = [s for s in _spans_since(n1) if s.name == "spmm.plan"]
    assert again.attrs["cached"] is True


@pytest.mark.parametrize("root,device,recorded", [
    ("spmm.pack", "meta", True),
    ("spmm.plan", "meta", True),
    ("spmm.pack", "cpu", False),
    (None, "meta", False),
    ("spmm.execute", "meta", False),
])
def test_copy_span_only_leaves_the_host_under_a_setup_root(root, device,
                                                           recorded):
    a = np.arange(12, dtype=np.int32)
    n0 = len(trace.spans())
    if root is None:
        out = formats.tensor_from_host(a, device)
    else:
        with trace.span(root):
            out = formats.tensor_from_host(a, device)
    assert out.device.type == device
    copies = [s for s in _spans_since(n0) if s.name == "spmm.pack.copy"]
    if recorded:
        (copy,) = copies
        assert copy.attrs == {"bytes": a.nbytes}
    else:
        assert copies == []


# ---------------------------------------------------------------------- #
# The tracer
# ---------------------------------------------------------------------- #

def test_buffer_keeps_the_newest_and_counts_the_dropped():
    tr = trace.Tracer(max_spans=4)
    for i in range(6):
        with tr.span(f"s{i}"):
            pass
    assert [s.name for s in tr.spans()] == ["s2", "s3", "s4", "s5"]
    assert tr.dropped == 2
    tr.clear()
    assert tr.spans() == [] and tr.dropped == 0


def test_threads_keep_separate_stacks():
    tr = trace.Tracer()
    barrier = threading.Barrier(2, timeout=30)
    errors = []

    def work(tag):
        try:
            with tr.span(f"root.{tag}"):
                barrier.wait()
                with tr.span(f"child.{tag}"):
                    barrier.wait()
        except Exception as exc:  # reported by the test thread
            errors.append(exc)

    threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors
    by_name = {s.name: s for s in tr.spans()}
    for tag in "ab":
        root, child = by_name[f"root.{tag}"], by_name[f"child.{tag}"]
        assert root.parent_id is None
        assert child.parent_id == root.span_id
        assert child.request_id == root.request_id == root.span_id


def test_end_closes_what_an_exception_left_open():
    tr = trace.Tracer()
    with pytest.raises(RuntimeError):
        with tr.span("root"):
            tr.begin("left.open")
            raise RuntimeError("boom")
    (root,) = tr.spans()
    assert root.attrs == {"error": "RuntimeError"}
    with tr.span("next"):
        pass
    assert tr.spans()[-1].parent_id is None
    with pytest.raises(ValueError):
        tr.end(root)


def test_record_launch_records_the_parts_under_the_open_request():
    tr_spans = len(trace.spans())
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("spmm.execute", request=True) as root:
            t0 = trace.now()
            t1, t2 = t0 + 10, t0 + 30
            trace.record_launch(t0, t1, t2)
    parts = [s for s in _spans_since(tr_spans) if s is not root]
    assert [(s.name, s.start_ns, s.end_ns) for s in parts][:2] == [
        ("spmm.check", t0, t1), ("spmm.alloc", t1, t2)]
    assert parts[2].name == "spmm.launch" and parts[2].start_ns == t2
    assert t2 <= parts[2].end_ns <= root.end_ns
    for s in parts:
        assert s.parent_id == root.span_id
        assert s.request_id == root.request_id == root.span_id
    names = {e.name for e in prof.events()}
    assert "spmm.execute" in names
    assert not names & {"spmm.check", "spmm.alloc", "spmm.launch"}


def _span(name, start, end, sid, parent=None):
    return trace.Span(name, start_ns=start, end_ns=end, span_id=sid,
                      parent_id=parent)


def test_summary_self_time_is_duration_less_children():
    spans = [_span("p", 0, 100, 1), _span("c", 10, 30, 2, 1),
             _span("c", 20, 50, 3, 1), _span("g", 60, 70, 4, 1),
             _span("g", 11, 12, 5, 2)]
    s = trace.summary(spans)
    assert s["p"] == {"count": 1, "total_s": 100e-9,
                      "self_s": pytest.approx(50e-9)}
    assert s["c"]["count"] == 2
    assert s["c"]["total_s"] == pytest.approx(50e-9)
    assert s["c"]["self_s"] == pytest.approx(49e-9)


# ---------------------------------------------------------------------- #
# The benchmark's readers
# ---------------------------------------------------------------------- #

def _two_runs() -> list:
    """An earlier run (plan root 1) and the latest one (plan root 10)."""
    return [
        _span("spmm.plan", 0, 100, 1),
        _span("spmm.plan.classify", 10, 20, 2, 1),
        _span("spmm.pack", 100, 200, 3),
        _span("spmm.pack.copy", 110, 190, 4, 3),
        _span("spmm.execute", 300, 400, 5),
        _span("spmm.check", 300, 390, 6, 5),
        # The latest run.
        _span("spmm.plan", 1000, 2000, 10),
        _span("spmm.plan.classify", 1100, 1300, 11, 10),
        _span("spmm.plan.stat", 1300, 1350, 12, 10),
        _span("spmm.plan.policy", 1390, 1420, 14, 10),
        _span("spmm.plan.stat", 1400, 1410, 13, 14),
        _span("spmm.pack", 2100, 3100, 20),
        _span("spmm.pack.layout", 2110, 3000, 21, 20),
        _span("spmm.pack.copy", 2200, 2300, 22, 21),
        _span("spmm.pack.copy", 2400, 2450, 23, 21),
        _span("spmm.execute", 4000, 4100, 30),
        _span("spmm.check", 4000, 4010, 31, 30),
        _span("spmm.check", 4020, 4030, 32, 30),
        _span("spmm.alloc", 4030, 4050, 33, 30),
        _span("spmm.launch", 4050, 4090, 34, 30),
        _span("spmm.execute", 5000, 5100, 40),
        _span("spmm.check", 5000, 5020, 41, 40),
        # A child with no root of its own is not counted.
        _span("spmm.check", 6000, 6900, 50),
    ]


LATEST = {"classify_s": 200e-9, "plan_stats_s": 60e-9,
          "pack_copy_s": 150e-9, "pack_host_s": 850e-9,
          "check_us.solve": 0.02, "alloc_us.solve": 0.01,
          "launch_us.solve": 0.02}


@pytest.mark.parametrize("name", SETUP_READERS + REQUEST_READERS)
def test_readers_take_the_latest_run(name):
    assert _reader(name)(None, spans=_two_runs()) == \
        pytest.approx(LATEST[name])


@pytest.mark.parametrize("name", SETUP_READERS + REQUEST_READERS)
def test_readers_read_zero_without_children_and_none_without_a_root(name):
    roots = [_span("spmm.plan", 0, 10, 1), _span("spmm.pack", 10, 20, 2),
             _span("spmm.execute", 30, 40, 3)]
    read = _reader(name)
    # With no copy, the whole pack is host time.
    alone = 10e-9 if name == "pack_host_s" else 0.0
    assert read(None, spans=roots) == pytest.approx(alone)
    if name in REQUEST_READERS:
        own = "spmm.execute"
    elif name.startswith("pack"):
        own = "spmm.pack"
    else:
        own = "spmm.plan"
    without = [s for s in roots if s.name != own]
    if own != "spmm.plan":
        assert read(None, spans=without) is None
    assert read(None, spans=[s for s in roots
                             if s.name != "spmm.plan"]) is None


def test_pack_readers_sum_to_the_pack_root():
    spans = _two_runs()
    copy = _reader("pack_copy_s")(None, spans=spans)
    host = _reader("pack_host_s")(None, spans=spans)
    assert copy + host == pytest.approx(1000e-9)
