"""HPCG's 27-point stencil through the port's DIA path, on the CPU.

The port (``sparse.plan``, auto and forced ``dia``, on the default CPU
dispatcher and on one that plans the ``cuda`` specs for an H100, whose
kernels take their plain PyTorch versions here) against the plain float64
reference ``bench/stencil27_reference.py``, written from the grid alone.
Also: the packed layout is the k diagonals and nothing else, the
conversion's offsets and chunked scatter, its ``spmm.pack.diagonals``
span, and the benchmark's new pieces (``bench/gen/stencil27.py``,
``bench/roofline_least.py``, ``bench/stencil27_check.py`` and the readers
of ``hpcg.stream-d64``).

Tolerance: C elementwise within ``(K + 1) * 2**-24 * (|A| @ |B|)``, the
float32 bound for a sum of K = 27 products of float32 operands (one
rounding per product and per addition), against the float64 reference on
the same float32 B.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest
import torch

from repro_torch import sparse
from repro_torch.core import trace
from repro_torch.core.hardware import H100
from repro_torch.core.patterns import COOMatrix
from repro_torch.kernels import banded_spmm as banded_module
from repro_torch.kernels import registry
from repro_torch.sparse import formats

ROOT = pathlib.Path(__file__).resolve().parents[1]

_spec = importlib.util.spec_from_file_location(
    "stencil27_reference", ROOT / "bench" / "stencil27_reference.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

#: (nx, ny, nz): a non-cube small enough for every width, and 24^3, whose
#: farthest offset (601) lies more than 4 blocks of 128 away.
GRIDS = [(6, 5, 4), (24, 24, 24)]
GRID_IDS = ["6x5x4", "24x24x24"]
K = 27
TOL = (K + 1) * 2.0 ** -24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _operator(grid, seed=1):
    nx, ny, nz = grid
    coef = ref.random_coefficients(nx, ny, nz, seed)
    rows, cols, vals = ref.coo(coef)
    m = COOMatrix(n=nx * ny * nz, rows=rows.to(torch.int32).numpy(),
                  cols=cols.to(torch.int32).numpy(), vals=vals.numpy(),
                  pattern="diagonal")
    return coef, m


def _dispatcher(backend):
    if backend == "torch":
        return sparse.Dispatcher(device="cpu", calibration=False, tree=False)
    return sparse.Dispatcher(H100, backend="cuda", device="cpu",
                             calibration=False, tree=False)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("strategy", ["auto", "dia"])
@pytest.mark.parametrize("d", [1, 4, 64, 65])
@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_plan_matches_the_stencil_reference(grid, d, strategy, backend):
    coef, m = _operator(grid, seed=d)
    plan = sparse.plan(m, d, strategy=strategy,
                       dispatcher=_dispatcher(backend))
    assert plan.chosen == "dia" and plan.precision == "f32i32"
    if backend == "cuda":
        assert isinstance(plan.layout, banded_module.BandLayout)
    b = torch.from_numpy(np.random.default_rng(d).normal(
        size=(m.n, d)).astype(np.float32))
    got = plan.execute(b)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m.n, d)
    want = ref.apply(coef, b)
    mag = ref.apply(coef.abs(), b.abs())
    err = (got.double() - want).abs()
    assert bool((err <= TOL * mag).all()), float((err / mag).max())


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_packed_layout_is_the_diagonals_and_no_band(grid):
    coef, m = _operator(grid)
    nx, ny, nz = grid
    ctx = registry.KernelContext(device=torch.device("cpu"), plan_d=64)
    layout = registry.get("dia", "cuda").prepare(m, ctx)
    assert {f.name for f in dataclasses.fields(layout)} == \
        {"offsets", "diags", "n"}
    assert layout.n == m.n
    assert layout.offsets.dtype == torch.int32
    assert layout.offsets.tolist() == list(ref.offsets(nx, ny))
    assert layout.diags.numel() == K * m.n
    assert tuple(layout.diags.shape) == (K, m.n)
    # diags[s, r] is point r's coefficient for its s-th neighbour, 0 where
    # that neighbour leaves the grid.
    for s in range(K):
        want = (coef[s] * ref.inside(nx, ny, nz, s)).reshape(-1)
        assert torch.equal(layout.diags[s], want.to(torch.float32))
    span = max(abs(o) for o in ref.offsets(nx, ny))
    if grid == (24, 24, 24):
        # The reference's band at t = 128 would be 2w + 1 = 11 block
        # offsets wide, [nb, 11, 128, 128]: 11 * 128 values a row.
        assert span == 601 and 2 * -(-span // 128) + 1 == 11


def test_footprint_counts_the_staged_diagonals_and_the_window():
    ctx = registry.KernelContext(max_dia_offsets=64)
    spec = registry.get("dia", "cuda")
    assert spec.footprint(2**20, 64, ctx) == \
        4 * 64 * banded_module.ROWS + banded_module.WINDOW_BUDGET
    bf16 = registry.KernelContext(
        max_dia_offsets=64, precision=formats.as_precision("bf16i32"))
    assert spec.footprint(2**20, 64, bf16) == \
        2 * 64 * banded_module.ROWS + banded_module.WINDOW_BUDGET


@pytest.mark.parametrize("chunk", [1, 7, 1000])
def test_dia_conversion_chunks_give_the_same_storage(monkeypatch, chunk):
    """The offsets come off the bitmap, equal to ``np.unique`` of every
    ``c - r``; a scatter in chunks of any size gives the same ``[k, n]``,
    duplicates resolved as one scatter resolves them (the last wins)."""
    _, m = _operator((6, 5, 4))
    whole = formats.coo_to_dia(m)
    rng = np.random.default_rng(chunk)
    dup = rng.integers(0, m.nnz, 20)
    m2 = COOMatrix(n=m.n, rows=np.concatenate([m.rows, m.rows[dup]]),
                   cols=np.concatenate([m.cols, m.cols[dup]]),
                   vals=np.concatenate([m.vals, m.vals[dup] + 1.0]),
                   pattern="diagonal")
    dense = np.zeros((m.n, m.n), np.float32)
    dense[m2.rows, m2.cols] = m2.vals
    monkeypatch.setattr(formats, "DIA_CHUNK", chunk)
    assert formats.diagonal_offsets(m).tolist() == \
        np.unique(m.cols.astype(np.int64) - m.rows).tolist()
    small = formats.coo_to_dia(m)
    assert small.offsets == whole.offsets
    assert torch.equal(small.data, whole.data)
    again = formats.coo_to_dia(m2)
    for j, off in enumerate(again.offsets):
        r = np.arange(max(0, -off), min(m.n, m.n - off))
        assert np.array_equal(again.data[j, r].numpy(), dense[r, r + off])


def test_launch_counts_reset_the_window_modes_too():
    from repro_torch import kernels
    banded_module.LAUNCHES_BY_WINDOW["none"] += 3
    kernels.reset_launch_counts()
    assert banded_module.LAUNCHES_BY_WINDOW == \
        dict.fromkeys(banded_module.WINDOWS, 0)


def test_dia_conversion_refuses_too_many_diagonals():
    _, m = _operator((6, 5, 4))
    with pytest.raises(ValueError, match="27 distinct diagonals"):
        formats.coo_to_dia(m, max_offsets=26)


def _spans_since(t0: int) -> list:
    return [s for s in trace.spans() if s.start_ns >= t0]


def test_pack_records_the_diagonals_span():
    """Under the pack the conversion records its span; called outside a
    set-up root it records nothing."""
    _, m = _operator((24, 24, 24))
    t0 = time.perf_counter_ns()
    formats.coo_to_dia(m)
    assert _spans_since(t0) == []
    sparse.plan(m, 64, dispatcher=_dispatcher("cuda"))
    new = _spans_since(t0)
    by_id = {s.span_id: s for s in new}
    (pack,) = [s for s in new if s.name == "spmm.pack"]
    (diag,) = [s for s in new if s.name == "spmm.pack.diagonals"]
    assert diag.attrs == {"diagonals": K, "span": 1202,
                          "bytes": K * m.n * 4}
    top = diag
    while top.parent_id is not None:
        top = by_id[top.parent_id]
    assert top is pack and diag.duration_ns <= pack.duration_ns


# ---------------------------------------------------------------------- #
# The benchmark's pieces
# ---------------------------------------------------------------------- #

def _bench(name):
    from bench import spec
    return spec.load_module(ROOT, "metrics", name).read


@pytest.mark.parametrize("grid", GRIDS + [(3, 3, 3), (104, 2, 3)],
                         ids=GRID_IDS + ["3x3x3", "104x2x3"])
def test_generator_gives_the_reference_pattern(grid):
    from bench.gen import stencil27
    nx, ny, nz = grid
    params = {"nx": nx, "ny": ny, "nz": nz}
    rows, cols = stencil27.generate(nx * ny * nz, params, torch.Generator())
    assert rows.dtype == cols.dtype == torch.int32
    assert rows.numel() == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    key = rows.long() * nx * ny * nz + cols.long()
    assert bool((key[1:] > key[:-1]).all()), "row-sorted, no duplicates"
    want_r, want_c, _ = ref.coo(torch.ones(K, nz, ny, nx))
    assert torch.equal(rows.long(), want_r) and torch.equal(cols.long(),
                                                            want_c)
    with pytest.raises(ValueError):
        stencil27.generate(nx * ny * nz + 1, params, torch.Generator())


def test_generator_watches_host_memory_only_on_the_card():
    """On the CPU ``generate`` starts no watchdog; the watchdog itself, in
    a child process, ends a run that passes its budget with exit code 1
    and a message, and leaves one under it be."""
    import subprocess
    import sys
    import threading
    from bench.gen import stencil27
    stencil27.generate(27, {"nx": 3, "ny": 3, "nz": 3}, torch.Generator())
    assert not stencil27._watching.is_set()
    assert "bench-host-memory" not in {t.name for t in threading.enumerate()}
    script = (
        "import sys, time, numpy as np\n"
        "from bench.gen import stencil27\n"
        "assert stencil27.watch_host_memory(0.125, 0.01) > 0\n"
        "assert stencil27.watch_host_memory(8) == 0\n"
        "a = np.ones(2**25, np.uint8)\n"
        "time.sleep(0.2)\n"
        "print('under', flush=True)\n"
        "if sys.argv[1] == 'over':\n"
        "    b = np.ones(2**28, np.uint8)\n"
        "    time.sleep(5)\n"
        "print('done', flush=True)\n")
    for case, rc, said in (("under", 0, "under\ndone"), ("over", 1, "under")):
        out = subprocess.run([sys.executable, "-c", script, case], cwd=ROOT,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == rc, out.stderr[-2000:]
        assert out.stdout.strip() == said
        assert ("over its budget" in out.stderr) == (case == "over")


def test_least_roofline_count():
    from bench import roofline, roofline_least
    n, nnz = 104**3, 310**3
    assert roofline_least.request_bytes(n, nnz, 64) == 695_094_368
    assert roofline_least.request_bound_s(n, nnz, 64) == pytest.approx(
        695_094_368 / 3.35e12)
    assert roofline_least.request_bound_s(n, nnz, 64) * 1e3 == \
        pytest.approx(0.2075, abs=5e-5)
    # Below the fixed count's CSR charge, by A's indices and row pointers.
    assert roofline.request_bytes(n, nnz, 64) - \
        roofline_least.request_bytes(n, nnz, 64) == 4 * nnz + 4 * (n + 1)
    # Operations bound a request with few columns and many values.
    assert roofline_least.request_bound_s(10, 10**6, 2**14) == \
        pytest.approx(2 * 10**6 * 2**14 / 67e12)


def test_least_readers_on_a_record():
    from bench import roofline_least
    from bench.record import RunRecord, Served, TraceReading
    n, nnz, d = 104**3, 310**3, 64
    bound = roofline_least.request_bound_s(n, nnz, d)
    served = Served(requests=1000, window_s=2.0, host_s=[], latency_s=None,
                    t_first=0.0)
    traced = TraceReading(window_s=0.2, busy_s=0.19, requests=256,
                          port_kernel_s=256 * 4 * bound, port_launches=256,
                          device_ops=[], idle_gaps=[])
    rec = RunRecord(cell="c", n=n, nnz=nnz, d=d, bound_s=1.0, flops=1,
                    setup_s=1.0, served=served, trace=traced)
    assert _bench("kernel_roofline.least")(rec) == pytest.approx(25.0)
    assert _bench("spmm_mfu.least")(rec) == pytest.approx(
        100.0 * 1000 * bound / 2.0)
    assert _bench("kernel_roofline.least")(
        RunRecord(**{**rec.__dict__, "trace": None})) is None
    assert _bench("spmm_mfu.least")(RunRecord(**{
        **rec.__dict__, "served": Served(0, 1.0, [], None, 0.0)})) is None


def _span(name, start, end, sid, parent=None):
    return trace.Span(name, start, end, sid, parent, sid)


def test_pack_diagonals_reader_sums_its_spans_under_the_latest_pack():
    read = _bench("pack_diagonals_s")
    spans = [_span("spmm.plan", 0, 10, 1), _span("spmm.pack", 10, 100, 2),
             _span("spmm.pack.convert", 12, 90, 3, 2),
             _span("spmm.pack.diagonals", 15, 55, 4, 3),
             _span("spmm.pack.copy", 60, 80, 5, 3),
             # An earlier run's span is not read; one with no root neither.
             _span("spmm.pack.diagonals", 200, 900, 6)]
    assert read(None, spans=spans) == pytest.approx(40e-9)
    assert read(None, spans=spans[:3] + spans[4:5]) is None   # no DIA pack
    assert read(None, spans=spans[1:]) is None                # no plan root
    earlier = [_span("spmm.plan", 0, 1, 7), _span("spmm.pack", 1, 2, 8),
               _span("spmm.pack.diagonals", 1, 2, 9, 8)]
    later = [_span(s.name, s.start_ns + 10, s.end_ns + 10, s.span_id + 10,
                   None if s.parent_id is None else s.parent_id + 10)
             for s in spans]
    assert read(None, spans=earlier + later) == pytest.approx(40e-9)


@pytest.mark.parametrize("grid", GRIDS, ids=GRID_IDS)
def test_stencil_check_recovers_the_coefficients(grid):
    """``bench/stencil27_check.py`` rebuilds ``coef`` from the operator's
    COO, and holds an answer to the reference: 0 for the reference's own,
    the planted error's size for one entry off by 1e-3 of its row's
    ``|A| @ |B|``."""
    from bench import stencil27_check
    nx, ny, nz = grid
    coef = ref.random_coefficients(nx, ny, nz, 3)
    rows, cols, vals = ref.coo(coef)
    got = stencil27_check.coefficients(rows, cols, vals, grid)
    assert torch.equal(got, coef * torch.stack(
        [ref.inside(nx, ny, nz, s) for s in range(K)]))
    b = torch.randn(nx * ny * nz, 3, generator=torch.Generator()
                    .manual_seed(4), dtype=torch.float64)
    c = ref.apply(coef, b)
    assert stencil27_check.stencil_rel_err(got, b, c, slab=2) == 0.0
    mag = ref.apply(coef, b.abs())
    c[7, 1] += 1e-3 * mag[7, 1]
    assert stencil27_check.stencil_rel_err(got, b, c, slab=3) == \
        pytest.approx(1e-3)


def _small_stencil_root(tmp_path) -> pathlib.Path:
    """A checkout copy with ``hpcg-small`` (16^3) and its stream cell,
    reporting what ``hpcg.stream-d64`` reports."""
    src = importlib.util.spec_from_file_location(
        "bench_test_cells", ROOT / "bench" / "tests" / "conftest.py")
    cells = importlib.util.module_from_spec(src)
    src.loader.exec_module(cells)
    root = cells.copy_checkout(tmp_path)
    cfg = json.loads((root / "bench" / "configs" / "hpcg-104.json")
                     .read_text())
    cfg = dict(cfg, name="hpcg-small", n=16**3,
               params={"nx": 16, "ny": 16, "nz": 16})
    (root / "bench" / "configs" / "hpcg-small.json").write_text(
        json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "hpcg-small", "source": "test",
                             "reduced": ["n"], "why": "CPU test",
                             "file": "bench/configs/hpcg-small.json"})
    bench["workloads"].append({"name": "hpcg-small.stream-d64",
                               "config": "hpcg-small",
                               "traffic": "stream-d64", "chips": 1,
                               "why": "CPU test"})
    for metric in bench["per_layer"] + bench["end_to_end"]:
        if "hpcg.stream-d64" in metric.get("workloads", ()):
            metric["workloads"].append("hpcg-small.stream-d64")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.mark.parametrize("traced", [False, True])
def test_the_stencil_cell_reports_its_metrics(tmp_path, traced):
    """``hpcg.stream-d64``'s metrics on a 16^3 copy of the cell through
    ``bench/run.py::run_cell`` on the CPU: the plan packs DIA, the pack's
    diagonals span is read, the device's share is absent (no device in
    the trace), and ``bench/stencil27_check.py`` holds the sampled answers
    to the stencil reference too."""
    from bench import run, spec
    root = _small_stencil_root(tmp_path)
    cell = spec.load_cell(root, "hpcg-small.stream-d64")
    names = {m["name"] for m in (cell.per_layer if traced
                                 else cell.end_to_end)}
    if traced:
        assert {"kernel_roofline.least", "spmm_mfu.least",
                "pack_diagonals_s"} <= names
        assert not {"kernel_roofline", "spmm_mfu"} & names
    else:
        assert names == {"gflops", "setup_s"}
    from bench import stencil27_check
    t0 = time.perf_counter_ns()
    with stencil27_check.stencil_checked((16, 16, 16), []) as errs:
        res = run.run_cell(root, cell, seed=2**31 + 33, seconds=0.3,
                           trace=traced, device=torch.device("cpu"),
                           t0=time.perf_counter(), log=lambda s: None)
    assert res["correct"] is True
    # The sampled answers, also against the stencil reference.
    assert len(errs) == cell.traffic["sample"]
    assert max(errs) <= res["checks"]["max_rel_err"]["limit"]
    got = res["metrics"]
    assert set(got) == names - {"kernel_roofline.least"}
    for name in got:
        assert got[name]["value"] >= 0.0
    new = _spans_since(t0)
    (pack,) = [s for s in new if s.name == "spmm.pack"]
    assert pack.attrs["format"] == "dia"
    if traced:
        diag = [s for s in new if s.name == "spmm.pack.diagonals"]
        assert got["pack_diagonals_s"]["value"] == pytest.approx(
            sum(s.duration_ns for s in diag) / 1e9)
        assert got["pack_diagonals_s"]["value"] > 0.0
        assert 0.0 < got["spmm_mfu.least"]["value"]
    else:
        assert got["gflops"]["value"] > 0.0
