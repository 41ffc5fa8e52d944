"""The port's serving path end to end on the CPU, against the reference.

``repro_torch.sparse.plan(...).execute`` and the server's
``serve_spmm_stream`` run on ``device="cpu"`` over the serving suite, and
each result is held against the reference ``StreamPlan`` on the same B:
the same chosen format and precision, and C within the sum of both sides'
bounds (``4 * eps * (|A| @ |B|) + ATOL + RTOL * |C|`` each, as in
``tests/test_differential.py``).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from repro import sparse as ref_sparse
from repro.core import hardware as ref_hw
from repro.core import patterns as ref_patterns
from repro.sparse import formats as ref_fmt
from repro.sparse.dispatch import Dispatcher as RefDispatcher

from repro_torch import interop, kernels
from repro_torch import sparse as port_sparse
from repro_torch.core import hardware as port_hw
from repro_torch.launch import serve as port_serve
from repro_torch.sparse.dispatch import Dispatcher

RTOL = ATOL = 5e-4
N = 256
D = 8
STRUCTURES = sorted(ref_patterns.serving_suite(N))
PAIRS = [("torch", "jax"), ("cuda", "pallas")]


def _bridge(m):
    return interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                  m.meta)


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


def _plans(m, port_backend, ref_backend, strategy="auto", **kw):
    ref = ref_sparse.plan(
        m, ref_sparse.BSpec(d=D, reuse=8, **kw), strategy=strategy,
        dispatcher=RefDispatcher(ref_hw.HOST_CPU, backend=ref_backend,
                                 calibration=False, tree=False))
    port = port_sparse.plan(
        _bridge(m), port_sparse.BSpec(d=D, reuse=8, **kw), strategy=strategy,
        dispatcher=Dispatcher(port_hw.HOST_CPU, backend=port_backend,
                              device="cpu", calibration=False, tree=False))
    return ref, port


@pytest.mark.parametrize("port_backend,ref_backend", PAIRS)
@pytest.mark.parametrize("structure", STRUCTURES)
def test_stream_plan_execute_matches_reference(structure, port_backend,
                                               ref_backend):
    m = ref_patterns.serving_suite(N)[structure]()
    ref, port = _plans(m, port_backend, ref_backend)
    assert port.chosen == ref.chosen
    assert port.precision == ref.precision
    assert port.device.type == "cpu"
    rng = np.random.default_rng(3)
    for _ in range(2):
        b = rng.normal(size=(N, D)).astype(np.float32)
        c = port.execute(torch.from_numpy(b))
        assert isinstance(c, torch.Tensor) and c.device.type == "cpu"
        _assert_within(m, b, c.numpy(), np.asarray(ref.execute(
            jnp.asarray(b))), 2.0 ** -23, f"{structure}/{port_backend}")
    assert port.stats()["executed"] == 2
    assert port.stats()["backend"] == port_backend


@pytest.mark.parametrize("strategy", ["auto", "rowsplit"])
@pytest.mark.parametrize("structure", ["scale-free", "uniform"])
def test_bf16_stream_plan_matches_reference(structure, strategy):
    m = ref_patterns.serving_suite(N)[structure]()
    ref, port = _plans(m, "cuda", "pallas", precision="bf16i32",
                       strategy=strategy)
    assert (port.chosen, port.precision) == (ref.chosen, ref.precision)
    b = np.random.default_rng(4).normal(size=(N, D)).astype(np.float32)
    c = port.execute(torch.from_numpy(b))
    assert c.dtype == torch.bfloat16
    _assert_within(m, b, c.float().numpy(),
                   np.asarray(ref.execute(jnp.asarray(b)), np.float32),
                   2.0 ** -8, structure)


@pytest.mark.parametrize("structure", STRUCTURES)
def test_serve_spmm_stream_on_cpu_matches_reference(structure, capsys):
    args = port_serve.parser().parse_args(
        ["--spmm-stream", "--spmm-structure", structure, "--spmm-n",
         str(N), "--spmm-d", str(D), "--spmm-steps", "3", "--device",
         "cpu"])
    before = kernels.launch_counts()
    rec = port_serve.serve_spmm_stream(args)
    assert kernels.launch_counts() == before       # no card, no launch
    out = capsys.readouterr().out
    assert "steady-state" in out and rec["plan"].chosen in out
    assert len(rec["latency_us"]) == 3 and rec["p99_us"] >= rec["p50_us"]
    assert rec["gflops"] > 0 and rec["startup_ms"] > 0
    assert rec["plan"].stats()["executed"] == 3
    b, c = rec["last"]
    m = ref_patterns.serving_suite(N)[structure]()
    # The server draws its batches from default_rng(1): one warm-up and
    # three served requests; the last one is b.
    rng = np.random.default_rng(1)
    for _ in range(4):
        expect_b = rng.normal(size=(N, D)).astype(np.float32)
    np.testing.assert_array_equal(b.numpy(), expect_b)
    ref = ref_sparse.plan(m, ref_sparse.BSpec(d=D, reuse=3))
    _assert_within(m, expect_b, c.numpy(),
                   np.asarray(ref.execute(jnp.asarray(expect_b))),
                   2.0 ** -23, structure)


@pytest.mark.parametrize("strategy", ["binned", "rowsplit"])
def test_serve_cli_forced_strategy_on_cpu(capsys, strategy):
    port_serve.main(["--spmm-stream", "--spmm-structure", "scale-free",
                     "--spmm-n", "128", "--spmm-d", "4", "--spmm-steps",
                     "2", "--spmm-strategy", strategy, "--spmm-compare",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"-> {strategy}" in out and "per-call dispatch" in out
    with pytest.raises(SystemExit):
        port_serve.main(["--device", "cpu"])     # only --spmm-stream


def test_stream_plan_api_on_cpu():
    m = _bridge(ref_patterns.serving_suite(N)["banded"]())
    disp = Dispatcher(device="cpu", calibration=False, tree=False)
    plan = port_sparse.plan(m, port_sparse.BSpec(d=D, reuse=2),
                            dispatcher=disp)
    rng = np.random.default_rng(0)
    bs = torch.from_numpy(rng.normal(size=(3, N, D)).astype(np.float32))
    many = plan.execute_many(bs)
    assert many.shape == (3, N, D)
    for i in range(3):
        assert torch.equal(many[i], plan.execute(bs[i]))
    assert plan.execute_many([]).shape == (0, N, D)
    wide = torch.from_numpy(rng.normal(size=(N, 3 * D)).astype(np.float32))
    got = plan.execute_wide(wide)
    for k in range(3):
        assert torch.equal(got[:, k * D:(k + 1) * D],
                           plan.execute(wide[:, k * D:(k + 1) * D]
                                        .contiguous()))
    assert plan.maybe_replan() is not None       # executed >> reuse=2
    assert plan.replan(64).spec.reuse == 64
    assert plan.exec_hints() == {"async_dispatch": True, "donate_b": False}
    assert plan.coalesce_block_d(3 * D) == 4 * D
    plan.reset_stats()
    assert plan.stats()["executed"] == 0
    with pytest.raises(ValueError, match="width"):
        plan.execute(wide)
    with pytest.raises(ValueError, match="shape"):
        plan.execute(torch.zeros(N + 1, D))
    with pytest.raises(ValueError, match="operand is on"):
        plan.execute(torch.zeros(N, D, device="meta"))
    with pytest.raises(NotImplementedError, match="sharded"):
        port_sparse.plan(m, D, mesh=object(), dispatcher=disp)
    cuda_plan = port_sparse.plan(
        m, D, dispatcher=Dispatcher(backend="cuda", device="cpu",
                                    calibration=False, tree=False))
    assert cuda_plan.coalesce_block_d(3 * D) == D
    assert port_sparse.as_b_spec(bs[0]).d == D
    assert port_sparse.as_b_spec(16, reuse=4) == port_sparse.BSpec(16, 4)
    with pytest.raises(ValueError):
        port_sparse.BSpec(d=0)


def test_sparse_package_keeps_spmm_submodule():
    """``repro_torch.sparse.spmm`` is the submodule, not a function that
    hides it."""
    import types
    assert isinstance(port_sparse.spmm, types.ModuleType)
    assert callable(port_sparse.dispatch.spmm)
    assert set(port_sparse.spmm.IMPLEMENTATIONS) == {
        "csr", "ell", "bcsr", "dia", "binned", "rowsplit", "ell_coo"}
