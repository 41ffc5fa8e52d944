"""The port's sharded tier against the reference's, on the CPU.

The same matrices (the reference's ``tests/test_shard.py`` structures at
n = 256) go to both packages.  A ``ShardedPlan`` of the port must score the
B-distribution strategies exactly as the reference does: the same
partitions, per-shard nonzeros, eligibility, skip reasons and chosen
strategy, and every ``ShardRoofline`` number within a relative 1e-9.  Its
C must agree with the reference's within ``4 * eps * (|A| @ |B|) + ATOL +
RTOL * |C|`` per side.

At D = 1 the reference runs in this process on ``make_shard_mesh(1)``.
At D = 4 it runs once per module in a subprocess with four virtual host
devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``), which
writes its plans and outputs under ``tmp_path``; the port runs on
``ShardMesh(["cpu"] * 4)``.  Also: ``collective_time``, ``ShardRoofline``
and ``shard_traffic`` against the reference, the mesh constructors, and
the sharded plan through the streaming interfaces.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sparse as ref_sparse
from repro.core import hardware as ref_hw
from repro.core import patterns as ref_patterns
from repro.core import roofline as ref_roofline
from repro.core import sparsity_models as ref_sm
from repro.launch.mesh import make_shard_mesh as ref_make_shard_mesh
from repro.sparse import formats as ref_fmt
from repro.sparse.dispatch import Dispatcher as RefDispatcher

from repro_torch import interop
from repro_torch import sparse as port_sparse
from repro_torch.core import hardware as port_hw
from repro_torch.core import roofline as port_roofline
from repro_torch.core import sparsity_models as port_sm
from repro_torch.launch.mesh import SHARD_AXIS, ShardMesh, make_shard_mesh
from repro_torch.sparse.dispatch import Dispatcher

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = ATOL = 5e-4
N, D_COL = 256, 16
REL = 1e-9

#: (port spec, the same fields as a reference spec).
HARDWARE = {
    "host-cpu": (port_hw.HOST_CPU, ref_hw.HOST_CPU),
    "h100": (port_hw.H100,
             ref_hw.HardwareSpec(**dataclasses.asdict(port_hw.H100))),
}
PAIRS = {"torch": "jax", "cuda": "pallas"}
STRUCTURES = ("banded", "blocked", "random", "scale_free")
B_CHOICES = ("auto",) + port_sparse.B_STRATEGIES


def _mats():
    return {
        "banded": ref_patterns.banded(N, bandwidth=4, seed=1),
        "blocked": ref_patterns.block_diagonal(N, t=64, seed=2),
        "random": ref_patterns.erdos_renyi(N, avg_degree=8, seed=3),
        "scale_free": ref_patterns.scale_free(N, avg_degree=6, seed=4),
    }


def _b() -> np.ndarray:
    return np.random.default_rng(0).standard_normal(
        (N, D_COL)).astype(np.float32)


def _case_id(case) -> str:
    return "-".join(str(x) for x in case)


def _cases(hw_names):
    """(port backend, hw, structure, format, b_strategy, precision)."""
    out = []
    for hw in hw_names:
        for backend in PAIRS:
            for name in STRUCTURES:
                for bs in (B_CHOICES if hw == "host-cpu" else ("auto",)):
                    out.append((backend, hw, name, "auto", bs, "-"))
    for backend in PAIRS:
        for fmt_name in ("binned", "rowsplit", "ell_coo"):
            for bs in port_sparse.B_STRATEGIES:
                out.append((backend, "host-cpu", "scale_free", fmt_name, bs,
                            "-"))
    for name in ("random", "scale_free"):
        for bs in port_sparse.B_STRATEGIES:
            out.append(("cuda", "host-cpu", name, "auto", bs, "bf16i16"))
    return out


CASES_D1 = [c for c in _cases(("host-cpu",)) if c[5] == "-"
            and c[3] == "auto"]
CASES_D4 = _cases(("host-cpu", "h100"))


def _bridge(m):
    return interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                  m.meta)


def _port_plan(case, mesh):
    backend, hw, name, fmt_name, bs, prec = case
    disp = Dispatcher(HARDWARE[hw][0], backend=backend, device="cpu",
                      calibration=False, tree=False)
    return port_sparse.plan(
        _bridge(_mats()[name]), port_sparse.BSpec(d=D_COL), mesh=mesh,
        strategy=fmt_name, b_strategy=bs, dispatcher=disp,
        precision=None if prec == "-" else prec)


def _ref_plan(case, mesh):
    backend, hw, name, fmt_name, bs, prec = case
    disp = RefDispatcher(HARDWARE[hw][1], backend=PAIRS[backend],
                         calibration=False, tree=False)
    return ref_sparse.plan(
        _mats()[name], ref_sparse.BSpec(d=D_COL), mesh=mesh,
        strategy=fmt_name, b_strategy=bs, dispatcher=disp,
        precision=None if prec == "-" else prec)


_ROOF_FIELDS = ("shard_ai", "critical_flops", "total_flops", "compute_s",
                "collective_s", "collective_bytes")


def _record(p) -> dict:
    """A ShardedPlan's decision record, as plain JSON values."""
    evals = []
    for e in p.strategy_evals:
        roof = None
        if e.roofline is not None:
            roof = {"strategy": e.roofline.strategy,
                    "devices": e.roofline.devices,
                    **{f: float(getattr(e.roofline, f))
                       for f in _ROOF_FIELDS}}
        evals.append({"strategy": e.strategy, "partition": e.partition,
                      "eligible": bool(e.eligible),
                      "skip_reason": e.skip_reason, "roofline": roof})
    return {"chosen": p.chosen, "precision": p.precision,
            "num_shards": int(p.num_shards), "b_strategy": p.b_strategy,
            "partition": p.partition,
            "shard_bounds": [int(x) for x in p.shard_bounds],
            "shard_nnz": [int(x) for x in p.shard_nnz],
            "shard_precision": p.stats()["shard_precision"],
            "evals": evals}


def _assert_same_record(port: dict, ref: dict, what: str) -> None:
    for k in ("chosen", "precision", "num_shards", "b_strategy",
              "partition", "shard_bounds", "shard_nnz", "shard_precision"):
        assert port[k] == ref[k], f"{what}: {k} {port[k]} vs {ref[k]}"
    assert len(port["evals"]) == len(ref["evals"])
    for pe, re_ in zip(port["evals"], ref["evals"]):
        for k in ("strategy", "partition", "eligible", "skip_reason"):
            assert pe[k] == re_[k], f"{what}: eval {k}"
        assert (pe["roofline"] is None) == (re_["roofline"] is None)
        if pe["roofline"] is None:
            continue
        for k, rv in re_["roofline"].items():
            pv = pe["roofline"][k]
            if isinstance(rv, float):
                assert pv == pytest.approx(rv, rel=REL, abs=0.0), (
                    f"{what}: {pe['strategy']} {k} {pv!r} vs {rv!r}")
            else:
                assert pv == rv, f"{what}: {pe['strategy']} {k}"


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


def _eps(case) -> float:
    return 2.0 ** -8 if case[5].startswith("bf16") else 2.0 ** -23


def _port_out(p, b: np.ndarray) -> np.ndarray:
    return p.execute(torch.from_numpy(b)).to(torch.float32).numpy()


# ---------------------------------------------------------------------- #
# The communication-aware roofline pieces.
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("hw", sorted(HARDWARE))
def test_collective_time_equals_reference(hw):
    port_spec, ref_spec = HARDWARE[hw]
    assert port_spec.collective_bandwidth == ref_spec.collective_bandwidth
    for nbytes in (0.0, 1.0, 8e6, 3.5e9):
        for devices in (1, 2, 3, 4, 8, 64):
            for coll in (1, 2, 3):
                assert port_roofline.collective_time(
                    nbytes, port_spec, devices, collectives=coll) == \
                    ref_roofline.collective_time(
                        nbytes, ref_spec, devices, collectives=coll)
    assert port_roofline.collective_time(1e9, port_spec, 1) == 0.0


def test_h100_collectives_use_nvlink_rate():
    """The H100 spec's interconnect fields feed the collective term."""
    h = port_hw.H100
    assert h.collective_bandwidth == h.ici_bytes_per_s == 450e9
    t = port_roofline.collective_time(450e6, h, 4, collectives=2)
    assert t == pytest.approx(1e-3 + 2 * h.collective_latency_s * 2)


@pytest.mark.parametrize("compute_s,collective_s", [
    (1e-3, 1e-4), (1e-4, 1e-3), (0.0, 0.0), (2e-6, 2e-6)])
def test_shard_roofline_equals_reference(compute_s, collective_s):
    kw = dict(strategy="replicate", devices=8, shard_ai=1.5,
              critical_flops=1e6, total_flops=8e6, compute_s=compute_s,
              collective_s=collective_s, collective_bytes=1e6)
    port = port_roofline.ShardRoofline(**kw)
    ref = ref_roofline.ShardRoofline(**kw)
    assert port.total_s == ref.total_s
    assert port.predicted_flops_per_s == ref.predicted_flops_per_s
    assert port.dominant == ref.dominant


@pytest.mark.parametrize("bytes_b", [None, 200.0])
@pytest.mark.parametrize("frac", [(0.25, 0.5), (1.0, 1.0), (0.0, 0.1)])
def test_shard_traffic_equals_reference(frac, bytes_b):
    kw = dict(flops=1000.0, bytes_a=400.0, bytes_b=200.0, bytes_c=100.0,
              model="random")
    port = port_sm.shard_traffic(port_sm.TrafficBreakdown(**kw),
                                 nnz_fraction=frac[0],
                                 rows_fraction=frac[1], bytes_b=bytes_b)
    ref = ref_sm.shard_traffic(ref_sm.TrafficBreakdown(**kw),
                               nnz_fraction=frac[0], rows_fraction=frac[1],
                               bytes_b=bytes_b)
    for f in ("flops", "bytes_a", "bytes_b", "bytes_c", "model", "ai"):
        assert getattr(port, f) == getattr(ref, f), f


# ---------------------------------------------------------------------- #
# Meshes.
# ---------------------------------------------------------------------- #

def test_shard_mesh_may_repeat_a_device():
    mesh = ShardMesh(["cpu"] * 4)
    assert mesh.size == 4 and mesh.axis_name == SHARD_AXIS == "shard"
    assert mesh.devices == (torch.device("cpu"),) * 4
    assert ShardMesh([torch.device("cpu")]) == ShardMesh(["cpu"])
    with pytest.raises(dataclasses.FrozenInstanceError):
        mesh.devices = ()
    with pytest.raises(ValueError, match="at least one"):
        ShardMesh([])


def test_make_shard_mesh_takes_distinct_devices():
    assert make_shard_mesh(device="cpu") == ShardMesh(["cpu"])
    assert make_shard_mesh(1, device="cpu").size == 1
    with pytest.raises(ValueError, match="only 1 cpu"):
        make_shard_mesh(4, device="cpu")
    with pytest.raises(ValueError, match=">= 1"):
        make_shard_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device=\"cpu\""):
            make_shard_mesh()


# ---------------------------------------------------------------------- #
# D = 1: the reference in this process.
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def ref_mesh_1():
    return ref_make_shard_mesh(1)


@pytest.mark.parametrize("case", CASES_D1, ids=_case_id)
def test_sharded_plan_equals_reference_on_one_device(case, ref_mesh_1):
    try:
        ref = _ref_plan(case, ref_mesh_1)
    except ValueError as e:
        assert "ineligible" in str(e)
        with pytest.raises(ValueError, match="ineligible"):
            _port_plan(case, ShardMesh(["cpu"]))
        return
    port = _port_plan(case, ShardMesh(["cpu"]))
    _assert_same_record(_record(port), _record(ref), _case_id(case))
    b = _b()
    _assert_within(_mats()[case[2]], b, _port_out(port, b),
                   np.asarray(ref.execute(jnp.asarray(b)), np.float32),
                   _eps(case), _case_id(case))
    ref_lines = ref.summary().splitlines()
    port_lines = port.summary().splitlines()
    k = len(ref.dispatch.summary().splitlines())
    assert port_lines[k:] == ref_lines[k:]


# ---------------------------------------------------------------------- #
# D = 4: the reference once, in a subprocess with four host devices.
# ---------------------------------------------------------------------- #

_REF_SCRIPT = r"""
import json, sys
import numpy as np, jax.numpy as jnp
sys.path.insert(0, "tests")
import test_torch_shard as T
from repro.launch.mesh import make_shard_mesh

out_dir = sys.argv[1]
mesh = make_shard_mesh(4)
b = jnp.asarray(T._b())
records, outs = {}, {}
for case in T.CASES_D4:
    key = T._case_id(case)
    try:
        p = T._ref_plan(case, mesh)
    except ValueError as e:
        records[key] = {"error": str(e)}
        continue
    records[key] = T._record(p)
    outs[key] = np.asarray(p.execute(b), np.float32)
json.dump(records, open(out_dir + "/records.json", "w"))
np.savez(out_dir + "/outputs.npz", **outs)
print("REF-SHARD-4-OK", len(outs))
"""


@pytest.fixture(scope="module")
def ref_dump_4(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_shard_4")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "HOME": str(out),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(out)],
                       capture_output=True, text=True, timeout=300,
                       env=env, cwd=str(ROOT))
    seconds = time.perf_counter() - t0
    assert "REF-SHARD-4-OK" in r.stdout, r.stderr[-3000:]
    records = json.loads((out / "records.json").read_text())
    with np.load(out / "outputs.npz") as z:
        outputs = {k: z[k] for k in z.files}
    return records, outputs, seconds


def test_reference_subprocess_stays_well_inside_its_limit(ref_dump_4):
    assert ref_dump_4[2] < 120.0


def test_dia_all_gather_is_ineligible_in_both(ref_dump_4):
    records, _, _ = ref_dump_4
    case = ("torch", "host-cpu", "banded", "auto", "all_gather", "-")
    assert "ineligible" in records[_case_id(case)]["error"]
    with pytest.raises(ValueError, match="ineligible"):
        _port_plan(case, ShardMesh(["cpu"] * 4))


@pytest.mark.parametrize("case", CASES_D4, ids=_case_id)
def test_sharded_plan_equals_reference_on_four_devices(case, ref_dump_4):
    records, outputs, _ = ref_dump_4
    ref = records[_case_id(case)]
    if "error" in ref:
        with pytest.raises(ValueError, match="ineligible"):
            _port_plan(case, ShardMesh(["cpu"] * 4))
        return
    port = _port_plan(case, ShardMesh(["cpu"] * 4))
    assert port.num_shards == 4
    _assert_same_record(_record(port), ref, _case_id(case))
    assert sum(port.shard_nnz) == _mats()[case[2]].nnz
    b = _b()
    _assert_within(_mats()[case[2]], b, _port_out(port, b),
                   outputs[_case_id(case)], _eps(case), _case_id(case))


# ---------------------------------------------------------------------- #
# The plan's own surface.
# ---------------------------------------------------------------------- #

def _cpu_disp(**kw):
    return Dispatcher(port_hw.HOST_CPU, device="cpu", calibration=False,
                      tree=False, **kw)


def test_sharded_plan_errors():
    m = _bridge(_mats()["banded"])
    mesh = ShardMesh(["cpu"] * 2)
    with pytest.raises(ValueError, match="unknown b_strategy"):
        port_sparse.plan(m, D_COL, mesh=mesh, b_strategy="broadcast",
                         dispatcher=_cpu_disp())
    with pytest.raises(ValueError, match="ineligible"):
        port_sparse.plan(m, D_COL, mesh=mesh, b_strategy="all_gather",
                         dispatcher=_cpu_disp())
    with pytest.raises(ValueError, match="requires a mesh"):
        port_sparse.plan(m, D_COL, b_strategy="replicate",
                         dispatcher=_cpu_disp())


def test_sharded_plan_summary_stats_and_hints():
    p = port_sparse.plan(_bridge(_mats()["banded"]), D_COL,
                         mesh=ShardMesh(["cpu"] * 4), dispatcher=_cpu_disp())
    assert isinstance(p, port_sparse.ShardedPlan) and p.chosen == "dia"
    s = p.summary()
    assert "ShardedPlan(devices=4" in s and "SKIP:" in s
    for strat in port_sparse.B_STRATEGIES:
        assert strat in s
    st = p.stats()
    assert st["devices"] == 4 and st["b_strategy"] == p.b_strategy
    assert len(st["shard_nnz"]) == 4
    assert p.exec_hints() == {"async_dispatch": True, "donate_b": False,
                              "devices": 4}
    assert p.coalesce_block_d(5 * D_COL) == D_COL
    evals = {e.strategy: e for e in p.strategy_evals}
    assert evals["all_gather"].predicted_gflops is None
    assert isinstance(evals["replicate"], port_sparse.ShardStrategyEval)


def test_sharded_stream_interfaces():
    """execute_many / execute_wide / the async forms / replan compose with
    the sharded tier."""
    m = _mats()["random"]
    p = port_sparse.plan(_bridge(m), port_sparse.BSpec(d=D_COL, reuse=4),
                         mesh=ShardMesh(["cpu"] * 3), dispatcher=_cpu_disp())
    dense = np.asarray(ref_fmt.coo_to_dense(m), np.float64)
    rng = np.random.default_rng(5)
    bs = [rng.standard_normal((N, D_COL)).astype(np.float32)
          for _ in range(2)]
    many = p.execute_many([torch.from_numpy(b) for b in bs])
    asyncs = p.execute_many_async([torch.from_numpy(b) for b in bs])
    for i, b in enumerate(bs):
        _assert_within(m, b, many[i].numpy(), dense @ b, 2.0 ** -23, "many")
        assert torch.equal(asyncs[i], many[i])
    wide = rng.standard_normal((N, 3 * D_COL + 5)).astype(np.float32)
    _assert_within(m, wide, p.execute_wide(torch.from_numpy(wide)).numpy(),
                   dense @ wide, 2.0 ** -23, "wide")
    p2 = p.replan(128)
    assert isinstance(p2, port_sparse.ShardedPlan)
    assert p2.num_shards == 3 and p2.spec.reuse == 128
    assert torch.equal(p2.execute_async(torch.from_numpy(bs[0])), many[0])


def test_stream_plan_binds_through_the_hook():
    """``StreamPlan._bind`` builds the single-device executor; the sharded
    plan overrides it and holds one layout per shard instead."""
    m = _bridge(_mats()["blocked"])
    single = port_sparse.plan(m, D_COL, dispatcher=_cpu_disp())
    assert single.layout is not None
    sharded = port_sparse.plan(m, D_COL, mesh=ShardMesh(["cpu"] * 2),
                               dispatcher=_cpu_disp())
    assert len(sharded.shard_layouts) == 2
    b = torch.from_numpy(_b())
    assert torch.allclose(sharded.execute(b), single.execute(b), rtol=1e-5,
                          atol=1e-5)
