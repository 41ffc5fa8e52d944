"""The port's dispatcher against the reference's, plan for plan.

Both packages get the same matrix (bridged with ``repro_torch.interop``)
and the same ``HardwareSpec`` fields: the host CPU spec, and the port's
H100 spec rebuilt as a reference ``HardwareSpec``.  ``torch`` plans are held
to ``jax`` plans and ``cuda`` plans to ``pallas`` plans: the chosen format
and precision, and every candidate's eligibility, skip reason, arithmetic
intensity, predicted and amortized GFLOP/s, exactly.  Every format has a
``cuda`` kernel, so there is no exception.

Also: the entry points refuse to run without a GPU unless ``device="cpu"``,
and the calibration / dispatch-tree stores are keyed by the port's backends.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro.core import hardware as ref_hw
from repro.core import patterns as ref_patterns
from repro.data.corpus import vendored_entries
from repro.sparse.dispatch import Dispatcher as RefDispatcher

from repro_torch import interop
from repro_torch import sparse as port_sparse
from repro_torch.core import hardware as port_hw
from repro_torch.core import calibrate as port_cal
from repro_torch.core import device as port_device
from repro_torch.data.dtree import DispatchTreeStore
from repro_torch.kernels import registry as port_registry
from repro_torch.launch import serve as port_serve
from repro_torch.sparse.dispatch import Dispatcher

N = 256

#: (port spec, the same fields as a reference spec).
HARDWARE = {
    "host-cpu": (port_hw.HOST_CPU, ref_hw.HOST_CPU),
    "h100": (port_hw.H100,
             ref_hw.HardwareSpec(**dataclasses.asdict(port_hw.H100))),
}

#: (port backend, reference backend).
PAIRS = [("torch", "jax"), ("cuda", "pallas")]

#: (d, reuse, tolerance): fp32-only, single-shot, and bf16 allowed.
PLAN_ARGS = [(1, 32, 0.0), (8, 1, 0.0), (16, 32, 1e-2)]

CANDIDATE_FIELDS = ("format", "precision", "eligible", "skip_reason", "ai",
                    "useful_fraction", "predicted_gflops",
                    "amortized_gflops", "conversion_bytes",
                    "ceiling_source")


def _bridge(m):
    return interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                  m.meta)


MATRICES = ([(f"corpus:{e.group}/{e.name}", e.load())
             for e in vendored_entries()]
            + [(f"suite:{k}", g())
               for k, g in ref_patterns.serving_suite(N).items()])


def _row(c):
    return {f: getattr(c, f) for f in CANDIDATE_FIELDS}


def test_h100_spec_is_cuda_core_fp32_with_l2_budget():
    h = port_hw.H100
    assert h.peak_flops == 67e12 and h.hbm_bandwidth == 3.35e12
    assert h.vmem_bytes == 50 * 2 ** 20          # the L2, not shared memory
    assert port_hw.by_name("h100") is h
    assert port_hw.by_name("h100-pcie").hbm_bandwidth == 2.0e12
    # Same fields, same fingerprint in both packages.
    assert h.fingerprint() == HARDWARE["h100"][1].fingerprint()
    assert port_hw.HOST_CPU.fingerprint() == ref_hw.HOST_CPU.fingerprint()


@pytest.mark.parametrize("hw_name", sorted(HARDWARE))
@pytest.mark.parametrize("port_backend,ref_backend", PAIRS)
@pytest.mark.parametrize("name,m", MATRICES, ids=[n for n, _ in MATRICES])
def test_plan_equals_reference(name, m, port_backend, ref_backend, hw_name):
    port_spec, ref_spec = HARDWARE[hw_name]
    ref = RefDispatcher(ref_spec, backend=ref_backend, calibration=False,
                        tree=False)
    port = Dispatcher(port_spec, backend=port_backend, device="cpu",
                      calibration=False, tree=False)
    pm = _bridge(m)
    for d, reuse, tol in PLAN_ARGS:
        rp = ref.plan(m, d, reuse=reuse, tolerance=tol)
        pp = port.plan(pm, d, reuse=reuse, tolerance=tol)
        what = f"{name} d={d} reuse={reuse} tol={tol}"
        assert (pp.regime, pp.d, pp.reuse, pp.hardware) == \
            (rp.regime, rp.d, rp.reuse, rp.hardware), what
        assert pp.backend == port_backend
        ref_rows = [_row(c) for c in rp.candidates]
        port_rows = [_row(c) for c in pp.candidates]
        assert port_rows == ref_rows, what
        assert (pp.chosen, pp.precision) == (rp.chosen, rp.precision), what


@pytest.mark.parametrize("port_backend,ref_backend", PAIRS)
def test_forced_strategy_and_precision_equal_reference(port_backend,
                                                       ref_backend):
    m = ref_patterns.serving_suite(N)["scale-free"]()
    pm = _bridge(m)
    ref = RefDispatcher(ref_hw.HOST_CPU, backend=ref_backend,
                        calibration=False, tree=False)
    port = Dispatcher(port_hw.HOST_CPU, backend=port_backend, device="cpu",
                      calibration=False, tree=False)

    def outcome(disp, mm, strategy, precision):
        try:
            p = disp.plan(mm, 8, strategy=strategy, precision=precision)
        except ValueError as e:
            return "ValueError", str(e).replace(port_backend, ref_backend)
        return p.chosen, p.precision

    for strategy in ("csr", "binned", "rowsplit", "ell_coo", "bcsr", "dia"):
        for precision in (None, "bf16i32", "bf16"):
            assert outcome(port, pm, strategy, precision) == \
                outcome(ref, m, strategy, precision), (strategy, precision)


@pytest.mark.parametrize("hw_name", sorted(HARDWARE))
@pytest.mark.parametrize("structure", ["scale-free", "uniform"])
def test_forced_rowsplit_plan_on_cuda_equals_reference(structure, hw_name):
    port_spec, ref_spec = HARDWARE[hw_name]
    m = ref_patterns.serving_suite(N)[structure]()
    ref = RefDispatcher(ref_spec, backend="pallas", calibration=False,
                        tree=False)
    port = Dispatcher(port_spec, backend="cuda", device="cpu",
                      calibration=False, tree=False)
    for d, precision in ((16, None), (8, "bf16i16")):
        rp = ref.plan(m, d, strategy="rowsplit", precision=precision)
        pp = port.plan(_bridge(m), d, strategy="rowsplit",
                       precision=precision)
        assert (pp.chosen, pp.precision) == (rp.chosen, rp.precision)
        assert pp.chosen == "rowsplit"
        assert [_row(c) for c in pp.candidates] == \
            [_row(c) for c in rp.candidates]
        assert "rowsplit" not in pp.skips


def test_registry_mirrors_the_reference_formats():
    from repro.kernels import registry as ref_registry
    from repro.sparse.dispatch import FORMATS as REF_FORMATS
    assert set(port_registry.formats_for("cuda")) == \
        set(REF_FORMATS) | {"grouped"}
    assert set(port_registry.formats_for("torch")) == set(REF_FORMATS)
    assert port_registry.get("grouped", "cuda").operand == \
        ref_registry.get("grouped", "pallas").operand == "moe"
    for f in REF_FORMATS:
        assert port_registry.get(f, "cuda").operand == "coo"
    # The same roofline placement under the same hardware fields.
    for hw_name, (port_hw_spec, ref_hw_spec) in HARDWARE.items():
        for args, kw in (((4096, 4096, 1536, 128), {}),
                         ((41472, 4096, 1536, 128), {"itemsize": 4}),
                         ((1664, 64, 128, 8), {"itemsize": 4})):
            port_roof = port_registry.grouped_matmul_roofline(
                *args, hw=port_hw_spec, **kw)
            ref_roof = ref_registry.grouped_matmul_roofline(
                *args, hw=ref_hw_spec, **kw)
            assert dataclasses.asdict(port_roof) == \
                dataclasses.asdict(ref_roof), (hw_name, args)
    assert port_registry.grouped_matmul_roofline(8, 8, 8, 1).ai == \
        port_registry.grouped_matmul_roofline(8, 8, 8, 1,
                                              hw=port_hw.H100).ai


def test_auto_backend_follows_the_device():
    disp = Dispatcher(device="cpu", calibration=False, tree=False)
    m = _bridge(ref_patterns.banded(N, 3, seed=0))
    assert disp.plan(m, 8).backend == "torch"
    assert disp.plan(m, 8).hardware == port_hw.HOST_CPU.name


@pytest.mark.parametrize("fmt", ["csr", "ell", "bcsr", "dia", "binned",
                                 "rowsplit", "ell_coo", "grouped"])
def test_cuda_specs_declare_the_pallas_precisions(fmt):
    from repro.kernels import registry as ref_registry
    assert port_registry.get(fmt, "cuda").supported_precisions == \
        ref_registry.get(fmt, "pallas").supported_precisions
    if fmt != "grouped":    # the grouped matmul has no plain-backend spec
        assert port_registry.get(fmt, "torch").supported_precisions == \
            ref_registry.get(fmt, "jax").supported_precisions


def test_dispatcher_spmm_matches_dense_on_cpu():
    m = _bridge(ref_patterns.serving_suite(N)["moe-block"]())
    b = torch.from_numpy(np.random.default_rng(0).normal(
        size=(N, 16)).astype(np.float32))
    dense = port_sparse.coo_to_dense(m).double() @ b.double()
    for backend in ("torch", "cuda"):
        disp = Dispatcher(backend=backend, device="cpu", calibration=False,
                          tree=False)
        c = disp.spmm(m, b)
        assert torch.allclose(c.double(), dense, rtol=5e-4, atol=5e-4)


# ---------------------------------------------------------------------- #
# Entry points run on the card unless asked otherwise.
# ---------------------------------------------------------------------- #

@pytest.fixture
def no_gpu(monkeypatch):
    """Pretend there is no CUDA device (as on this kind of host)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_gpu(no_gpu):
    m = _bridge(ref_patterns.banded(64, 3, seed=0))
    for call in (lambda: Dispatcher(),
                 lambda: Dispatcher(device="cuda"),
                 lambda: port_sparse.plan(m, 8),
                 lambda: port_sparse.plan_spmm(m, 8),
                 lambda: port_sparse.dispatch.default_dispatcher(),
                 lambda: port_serve.main(["--spmm-stream", "--spmm-n", "64",
                                          "--spmm-steps", "1"])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()


def test_entry_points_run_on_cpu_when_asked(no_gpu):
    m = _bridge(ref_patterns.banded(64, 3, seed=0))
    assert port_device.resolve_device("cpu").type == "cpu"
    plan = port_sparse.plan(m, 8, device="cpu")
    assert plan.device.type == "cpu"
    assert Dispatcher(device="cpu").device.type == "cpu"


# ---------------------------------------------------------------------- #
# Calibration and dispatch-tree stores.
# ---------------------------------------------------------------------- #

def test_calibration_store_is_keyed_by_port_backend(tmp_path):
    store = port_cal.CalibrationStore(tmp_path)
    hw = port_hw.H100
    assert store.path_for(hw, "cuda").name == f"{hw.name}-cuda.json"
    assert store.path_for(hw, "torch") != store.path_for(hw, "cuda")
    assert store.load(hw, "cuda") is None
    assert store.staleness_note(hw, "cuda") is None
    cal = port_cal.Calibration(
        hardware=hw.name, fingerprint=hw.fingerprint(), backend="cuda",
        entries=(port_cal.FormatCalibration(
            format="csr", backend="cuda", peak_fraction=0.1, d_half=50.0,
            sustained_gflops=100.0, useful_fraction=1.0,
            measured={8: 50.0}),),
        registry_version=port_registry.REGISTRY_VERSION)
    store.save(cal)
    assert store.load(hw, "cuda") == cal
    assert store.load(hw, "torch") is None
    assert store.staleness_note(hw, "cuda") is None
    stale = dataclasses.replace(cal, registry_version=0)
    store.save(stale)
    assert f"predates kernel registry v{port_registry.REGISTRY_VERSION}" \
        in store.staleness_note(hw, "cuda")
    disp = Dispatcher(hw, backend="cuda", device="cpu", calibration=store,
                      tree=False)
    m = _bridge(ref_patterns.serving_suite(N)["uniform"]())
    plan = disp.plan(m, 8)
    assert plan.candidate("csr").ceiling_source == "calibrated"
    assert plan.calibration_note is not None


def test_calibration_dir_env_is_honoured(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_CALIBRATION_DIR", str(tmp_path))
    assert port_cal.CalibrationStore().root == tmp_path


def test_no_dispatch_tree_for_port_backends():
    store = DispatchTreeStore()
    assert store.load("torch") is None
    assert store.load("cuda") is None
