"""The port's calibration sweep and ``serve --calibrate`` against the
reference's.

``fit_ceiling`` and the calibration matrices must equal the reference's
exactly; the sweep runs end to end on the CPU (``backend="torch"``,
``device="cpu"``) into a temporary store; and one efficiency table given
to both dispatchers (the reference's ``pallas`` and the port's ``cuda``)
yields plans equal row for row.  No test here writes to the default
calibration root, which every test in the worker shares.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest

from repro.core import calibrate as ref_cal
from repro.core import hardware as ref_hw
from repro.core import patterns as ref_patterns
from repro.data.corpus import vendored_entries
from repro.sparse.dispatch import Dispatcher as RefDispatcher

from repro_torch import interop
from repro_torch.core import calibrate as port_cal
from repro_torch.core import hardware as port_hw
from repro_torch.kernels import registry as port_registry
from repro_torch.launch import serve as port_serve
from repro_torch.sparse.dispatch import FORMATS, Dispatcher, default_dispatcher

N = 256

#: (name, d values, GFLOP/s): saturating, flat, decreasing, one
#: non-positive point, noisy, and a single distinct width.
SWEEPS = [
    ("saturating", [2, 8, 32, 128, 512],
     [80.0 * d / (d + 24.0) for d in (2, 8, 32, 128, 512)]),
    ("flat", [4, 16, 64], [5.0, 5.0, 5.0]),
    ("decreasing", [4, 16, 64], [10.0, 6.0, 2.0]),
    ("non_positive", [4, 16], [0.0, 1.0]),
    ("negative", [4, 16, 64, 256], [1.0, -2.0, 3.0, 4.0]),
    ("noisy", [4, 16, 64, 256], [0.9, 3.1, 7.7, 9.2]),
    ("one_width", [8, 8, 8], [1.0, 2.0, 3.0]),
]


def _bridge(m):
    return interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                  m.meta)


@pytest.mark.parametrize("name,d,g", SWEEPS, ids=[s[0] for s in SWEEPS])
def test_fit_ceiling_equals_reference(name, d, g):
    assert port_cal.fit_ceiling(d, g) == ref_cal.fit_ceiling(d, g)


@pytest.mark.parametrize("d,g", [([4], [1.0]), ([4, 16], [1.0]), ([], [])])
def test_fit_ceiling_too_short_raises(d, g):
    with pytest.raises(ValueError):
        ref_cal.fit_ceiling(d, g)
    with pytest.raises(ValueError):
        port_cal.fit_ceiling(d, g)


def test_sweep_constants_equal_reference():
    assert port_cal.DEFAULT_D_VALUES == ref_cal.DEFAULT_D_VALUES
    assert port_cal.PEAK_FRACTION_RANGE == ref_cal.PEAK_FRACTION_RANGE
    assert port_cal.D_HALF_RANGE == ref_cal.D_HALF_RANGE


@pytest.mark.parametrize("scale,t", [(7, 32), (7, 64)])
def test_calibration_matrices_equal_reference(scale, t):
    port = port_cal._calibration_matrices(scale, t)
    ref = ref_cal._calibration_matrices(scale, t)
    assert list(port) == list(ref)
    for fmt in ref:
        p, r = port[fmt](), ref[fmt]()
        assert (p.n, p.pattern, p.meta) == (r.n, r.pattern, r.meta), fmt
        for field in ("rows", "cols", "vals"):
            a, b = getattr(p, field), getattr(r, field)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), \
                (fmt, field)


@pytest.fixture(scope="module")
def swept(tmp_path_factory):
    """One CPU sweep of the plain versions at n = 128 into a temp store."""
    root = tmp_path_factory.mktemp("port-cal")
    store = port_cal.CalibrationStore(root=root)
    cal = port_cal.calibrate(port_hw.HOST_CPU, backend="torch", device="cpu",
                             scale=7, repeats=1, store=store)
    return cal, store


def test_calibrate_end_to_end_on_cpu(swept):
    cal, store = swept
    hw = port_hw.HOST_CPU
    assert [e.format for e in cal.entries] == list(FORMATS)
    assert cal.backend == "torch" and cal.hardware == hw.name
    assert cal.registry_version == port_registry.REGISTRY_VERSION
    for e in cal.entries:
        assert (e.backend, e.precision) == ("torch", "f32i32")
        assert 1e-5 <= e.peak_fraction <= 1.0
        assert 0.0 <= e.d_half <= 4096.0
        assert set(e.measured) == set(port_cal.DEFAULT_D_VALUES)
        assert all(v > 0 for v in e.measured.values())
    payload = json.loads(store.path_for(hw, "torch").read_text())
    assert payload["fingerprint"] == hw.fingerprint()
    assert store.load(hw, "torch") == cal
    disp = Dispatcher(hw, backend="torch", device="cpu", calibration=store,
                      tree=False)
    for name, g in ref_patterns.serving_suite(N).items():
        plan = disp.plan(_bridge(g()), 16)
        assert set(plan.ceiling_sources.values()) == {"calibrated"}, name


def test_calibrate_rejects_unknown_format(tmp_path):
    with pytest.raises(ValueError, match="nope"):
        ref_cal.calibrate(ref_hw.HOST_CPU, formats=["nope"], scale=6)
    with pytest.raises(ValueError, match="nope"):
        port_cal.calibrate(port_hw.HOST_CPU, device="cpu", formats=["nope"],
                           scale=6)


def test_calibrate_defaults_to_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device=\"cpu\""):
        port_cal.calibrate(port_hw.HOST_CPU, scale=6)


def test_summary_equals_reference(swept):
    cal, _ = swept
    ref = ref_cal.Calibration(
        hardware=cal.hardware, fingerprint=cal.fingerprint,
        backend=cal.backend,
        entries=tuple(ref_cal.FormatCalibration(**dataclasses.asdict(e))
                      for e in cal.entries),
        registry_version=cal.registry_version)
    assert cal.summary() == ref.summary()
    assert cal.efficiency() == ref.efficiency()


MATRICES = ([(f"corpus:{e.group}/{e.name}", e.load())
             for e in vendored_entries()]
            + [(f"suite:{k}", g())
               for k, g in ref_patterns.serving_suite(N).items()])


@pytest.mark.parametrize("hw_name", ["host-cpu", "h100"])
@pytest.mark.parametrize("name,m", MATRICES, ids=[n for n, _ in MATRICES])
def test_plans_under_one_efficiency_table_equal_reference(swept, name, m,
                                                          hw_name):
    cal, _ = swept
    table = cal.efficiency()
    port_spec = {"host-cpu": port_hw.HOST_CPU, "h100": port_hw.H100}[hw_name]
    ref_spec = ref_hw.HardwareSpec(**dataclasses.asdict(port_spec))
    ref = RefDispatcher(ref_spec, backend="pallas", efficiency=table,
                        calibration=False, tree=False)
    port = Dispatcher(port_spec, backend="cuda", device="cpu",
                      efficiency=table, calibration=False, tree=False)
    pm = _bridge(m)
    fields = ("format", "precision", "eligible", "skip_reason", "ai",
              "useful_fraction", "predicted_gflops", "amortized_gflops",
              "conversion_bytes", "ceiling_source")
    for d, reuse in ((1, 32), (16, 8), (64, 1)):
        rp, pp = ref.plan(m, d, reuse=reuse), port.plan(pm, d, reuse=reuse)
        assert [{f: getattr(c, f) for f in fields} for c in pp.candidates] \
            == [{f: getattr(c, f) for f in fields} for c in rp.candidates], \
            f"{name} d={d}"
        assert (pp.chosen, pp.precision) == (rp.chosen, rp.precision)
        assert pp.candidate(pp.chosen).ceiling_source == "override"


def test_staleness_notes_name_the_refit_command(tmp_path):
    hw = port_hw.HOST_CPU
    store = port_cal.CalibrationStore(root=tmp_path)
    cal = port_cal.Calibration(
        hardware=hw.name, fingerprint=hw.fingerprint(), backend="cuda",
        entries=(), registry_version=port_registry.REGISTRY_VERSION - 1)
    path = store.save(cal)
    refit = "python -m repro_torch.launch.serve --spmm-stream --calibrate"
    assert refit in store.staleness_note(hw, "cuda")
    store.save(dataclasses.replace(cal, fingerprint="other"))
    assert refit in store.staleness_note(hw, "cuda")
    path.write_text("{not json")
    assert refit in store.staleness_note(hw, "cuda")


@pytest.fixture
def calibration_dir(tmp_path, monkeypatch):
    """A private calibration root; the CPU default dispatcher forgets
    what it read from it afterwards."""
    monkeypatch.setenv("REPRO_CALIBRATION_DIR", str(tmp_path))
    yield tmp_path
    default_dispatcher("cpu").refresh_calibration()


def test_serve_calibrate_writes_the_file_and_plans_calibrated(
        calibration_dir, capsys):
    port_serve.main(["--spmm-stream", "--calibrate", "--device", "cpu",
                     "--spmm-structure", "banded", "--spmm-n", str(N),
                     "--spmm-d", "8", "--spmm-steps", "2"])
    out = capsys.readouterr().out
    hw = port_hw.HOST_CPU
    path = calibration_dir / f"{hw.name}-torch.json"
    assert path.is_file() and f"-> {path}" in out
    cal = port_cal.CalibrationStore().load(hw, "torch")
    assert cal is not None and [e.format for e in cal.entries] == \
        list(FORMATS)
    assert cal.summary() in out
    # The served plan's table reads calibrated ceilings, and so does the
    # refreshed default dispatcher.
    assert "[calibrated]" in out and "[default]" not in out
    plan = default_dispatcher("cpu").plan(
        _bridge(ref_patterns.serving_suite(N)["banded"]()), 8)
    assert set(plan.ceiling_sources.values()) == {"calibrated"}


def test_startup_calibration_sweeps_at_the_dispatchers_block(
        calibration_dir, monkeypatch):
    seen = {}

    def fake(hw, **kw):
        seen.update(kw, hw=hw)
        return port_cal.Calibration(hardware=hw.name,
                                    fingerprint=hw.fingerprint(),
                                    backend=kw["backend"], entries=())
    monkeypatch.setattr(port_serve, "calibrate", fake)
    port_serve.run_startup_calibration("cpu", scale=5)
    disp = default_dispatcher("cpu")
    assert seen["hw"] is port_hw.HOST_CPU
    assert (seen["backend"], seen["bcsr_block"], seen["scale"]) == \
        ("torch", disp.bcsr_block, 5)
    assert str(seen["device"]) == "cpu"
    seen.clear()
    port_serve.run_startup_calibration("cpu")
    assert "scale" not in seen              # the sweep's default on the CPU
