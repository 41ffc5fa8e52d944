"""The port's roofline pieces against the reference's, on equal inputs.

``RooflinePoint`` / ``place`` / ``PERLMUTTER_MILAN`` / ``DistributedRoofline``
(``repro_torch.core.roofline``, ``core.hardware``) and ``analyze_record``
(``core.analyzer``) take the same numbers in both packages and must give
every property within 1e-12 relative; the hardware is built field for field
in each package.  The one deliberate difference: the port's
``sparse_component_ai`` places a component on the ``hw`` it is given, where
the reference's always uses its TPU, so ``attainable_flops_per_s`` is held
to the formula instead.  Then the reference's ``tests/test_roofline.py``
cases on the H100, and ``registry.spmm`` on the CPU.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.core import analyzer as ref_an
from repro.core import hardware as ref_hw
from repro.core import roofline as ref_rf
from repro.core import sparsity_models as ref_sm
from repro_torch.core import analyzer as an
from repro_torch.core import hardware as hw
from repro_torch.core import roofline as rf
from repro_torch.core import sparsity_models as sm
from repro_torch.core.patterns import erdos_renyi
from repro_torch.kernels import registry

REL = 1e-12


def _both_specs(spec):
    """The same fields as a spec of each package."""
    fields = {f.name: getattr(spec, f.name)
              for f in dataclasses.fields(spec)}
    return ref_hw.HardwareSpec(**fields), hw.HardwareSpec(**fields)


def _close(a, b):
    if isinstance(a, str) or a is None:
        assert a == b
    else:
        assert b == pytest.approx(a, rel=REL, abs=0.0), (a, b)


def test_perlmutter_milan_is_the_reference_node():
    assert dataclasses.asdict(hw.PERLMUTTER_MILAN) == \
        dataclasses.asdict(ref_hw.PERLMUTTER_MILAN)
    assert hw.by_name("milan") is hw.PERLMUTTER_MILAN
    assert hw.PERLMUTTER_MILAN.fingerprint() == \
        ref_hw.PERLMUTTER_MILAN.fingerprint()


@pytest.mark.parametrize("attained", [None, 10e9, 3e12])
@pytest.mark.parametrize("spec", [hw.PERLMUTTER_MILAN, hw.H100_SXM,
                                  hw.H100_BF16])
def test_place_equals_reference(spec, attained):
    ref_spec, port_spec = _both_specs(spec)
    n, nnz, d = 2 ** 20, 10 * 2 ** 20, 16
    ref_pt = ref_rf.place("er", ref_sm.ai_random(n, nnz, d), ref_spec,
                          attained)
    pt = rf.place("er", sm.ai_random(n, nnz, d), port_spec, attained)
    for prop in ("ai", "flops", "bound", "attainable_flops_per_s",
                 "roofline_fraction", "attained_flops_per_s"):
        _close(getattr(ref_pt, prop), getattr(pt, prop))


CASES = [(1e15, 1e12, 1e10, 6e14, 256), (1e12, 1e14, 1e9, 1e11, 512),
         (1e12, 1e9, 1e13, 0.0, 256), (0.0, 1e9, 0.0, 0.0, 1)]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("spec", [hw.H100_SXM, hw.H100_BF16, hw.H100_PCIE,
                                  hw.PERLMUTTER_MILAN])
def test_distributed_roofline_equals_reference(spec, case):
    flops, byts, coll, model, chips = case
    ref_spec, port_spec = _both_specs(spec)
    kw = dict(name="t", chips=chips, hlo_flops=flops, hlo_bytes=byts,
              collective_bytes=coll, model_flops=model)
    ref = ref_rf.DistributedRoofline(hardware=ref_spec, **kw).as_dict()
    port = rf.DistributedRoofline(hardware=port_spec, **kw).as_dict()
    assert ref.keys() == port.keys()
    for k in ref:
        _close(ref[k], port[k])


def _record(flops=1e15, byts=1e12, coll=1e10, chips=256, sparse=True):
    rec = {
        "arch": "x", "shape": "train_4k", "mesh": "32x8",
        "chips": chips,
        "cost": {"flops_per_device": flops / chips,
                 "bytes_per_device": byts / chips},
        "collectives": {"total": coll / chips},
        "model_flops": flops * 0.6,
    }
    if sparse:
        rec["sparse_components"] = [
            {"name": "moe", "regime": "blocked_tpu", "n": 8192,
             "nnz": 8192 * 128, "t": 128, "num_blocks": 64, "d": 4096,
             "sizeof_val": 2},
            {"name": "local", "regime": "diagonal", "n": 4096,
             "nnz": 4096 * 1024, "d": 4096, "sizeof_val": 2}]
    return rec


@pytest.mark.parametrize("kw", [{}, dict(flops=1e12, byts=1e14),
                                dict(flops=1e12, byts=1e9, coll=1e13)])
def test_analyze_record_equals_reference(kw):
    ref_spec, port_spec = _both_specs(hw.H100_BF16)
    ref = ref_an.analyze_record(_record(**kw), ref_spec)
    port = an.analyze_record(_record(**kw), port_spec)
    for k in ref["roofline"]:
        if k != "hint":
            _close(ref["roofline"][k], port["roofline"][k])
    assert len(ref["sparsity_corrections"]) == \
        len(port["sparsity_corrections"]) == 2
    for r, p in zip(ref["sparsity_corrections"],
                    port["sparsity_corrections"]):
        for k in r:
            if k == "attainable_flops_per_s":
                # the port places the component on the hw it was given
                assert p[k] == pytest.approx(
                    min(port_spec.hbm_bandwidth * p["ai"],
                        port_spec.peak_flops), rel=REL)
            else:
                _close(r[k], p[k])


def test_three_terms():
    roof = rf.DistributedRoofline(
        name="t", chips=256, hlo_flops=1e15, hlo_bytes=1e12,
        collective_bytes=1e10, hardware=hw.H100_BF16, model_flops=6e14)
    assert roof.compute_s == pytest.approx(1e15 / (256 * 989e12))
    assert roof.memory_s == pytest.approx(1e12 / (256 * 3.35e12))
    assert roof.collective_s == pytest.approx(1e10 / (256 * 450e9))
    assert roof.dominant == "compute"
    assert roof.useful_compute_ratio == pytest.approx(0.6)
    assert 0 < roof.mfu_upper_bound <= 1


def test_analyze_record_roundtrip_and_table():
    rec = an.analyze_record(_record())
    r = rec["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert "hint" in r
    table = an.format_roofline_table([rec])
    assert "train_4k" in table and "|" in table


def test_dominant_switches():
    mem = an.analyze_record(_record(flops=1e12, byts=1e14))
    assert mem["roofline"]["dominant"] == "memory"
    assert "memory" in mem["roofline"]["hint"]
    coll = an.analyze_record(_record(flops=1e12, byts=1e9, coll=1e13))
    assert coll["roofline"]["dominant"] == "collective"
    assert "collective" in coll["roofline"]["hint"]
    low = an.analyze_record(_record(flops=1e17, byts=1e9, coll=1e9))
    assert low["roofline"]["dominant"] == "compute"


def test_sparse_component_blocked():
    comp = {"name": "moe", "regime": "blocked_tpu", "n": 8192,
            "nnz": 8192 * 128, "t": 128, "num_blocks": 64, "d": 4096}
    out = an.sparse_component_ai(comp)
    assert out["mxu_utilization"] == 1.0
    assert out["ai"] > 0
    assert out["attainable_flops_per_s"] == pytest.approx(
        hw.H100_BF16.attainable(out["ai"]))


def test_tensor_core_spec():
    assert hw.tensor_core(hw.H100_SXM).peak_flops == 989e12
    assert hw.tensor_core(hw.H100_PCIE).peak_flops == 756e12
    assert hw.tensor_core(hw.HOST_CPU) is hw.HOST_CPU
    assert hw.H100_BF16.hbm_bandwidth == hw.H100_SXM.hbm_bandwidth


def test_registry_spmm_one_call():
    m = erdos_renyi(256, 6.0, seed=3)
    b = torch.from_numpy(np.random.default_rng(0).normal(
        size=(256, 8)).astype(np.float32))
    dense = np.zeros((256, 256))
    np.add.at(dense, (m.rows, m.cols), m.vals)
    want = dense @ b.numpy().astype(np.float64)
    for fmt in ("csr", "ell", "bcsr"):
        out = registry.spmm(m, b, format=fmt, backend="torch")
        np.testing.assert_allclose(out.numpy(), want, rtol=5e-4, atol=5e-4)
    out = registry.spmm(m, b, format="csr", backend="cuda",
                        ctx=registry.KernelContext(bcsr_block=32))
    np.testing.assert_allclose(out.numpy(), want, rtol=5e-4, atol=5e-4)
    assert math.isfinite(float(out.abs().sum()))
