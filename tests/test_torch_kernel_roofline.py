"""The paper's experiment config and the per-launch kernel rooflines of the
port against the reference.

``repro_torch.configs.paper_spmm.CONFIG`` must equal the reference's field
for field, and each of its implementations must have a port kernel spec.
``csr_kernel_roofline`` and ``bcsr_kernel_roofline`` must place a launch
where the reference does, every ``KernelRoofline`` field within 1e-12
relative: on the containers of every ``paper_suite`` matrix at n = 2**9
(made by the reference's numpy generators and bridged with
``repro_torch.interop``), at every ``CONFIG.d_values`` width, fp32 and bf16
values, CSR under three regime models, BCSR at t = 64 and 32, each under
the same hardware fields on both sides (the reference's TPU v5e and the
port's H100).
"""
from __future__ import annotations

import dataclasses
import functools
import inspect

import jax.numpy as jnp
import pytest
import torch

from repro import kernels as ref_kernels
from repro.configs import paper_spmm as ref_paper
from repro.core import hardware as ref_hw
from repro.core import patterns as ref_patterns
from repro.sparse import formats as ref_formats
from repro.sparse.dispatch import Dispatcher as RefDispatcher

from repro_torch import interop
from repro_torch import kernels as port_kernels
from repro_torch.configs import paper_spmm as port_paper
from repro_torch.core import hardware as port_hw
from repro_torch.kernels import registry as port_registry
from repro_torch.sparse import formats as port_formats
from repro_torch.sparse.dispatch import Dispatcher

SCALE = 9
NAMES = sorted(ref_patterns.paper_suite(SCALE))
REGIMES = ("random", "diagonal", "scale_free")
#: Value dtype name -> (port dtype, reference dtype).
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
#: (port spec, reference spec) with the same fields on both sides.
HARDWARE = (
    (port_hw.HardwareSpec(**dataclasses.asdict(ref_hw.TPU_V5E)),
     ref_hw.TPU_V5E),
    (port_hw.H100, ref_hw.HardwareSpec(**dataclasses.asdict(port_hw.H100))),
)
D_VALUES = port_paper.CONFIG.d_values
REL = 1e-12


@functools.lru_cache(maxsize=None)
def _matrices(name: str):
    """The reference's suite matrix and its bridge into the port."""
    m = ref_patterns.paper_suite(SCALE)[name]()
    return m, interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals,
                                     m.pattern, m.meta)


def _assert_same(port, ref, what) -> None:
    p, r = dataclasses.asdict(port), dataclasses.asdict(ref)
    assert list(p) == list(r), what
    assert p["name"] == r["name"], what
    for key in p:
        if key != "name":
            assert p[key] == pytest.approx(r[key], rel=REL, abs=0.0), \
                (what, key, p[key], r[key])


def test_config_equals_the_reference():
    port_cls = port_paper.SpMMExperimentConfig
    ref_cls = ref_paper.SpMMExperimentConfig
    assert dataclasses.asdict(port_paper.CONFIG) == \
        dataclasses.asdict(ref_paper.CONFIG)
    assert [(f.name, f.type) for f in dataclasses.fields(port_cls)] == \
        [(f.name, f.type) for f in dataclasses.fields(ref_cls)]
    assert port_cls.__dataclass_params__.frozen
    assert ref_cls.__dataclass_params__.frozen
    with pytest.raises(dataclasses.FrozenInstanceError):
        port_paper.CONFIG.scale = 18
    assert port_paper.CONFIG == port_cls()


def test_config_implementations_have_port_kernels():
    for backend in ("torch", "cuda"):
        assert set(port_paper.CONFIG.implementations) <= \
            set(port_registry.formats_for(backend))
        for name in port_paper.CONFIG.implementations:
            spec = port_registry.get(name, backend)
            assert (spec.format, spec.backend) == (name, backend)


def test_kernels_package_exports_the_reference_rooflines():
    for name in ("csr_kernel_roofline", "bcsr_kernel_roofline",
                 "dia_kernel_roofline", "grouped_matmul_roofline"):
        assert name in ref_kernels.__all__
        assert name in port_kernels.__all__
        assert getattr(port_kernels, name) is getattr(port_registry, name)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("name", NAMES)
def test_csr_kernel_roofline_matches_reference(name, regime, dtype):
    ref_m, port_m = _matrices(name)
    port_dtype, ref_dtype = DTYPES[dtype]
    port_a = port_formats.coo_to_csr(port_m, dtype=port_dtype)
    ref_a = ref_formats.coo_to_csr(ref_m, dtype=ref_dtype)
    assert port_a.data.dtype.itemsize == ref_a.data.dtype.itemsize
    for port_spec, ref_spec in HARDWARE:
        for d in D_VALUES:
            _assert_same(
                port_registry.csr_kernel_roofline(
                    port_a, d, regime=regime, hw=port_spec),
                ref_kernels.csr_kernel_roofline(
                    ref_a, d, regime=regime, hw=ref_spec),
                (name, regime, dtype, port_spec.name, d))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("t", [64, 32])
@pytest.mark.parametrize("name", NAMES)
def test_bcsr_kernel_roofline_matches_reference(name, t, dtype):
    """Every suite matrix, not only those the policy admits as BCSR: the
    placement is defined for any BCSR container."""
    ref_m, port_m = _matrices(name)
    port_dtype, ref_dtype = DTYPES[dtype]
    port_a = port_formats.coo_to_bcsr(port_m, t, dtype=port_dtype)
    ref_a = ref_formats.coo_to_bcsr(ref_m, t, dtype=ref_dtype)
    assert (port_a.num_blocks, port_a.nnz) == (ref_a.num_blocks, ref_a.nnz)
    for port_spec, ref_spec in HARDWARE:
        for d in D_VALUES:
            port_roof = port_registry.bcsr_kernel_roofline(
                port_a, d, hw=port_spec)
            _assert_same(port_roof,
                         ref_kernels.bcsr_kernel_roofline(
                             ref_a, d, hw=ref_spec),
                         (name, t, dtype, port_spec.name, d))
            assert 0.0 < port_roof.mxu_utilization <= 1.0


@pytest.mark.parametrize("t", [64, 32])
def test_bcsr_policy_admits_the_same_suite_matrices(t):
    """The matrices a run takes as BCSR: the port's policy admits the
    reference's, at both block edges."""
    admitted = {}
    for name in NAMES:
        ref_m, port_m = _matrices(name)
        port = Dispatcher(device="cpu", calibration=False, tree=False,
                          bcsr_block=t).plan(port_m, max(D_VALUES))
        ref = RefDispatcher(calibration=False, tree=False,
                            bcsr_block=t).plan(ref_m, max(D_VALUES))
        assert port.skips.get("bcsr") == ref.skips.get("bcsr"), name
        admitted[name] = "bcsr" not in port.skips
    # At n = 2**9 most suite matrices fill their blocks enough to admit
    # BCSR; the sparsest does not.
    assert admitted[f"ideal_diagonal_{SCALE}"]
    assert admitted[f"fem_{SCALE}_t32"]
    assert not admitted[f"er_{SCALE}_1"]


def test_default_hardware_is_the_h100():
    for fn in (port_registry.csr_kernel_roofline,
               port_registry.bcsr_kernel_roofline):
        assert inspect.signature(fn).parameters["hw"].default \
            is port_hw.H100
    ref_m, port_m = _matrices(f"fem_{SCALE}_t32")
    h100_ref = ref_hw.HardwareSpec(**dataclasses.asdict(port_hw.H100))
    csr = port_formats.coo_to_csr(port_m)
    bcsr = port_formats.coo_to_bcsr(port_m, 64)
    for d in D_VALUES:
        _assert_same(port_registry.csr_kernel_roofline(csr, d),
                     ref_kernels.csr_kernel_roofline(
                         ref_formats.coo_to_csr(ref_m), d, hw=h100_ref), d)
        _assert_same(port_registry.bcsr_kernel_roofline(bcsr, d),
                     ref_kernels.bcsr_kernel_roofline(
                         ref_formats.coo_to_bcsr(ref_m, 64), d,
                         hw=h100_ref), d)


@pytest.mark.parametrize("regime", ["blocked", "blocked_tpu", "no_model"])
def test_regime_without_a_csr_placement_raises_as_reference(regime):
    """``blocked`` needs the block shape, so it raises in both packages
    with the same exception type; so does an unknown model."""
    ref_m, port_m = _matrices(f"er_{SCALE}_10")
    with pytest.raises(Exception) as port_err:
        port_registry.csr_kernel_roofline(
            port_formats.coo_to_csr(port_m), 16, regime=regime)
    with pytest.raises(Exception) as ref_err:
        ref_kernels.csr_kernel_roofline(
            ref_formats.coo_to_csr(ref_m), 16, regime=regime)
    assert type(port_err.value) is type(ref_err.value)
    assert type(port_err.value) in (TypeError, ValueError)
