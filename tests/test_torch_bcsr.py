"""The BCSR kernel's shape rule, and the reference's adversarial set
through the port's BCSR layout and plain version.

``bcsr_variant`` names the kernel a CUDA operand launches: the t = 64
variants (register-tiled fp32, TMA + ``wgmma`` at bf16) at the widths
their 16-byte copies take, the generic kernel for every other shape.  The
adversarial matrices (``tests/test_differential.py``'s ``ADVERSARIAL``: an
all-zero matrix, n = 1, one hub row, singleton rows, alternating empty rows,
a lone corner) go through the port's ``("bcsr", "cuda")`` prepare at every
block edge t that divides their n: the layout must equal the reference's
``pad_empty_block_rows(coo_to_bcsr(...))`` byte for byte, and the plain
version must agree with the reference's oracle within ``4 * eps * (|A| @
|B|) + ATOL + RTOL * |C|`` per side.  The same cases run through the CUDA
kernels in ``tests/test_torch_gpu.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision import as_precision as ref_precision
from repro.kernels import ref as ref_oracle
from repro.kernels import registry as ref_registry
from repro.sparse import formats as ref_fmt

from repro_torch import interop, kernels
from repro_torch.core.precision import as_precision
from repro_torch.kernels import registry as port_registry
from repro_torch.kernels.bcsr_spmm import (VARIANTS, bcsr_spmm,
                                           bcsr_spmm_plain, bcsr_variant)
from repro_torch.sparse.formats import host_values

from test_differential import ADVERSARIAL

RTOL = ATOL = 5e-4
F32, BF16 = torch.float32, torch.bfloat16

#: Block edges tried on every adversarial case (each that divides its n).
EDGES = (1, 2, 4, 8, 16, 17)

ADV_CASES = [(case, t) for case in sorted(ADVERSARIAL) for t in EDGES
             if ADVERSARIAL[case].n % t == 0]

TOKENS = port_registry.get("bcsr", "cuda").supported_precisions


# ---------------------------------------------------------------------- #
# The shape rule.
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype,variant", [(F32, "tile64_f32"),
                                           (BF16, "wgmma_bf16")])
def test_variant_takes_the_main_path_shape(dtype, variant):
    """t = 64 (the registry's ``bcsr_block``), d = 64: the fast kernels."""
    assert port_registry.KernelContext().bcsr_block == 64
    assert bcsr_variant(64, 64, dtype) == variant
    assert variant in VARIANTS


@pytest.mark.parametrize("d", [4, 8, 128, 200])
def test_variant_fp32_takes_every_width_of_whole_float4s(d):
    assert bcsr_variant(64, d, F32) == "tile64_f32"


@pytest.mark.parametrize("d", [8, 128, 200])
def test_variant_bf16_takes_every_width_of_16_byte_rows(d):
    assert bcsr_variant(64, d, BF16) == "wgmma_bf16"


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("t", [1, 16, 32, 128])
def test_variant_other_block_edges_are_generic(t, dtype):
    for d in (1, 8, 64, 200):
        assert bcsr_variant(t, d, dtype) == "generic"


@pytest.mark.parametrize("dtype,ragged", [(F32, (1, 2, 31, 33, 62)),
                                          (BF16, (1, 4, 31, 60, 100))])
def test_variant_ragged_widths_are_generic(dtype, ragged):
    for d in ragged:
        assert bcsr_variant(64, d, dtype) == "generic"


@pytest.mark.parametrize("n", [1, 16, 17, 48, 63])
def test_variant_below_64_rows_is_generic(n):
    """n < 64: no block edge that divides n reaches 64."""
    for t in range(1, n + 1):
        if n % t == 0:
            for dtype in (F32, BF16):
                assert bcsr_variant(t, 64, dtype) == "generic"


def test_cpu_operands_take_the_plain_version_and_count_nothing():
    m = interop.coo_from_numpy(128, np.arange(128), np.arange(128),
                               np.ones(128, np.float32), "diag", {})
    ctx = port_registry.KernelContext(bcsr_block=64,
                                      device=torch.device("cpu"))
    layout = port_registry.get("bcsr", "cuda").prepare(m, ctx)
    b = torch.from_numpy(np.random.default_rng(0).normal(
        size=(128, 64)).astype(np.float32))
    before = dict(kernels.bcsr_spmm.LAUNCHES_BY_VARIANT)
    assert torch.equal(bcsr_spmm(layout, b), b)
    assert kernels.bcsr_spmm.LAUNCHES_BY_VARIANT == before


def test_reset_launch_counts_zeroes_the_variant_counts():
    kernels.bcsr_spmm.LAUNCHES_BY_VARIANT["generic"] += 3
    kernels.reset_launch_counts()
    assert set(kernels.bcsr_spmm.LAUNCHES_BY_VARIANT.values()) == {0}


# ---------------------------------------------------------------------- #
# The adversarial set.
# ---------------------------------------------------------------------- #

def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return host_values(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _layouts(case: str, t: int, token: str):
    m = ADVERSARIAL[case]
    prec = ref_precision(token)
    ref = ref_registry.pad_empty_block_rows(
        ref_fmt.coo_to_bcsr(m, t, prec.value_jnp))
    pm = interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                m.meta)
    ctx = port_registry.KernelContext(bcsr_block=t,
                                      precision=as_precision(token),
                                      device=torch.device("cpu"))
    port = port_registry.get("bcsr", "cuda").prepare(pm, ctx)
    return m, ref, port


@pytest.mark.parametrize("token", TOKENS)
@pytest.mark.parametrize("case,t", ADV_CASES,
                         ids=[f"{c}-t{t}" for c, t in ADV_CASES])
def test_adversarial_layout_equals_reference(case, t, token):
    _, ref, port = _layouts(case, t, token)
    for f in ("blocks", "block_rows", "block_cols", "block_ptr"):
        r, p = _bits(getattr(ref, f)), _bits(getattr(port, f))
        assert r.dtype == p.dtype and r.shape == p.shape, f
        assert np.array_equal(r, p), f"{case} t={t} {token}: {f} differs"
    for f in ("n", "t", "nnz"):
        assert getattr(ref, f) == getattr(port, f), f
    # Every block row owns a block, as the kernels require.
    assert bool((torch.diff(port.block_ptr) >= 1).all())


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("token", TOKENS)
@pytest.mark.parametrize("case,t", ADV_CASES,
                         ids=[f"{c}-t{t}" for c, t in ADV_CASES])
def test_adversarial_plain_version_matches_reference(case, t, token, d):
    m, ref, port = _layouts(case, t, token)
    prec = ref_precision(token)
    b = np.random.default_rng(d).normal(size=(m.n, d)).astype(np.float32)
    ref_c = np.asarray(ref_oracle.bcsr_ref(
        ref.blocks, ref.block_rows, ref.block_cols,
        jnp.asarray(b).astype(prec.value_jnp), n=m.n, t=t), np.float64)
    dtype = BF16 if prec.reduced else F32
    port_c = bcsr_spmm_plain(port, torch.from_numpy(b).to(dtype))
    assert port_c.dtype == dtype and tuple(port_c.shape) == (m.n, d)
    got = port_c.to(F32).numpy().astype(np.float64)
    dense = np.asarray(ref_fmt.coo_to_dense(m), np.float64)
    absprod = 4.0 * prec.eps * (np.abs(dense) @ np.abs(b.astype(np.float64)))
    bound = 2 * (absprod + ATOL) + RTOL * (np.abs(got) + np.abs(ref_c))
    assert np.isfinite(got).all()
    err = np.abs(got - ref_c)
    assert np.all(err <= bound), (
        f"{case} t={t} {token} d={d}: exceeds the bound by "
        f"{float(np.max(err - bound)):.3e}")
