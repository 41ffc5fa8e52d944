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

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.precision import as_precision as ref_precision
from repro.kernels import ref as ref_oracle
from repro.kernels import registry as ref_registry
from repro.sparse import formats as ref_fmt

from repro_torch import interop, kernels
from repro_torch.core import trace
from repro_torch.core.patterns import paper_suite, serving_suite
from repro_torch.core.precision import as_precision
from repro_torch.kernels import registry as port_registry
from repro_torch.kernels.bcsr_spmm import (VARIANTS, bcsr_spmm,
                                           bcsr_spmm_cuda, bcsr_spmm_plain,
                                           bcsr_variant, quadrant_mask,
                                           with_quadrants)
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


def test_reset_launch_counts_zeroes_the_masked_count():
    kernels.bcsr_spmm.LAUNCHES_MASKED += 5
    kernels.reset_launch_counts()
    assert kernels.bcsr_spmm.LAUNCHES_MASKED == 0


# ---------------------------------------------------------------------- #
# The adversarial set.
# ---------------------------------------------------------------------- #

def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return host_values(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _layouts(case: str, t: int, token: str):
    return _layouts_of(ADVERSARIAL[case], t, token)


def _layouts_of(m, t: int, token: str):
    """``(m, the reference's padded layout, the port's cuda prepare)``."""
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


# ---------------------------------------------------------------------- #
# The quadrant mask that tile64_f32 reads (t = 64).
# ---------------------------------------------------------------------- #

#: Where each adversarial case is placed in a 128 x 128 matrix, so that its
#: entries fall in every quadrant of a t = 64 block and across blocks; the
#: block rows it leaves empty are padded with zero blocks.
SHIFTS = ((0, 0), (32, 0), (0, 32), (40, 80), (96, 96))

T64_CASES = [(case, dr, dc) for case in sorted(ADVERSARIAL)
             for dr, dc in SHIFTS]


def _census(m, t: int = 64) -> dict:
    """``block row * nb + block column -> quadrant bits`` that ``m``'s
    nonzero entries set, counted from the COO alone."""
    keep = np.asarray(m.vals) != 0
    rows = m.rows[keep].astype(np.int64)
    cols = m.cols[keep].astype(np.int64)
    h = t // 2
    key = rows // t * (m.n // t) + cols // t
    bit = np.left_shift(1, 2 * (rows % t // h) + cols % t // h)
    order = np.argsort(key, kind="stable")
    key, bit = key[order], bit[order]
    uniq, start = np.unique(key, return_index=True)
    if uniq.size == 0:
        return {}
    return dict(zip(uniq.tolist(),
                    np.bitwise_or.reduceat(bit, start).tolist()))


def _expected_mask(layout, census: dict) -> np.ndarray:
    """The census read at each stored block (0 for a padded one)."""
    nb = layout.n // layout.t
    keys = (layout.block_rows.numpy().astype(np.int64) * nb
            + layout.block_cols.numpy())
    return np.array([census.get(k, 0) for k in keys.tolist()], np.uint8)


def _cuda_prepare(m, token: str = "f32i32", t: int = 64):
    ctx = port_registry.KernelContext(bcsr_block=t,
                                      precision=as_precision(token),
                                      device=torch.device("cpu"))
    return port_registry.get("bcsr", "cuda").prepare(m, ctx)


@pytest.mark.parametrize("scale", [10, 11])
@pytest.mark.parametrize("token", TOKENS)
def test_quadrant_mask_matches_a_census_of_the_fem_coo(scale, token):
    """``paper_suite``'s FEM operator (32 x 32 blocks) packed at t = 64:
    the mask the prepare carries is the COO's census, block for block."""
    m = paper_suite(scale)[f"fem_{scale}_t32"]()
    layout = _cuda_prepare(m, token)
    mask = layout.quadrants
    assert mask.dtype == torch.uint8
    assert tuple(mask.shape) == (layout.num_blocks,)
    want = _expected_mask(layout, _census(m))
    assert np.array_equal(mask.numpy(), want)
    # 32 x 32 blocks placed at random: most tiles hold one, some more.
    counts = np.unpackbits(want[:, None], axis=1).sum(1)
    assert (counts == 1).sum() > counts.size // 2 and counts.max() >= 2


@pytest.mark.parametrize("token", TOKENS)
def test_cuda_prepare_keeps_the_reference_arrays_and_adds_the_mask(token):
    m = paper_suite(10)["fem_10_t32"]()
    _, ref, port = _layouts_of(m, 64, token)
    for f in ("blocks", "block_rows", "block_cols", "block_ptr"):
        r, p = _bits(getattr(ref, f)), _bits(getattr(port, f))
        assert r.dtype == p.dtype and r.shape == p.shape, f
        assert np.array_equal(r, p), f
    assert np.array_equal(port.quadrants.numpy(),
                          quadrant_mask(port.blocks).numpy())


def test_moe_block_holds_every_quadrant():
    m = serving_suite(1024)["moe-block"]()
    layout = _cuda_prepare(m)
    assert layout.num_blocks == 1024 // 64
    assert set(layout.quadrants.tolist()) == {0xF}


def test_padded_empty_block_row_holds_no_quadrant():
    """Block row 1 of 3 has no entry: its padded zero block reads 0."""
    rows = np.array([0, 5, 130, 191], np.int32)
    cols = np.array([0, 100, 64, 191], np.int32)
    m = interop.coo_from_numpy(192, rows, cols,
                               np.array([1., 2., 3., 4.]), "custom", {})
    layout = _cuda_prepare(m)
    assert layout.block_rows.tolist() == [0, 0, 1, 2, 2]
    assert layout.quadrants.tolist() == [0b0001, 0b0010, 0, 0b0001, 0b1000]


@pytest.mark.parametrize("token", TOKENS)
@pytest.mark.parametrize("case,dr,dc", T64_CASES,
                         ids=[f"{c}-at{r}x{k}" for c, r, k in T64_CASES])
def test_adversarial_at_t64_layout_and_mask(case, dr, dc, token):
    """Each adversarial case placed in a 128 x 128 matrix at t = 64: the
    reference's arrays byte for byte, the mask the COO's census."""
    m = ADVERSARIAL[case]
    m = dataclasses.replace(m, n=128, rows=m.rows + dr, cols=m.cols + dc)
    _, ref, port = _layouts_of(m, 64, token)
    for f in ("blocks", "block_rows", "block_cols", "block_ptr"):
        assert np.array_equal(_bits(getattr(ref, f)),
                              _bits(getattr(port, f))), f
    assert np.array_equal(port.quadrants.numpy(),
                          _expected_mask(port, _census(m)))


def test_quadrant_mask_counts_nan_and_not_signed_zero():
    blocks = torch.zeros(3, 64, 64)
    blocks[0, 0, 63] = -0.0
    blocks[1, 63, 0] = float("nan")
    blocks[2, 31, 31] = 1e-30
    blocks[2, 32, 32] = -2.0
    assert quadrant_mask(blocks).tolist() == [0, 0b0100, 0b1001]


def test_quadrant_mask_chunks_agree_with_one_pass(monkeypatch):
    blocks = torch.from_numpy(np.random.default_rng(3).normal(
        size=(37, 8, 8)).astype(np.float32))
    blocks[blocks.abs() < 1.2] = 0
    whole = quadrant_mask(blocks)
    monkeypatch.setattr(kernels.bcsr_spmm, "QUADRANT_CHUNK", 5)
    assert torch.equal(quadrant_mask(blocks), whole)
    with pytest.raises(ValueError, match="odd"):
        quadrant_mask(torch.zeros(1, 3, 3))


def test_other_block_edges_carry_no_mask():
    m = paper_suite(10)["fem_10_t32"]()
    assert _cuda_prepare(m, t=32).quadrants is None
    layout = _cuda_prepare(m, t=32)
    assert with_quadrants(layout) is layout


def test_quadrant_span_under_the_pack_root():
    m = paper_suite(10)["fem_10_t32"]()
    n0 = len(trace.spans())
    with trace.span("spmm.pack"):
        layout = _cuda_prepare(m)
    (span,) = [s for s in trace.spans()[n0:]
               if s.name == "spmm.pack.quadrants"]
    bits = np.unpackbits(layout.quadrants.numpy()[:, None], axis=1)
    assert span.attrs == {"blocks": layout.num_blocks,
                          "quadrants": int(bits.sum())}
    assert span.parent_id is not None
    # Outside a set-up root the mask is made with no span.
    n1 = len(trace.spans())
    _cuda_prepare(m)
    assert not [s for s in trace.spans()[n1:]
                if s.name == "spmm.pack.quadrants"]


def test_plain_version_ignores_the_mask():
    m = paper_suite(10)["fem_10_t32"]()
    layout = _cuda_prepare(m)
    b = torch.from_numpy(np.random.default_rng(1).normal(
        size=(m.n, 8)).astype(np.float32))
    bare = dataclasses.replace(layout, quadrants=None)
    assert torch.equal(bcsr_spmm(layout, b), bcsr_spmm_plain(bare, b))


@pytest.mark.parametrize("bad", ["dtype", "shape"])
def test_wrapper_refuses_a_malformed_mask(bad):
    layout = _cuda_prepare(paper_suite(10)["fem_10_t32"]())
    mask = layout.quadrants
    mask = mask.to(torch.int32) if bad == "dtype" else mask[:-1]
    b = torch.zeros(layout.n, 8)
    before = kernels.bcsr_spmm.LAUNCHES
    with pytest.raises(ValueError, match="quadrant mask"):
        bcsr_spmm_cuda(dataclasses.replace(layout, quadrants=mask), b)
    assert kernels.bcsr_spmm.LAUNCHES == before
