"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips when ``torch.cuda.is_available()``
is false (decided in a fixture, never at import).  The file imports neither
``jax`` nor the reference package, so it runs on a GPU host that has only
PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each SpMM kernel runs at every precision its spec declares, on the
serving-suite structure of its regime, at small n; the grouped matmul runs
at fp32 and bf16 on routed tokens (the full-size check is
``chip_smoke.py``).  The BCSR tests also run the reference's adversarial
set (``tests/test_differential.py``'s ``ADVERSARIAL``, written out here)
and assert which kernel variant each call launched.  Tolerance: ``4 * eps * (|A| @ |B|) + ATOL + RTOL * |C|``
per side, the sum of both sides for two computed results; the grouped
matmul's products are exact in fp32, so it takes
``moe_block.grouped_tolerance`` instead.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.patterns import (COOMatrix, banded, blocked,
                                       paper_suite, serving_suite)
from repro_torch.core.precision import as_precision
from repro_torch.kernels import bcsr_spmm as bcsr_module
from repro_torch.kernels import registry
from repro_torch.kernels.bcsr_spmm import (bcsr_spmm, bcsr_spmm_plain,
                                           bcsr_variant)
from repro_torch.kernels.binned_spmm import (binned_spmm,
                                             binned_spmm_plain,
                                             csr_to_slab_bins,
                                             slab_bin_layout)
from repro_torch.kernels import csr_spmm as csr_module
from repro_torch.kernels.csr_spmm import (csr_spmm, csr_spmm_plain,
                                          csr_to_row_tiles, csr_variant,
                                          row_tile_layout, with_work_list)
from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                grouped_matmul_cuda,
                                                grouped_matmul_plain)
from repro_torch.kernels.rowsplit_spmm import (rowsplit_spmm,
                                               rowsplit_spmm_plain)
from repro_torch.launch import moe_block
from repro_torch.sparse.formats import (BCSRMatrix, coo_to_dense,
                                        csr_host_arrays)

RTOL = ATOL = 5e-4

#: format -> (kernel name, serving-suite structure of its regime).
KERNEL_OF = {"csr": ("csr_spmm", "uniform"),
             "ell_coo": ("csr_spmm", "scale-free"),
             "binned": ("binned_spmm", "scale-free"),
             "rowsplit": ("rowsplit_spmm", "scale-free"),
             "bcsr": ("bcsr_spmm", "moe-block"),
             "dia": ("banded_spmm", "banded")}

CASES = [(f, tok) for f in KERNEL_OF
         for tok in registry.get(f, "cuda").supported_precisions]


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never on import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU host)")
    return torch.device("cuda")


def _check(m, got, ref, b, eps, what):
    dense = coo_to_dense(m, device=b.device).double()
    absprod = 4.0 * eps * (dense.abs() @ b.double().abs())
    g, r = got.double(), ref.double()
    assert g.shape == r.shape and bool(torch.isfinite(g).all()), what
    bound = 2 * (absprod + ATOL) + RTOL * (g.abs() + r.abs())
    worst = float((g - r).abs().sub(bound).max())
    assert worst <= 0, f"{what}: exceeds the bound by {worst:.3e}"


def _run(m, fmt, token, device, d=16, t=32):
    spec = registry.get(fmt, "cuda")
    prec = as_precision(token)
    ctx = registry.KernelContext(bcsr_block=t, plan_d=d, precision=prec,
                                 device=device)
    layout = spec.prepare(m, ctx)
    b = torch.from_numpy(np.random.default_rng(0).normal(
        size=(m.n, d)).astype(np.float32)).to(device, prec.value_torch)
    name = KERNEL_OF[fmt][0]
    mod = kernels.KERNEL_MODULES[name]
    before = kernels.launch_counts()[name]
    got = spec.run(layout, b, ctx)
    torch.cuda.synchronize()
    # Row-split's second kernel sums the carry rows and zeroes empty rows.
    launches = 2 if name == "rowsplit_spmm" and (
        layout.carry_rows.numel() + layout.empty_rows.numel()) else 1
    assert kernels.launch_counts()[name] == before + launches
    ref = getattr(mod, f"{name}_plain")(layout, b)
    _check(m, got, ref, b, prec.eps, f"{fmt}/{token} n={m.n}")


@pytest.mark.gpu
@pytest.mark.parametrize("fmt,token", CASES)
def test_cuda_kernel_matches_plain_version(cuda_device, fmt, token):
    m = serving_suite(1024)[KERNEL_OF[fmt][1]]()
    _run(m, fmt, token, cuda_device)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1001, 1002, 1004, 1024])
def test_banded_kernel_at_small_block_edges(cuda_device, n):
    """n that is not a multiple of the kernel's 128-row tile (and one that
    is): the last tile is partial."""
    _run(banded(n, 3, fill=0.9, seed=n), "dia", "f32i32", cuda_device, d=40)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 8, 16, 17, 31, 32, 33, 200])
def test_row_tile_kernels_at_ragged_widths(cuda_device, d):
    """Column slices that do not fill a warp or a 128-column block; at
    d <= 32 the CSR kernel's narrow walk at every lane count L (1-32),
    with d < L where d is not a power of two."""
    m = serving_suite(512)["scale-free"]()
    for fmt in ("csr", "binned", "rowsplit", "bcsr"):
        _run(m, fmt, "f32i32", cuda_device, d=d)


@pytest.mark.gpu
@pytest.mark.parametrize("token", ["f32i32", "bf16i32"])
@pytest.mark.parametrize("d", [1, 31, 33, 64, 200])
def test_banded_kernel_at_ragged_widths(cuda_device, d, token):
    """Widths that take each way of staging the B window: one bulk copy
    (d = 64), 16-byte copies per column slice (d = 200 at fp32), plain
    loads (rows that are not 16-byte multiples), scalar C stores."""
    for n in (1024, 1000):
        _run(banded(n, 5, fill=0.9, seed=d), "dia", token, cuda_device, d=d)


def _far_diagonals(n: int, offsets) -> COOMatrix:
    """Every listed diagonal full, values from a seed."""
    rows, cols = [], []
    for off in offsets:
        r = np.arange(max(0, -off), min(n, n - off))
        rows.append(r)
        cols.append(r + off)
    rows = np.concatenate(rows).astype(np.int32)
    cols = np.concatenate(cols).astype(np.int32)
    vals = np.random.default_rng(n).normal(size=rows.shape[0])
    return COOMatrix(n=n, rows=rows, cols=cols, vals=vals, pattern="far")


@pytest.mark.gpu
@pytest.mark.parametrize("token", ["f32i32", "bf16i32"])
@pytest.mark.parametrize("d", [16, 64])
def test_banded_kernel_reads_b_through_l1_for_a_wide_span(cuda_device, d,
                                                          token):
    """Offsets 6,000 rows apart: the window would not fit shared memory,
    so each block reads B through L1 (edge tiles included)."""
    _run(_far_diagonals(8192, (-3000, 0, 3000)), "dia", token, cuda_device,
         d=d)


def _stencil_reference():
    """``bench/stencil27_reference.py`` (plain torch), loaded by path."""
    import importlib.util
    import pathlib
    path = (pathlib.Path(__file__).resolve().parents[1] / "bench"
            / "stencil27_reference.py")
    spec = importlib.util.spec_from_file_location("stencil27_reference",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 4, 64, 65, 100])
@pytest.mark.parametrize("grid", [(24, 24, 24), (48, 48, 48)],
                         ids=["24^3", "48^3"])
def test_banded_kernel_on_the_hpcg_stencil(cuda_device, grid, d):
    """HPCG's 27-point operator packed as the plan packs it (DIA, no band)
    against the plain float64 stencil reference, within ``28 * 2**-24 *
    (|A| @ |B|)`` (a float32 sum of 27 products).  Offsets span 1,202 rows
    (24^3) and 4,706 (48^3): the window of 128 + span rows passes the 96 KB
    budget at every width but d = 4 (1,330 and 4,834 rows of 16 B, one
    bulk copy), so the launch reads B through L1 (mode ``none``)."""
    ref = _stencil_reference()
    nx, ny, nz = grid
    coef = ref.random_coefficients(nx, ny, nz, d)
    rows, cols, vals = ref.coo(coef)
    m = COOMatrix(n=nx * ny * nz, rows=rows.to(torch.int32).numpy(),
                  cols=cols.to(torch.int32).numpy(), vals=vals.numpy(),
                  pattern="diagonal")
    spec = registry.get("dia", "cuda")
    ctx = registry.KernelContext(plan_d=d, device=cuda_device)
    layout = spec.prepare(m, ctx)
    assert layout.diags.numel() == 27 * m.n
    b = torch.from_numpy(np.random.default_rng(d).normal(
        size=(m.n, d)).astype(np.float32)).to(cuda_device)
    from repro_torch.kernels import banded_spmm as banded_module
    before = dict(banded_module.LAUNCHES_BY_WINDOW)
    got = spec.run(layout, b, ctx)
    torch.cuda.synchronize()
    mode = "bulk" if d == 4 else "none"
    assert {k: v - before[k] for k, v in
            banded_module.LAUNCHES_BY_WINDOW.items()} == \
        {k: int(k == mode) for k in banded_module.WINDOWS}
    want = ref.apply(coef, b)
    mag = ref.apply(coef.abs(), b.abs())
    err = (got.double() - want).abs()
    assert bool((err <= 28 * 2.0 ** -24 * mag).all()), \
        float((err / mag).max())


@pytest.mark.gpu
def test_banded_kernel_counts_a_bulk_window_on_a_narrow_band(cuda_device):
    """A band of 5 at d = 64 (offsets -4 to 4): the window, 136 rows of
    256 B, is one bulk copy."""
    from repro_torch.kernels import banded_spmm as banded_module
    before = dict(banded_module.LAUNCHES_BY_WINDOW)
    _run(banded(4096, 5, fill=0.9, seed=5), "dia", "f32i32", cuda_device,
         d=64)
    assert {k: v - before[k] for k, v in
            banded_module.LAUNCHES_BY_WINDOW.items()} == \
        {k: int(k == "bulk") for k in banded_module.WINDOWS}


def _skewed(n: int = 1024) -> COOMatrix:
    """A hub row with n nonzeros next to n singleton rows."""
    rows = np.concatenate([np.full(n, 3), np.arange(n)]).astype(np.int32)
    cols = np.concatenate([np.arange(n), np.arange(n)]).astype(np.int32)
    vals = (1.0 + np.arange(2 * n)) / n
    return COOMatrix(n=n, rows=rows, cols=cols, vals=vals, pattern="skew")


#: Row-tile format -> (packer, layout builder, kernel, plain version).
ROW_TILE_KERNELS = {
    "csr": (csr_to_row_tiles, row_tile_layout, csr_spmm, csr_spmm_plain),
    "binned": (csr_to_slab_bins, slab_bin_layout, binned_spmm,
               binned_spmm_plain)}


def _sparse_check(m, got, ref, b, eps, what):
    """``_check`` with ``|A| @ |B|`` from the COO arrays (no dense A)."""
    dev = b.device
    rows = torch.from_numpy(m.rows.astype(np.int64)).to(dev)
    cols = torch.from_numpy(m.cols.astype(np.int64)).to(dev)
    vals = torch.from_numpy(np.abs(m.vals)).to(dev, torch.float64)
    absprod = torch.zeros(m.n, b.shape[1], dtype=torch.float64, device=dev)
    absprod.index_add_(0, rows, vals[:, None] * b.double().abs()[cols])
    g, r = got.double(), ref.double()
    assert g.shape == r.shape and bool(torch.isfinite(g).all()), what
    bound = 2 * (4.0 * eps * absprod + ATOL) + RTOL * (g.abs() + r.abs())
    worst = float((g - r).abs().sub(bound).max())
    assert worst <= 0, f"{what}: exceeds the bound by {worst:.3e}"


def _row_tile_case(m, fmt, token, device, *, piece_nnz=None, b_tile=None,
                   d=40, poison=None):
    """Pack ``m`` for ``fmt``, run its kernel once (after leaving ``poison``
    in the allocator's cache) and hold it against the plain version.
    Returns ``(layout, C)``."""
    pack, make, kernel, plain = ROW_TILE_KERNELS[fmt]
    prec = as_precision(token)
    arrays = pack(*csr_host_arrays(m, prec.value_torch), n=m.n,
                  b_tile=b_tile, index_dtype=prec.index_np)
    layout = make(*arrays, n=m.n, b_tile=b_tile, device=device)
    if piece_nnz is not None:
        layout = with_work_list(layout, piece_nnz)
    b = torch.from_numpy(np.random.default_rng(2).normal(
        size=(m.n, d)).astype(np.float32)).to(device, prec.value_torch)
    if poison is not None:
        torch.full((m.n, d), poison, dtype=b.dtype, device=device)
    before = kernels.launch_counts()[f"{fmt}_spmm"]
    walks = dict(csr_module.LAUNCHES_BY_VARIANT)
    got = kernel(layout, b)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[f"{fmt}_spmm"] == before + 1
    if fmt == "csr":
        walk = csr_variant(d)[0]
        assert csr_module.LAUNCHES_BY_VARIANT[walk] == walks[walk] + 1
    _sparse_check(m, got, plain(layout, b), b, prec.eps,
                  f"{fmt}/{token} n={m.n}")
    return layout, got


@pytest.mark.gpu
@pytest.mark.parametrize("d", [4, 40, 200])
@pytest.mark.parametrize("token", ["f32i32", "bf16i32", "bf16i16"])
@pytest.mark.parametrize("fmt", ["csr", "binned"])
def test_row_tile_kernels_split_a_long_hub_row(cuda_device, fmt, token, d):
    """A hub row of 50,000 nonzeros (30,000 at bf16i16, whose layouts
    need n <= 32,767) next to singleton rows, cut into pieces of at most
    256 real entries that run in parallel; at d = 200 four column slices
    of a split tile add into the same rows; at d = 4 CSR's narrow walk
    sums its groups before it adds them."""
    hub = 30_000 if token == "bf16i16" else 50_000
    m = _skewed(hub)
    layout, _ = _row_tile_case(m, fmt, token, cuda_device, piece_nnz=256,
                               b_tile=8192, d=d)
    assert layout.num_pieces >= hub // 256
    if fmt == "csr":
        assert 0 in layout.split_tiles.tolist()    # the hub row's tile


def _with_empty_tiles(n: int = 2048, zeros: bool = False) -> COOMatrix:
    """A random matrix whose every fifth row tile is empty; with
    ``zeros``, every third stored value is an explicit zero."""
    m = serving_suite(n)["uniform"]()
    keep = (m.rows // 8) % 5 != 2
    vals = m.vals[keep]
    if zeros:
        vals = np.where(np.arange(vals.shape[0]) % 3 == 0, 0.0, vals)
    return COOMatrix(n=n, rows=m.rows[keep], cols=m.cols[keep], vals=vals,
                     pattern="custom")


def _hub_with_empty_rows(n: int = 2048) -> COOMatrix:
    """``_with_empty_tiles`` with row 3 holding every column (a hub over
    n / 128 chunks) and the last row empty."""
    m = _with_empty_tiles(n)
    keep = (m.rows != 3) & (m.rows != n - 1)
    rows = np.concatenate([m.rows[keep], np.full(n, 3)])
    cols = np.concatenate([m.cols[keep], np.arange(n)])
    vals = np.concatenate([m.vals[keep],
                           np.random.default_rng(n).normal(size=n)])
    order = np.lexsort((cols, rows))
    return COOMatrix(n=n, rows=rows[order].astype(np.int32),
                     cols=cols[order].astype(np.int32), vals=vals[order],
                     pattern="custom")


#: Row-split test matrices: a hub row over many chunks with empty rows
#: (the last included), one hub next to singleton rows, and scale-free.
ROWSPLIT_MATRICES = {"hub-empty": _hub_with_empty_rows,
                     "skew": _skewed,
                     "scale-free": lambda: serving_suite(1024)["scale-free"]()}


def _rowsplit_case(m, token, device, d):
    """Pack ``m`` for the row-split kernels, run them once on C and carry
    buffers that hold NaN from the allocator's cache, and hold C against
    the plain version.  Returns ``(layout, b, C)``."""
    prec = as_precision(token)
    ctx = registry.KernelContext(plan_d=d, precision=prec, device=device)
    layout = registry.get("rowsplit", "cuda").prepare(m, ctx)
    b = torch.from_numpy(np.random.default_rng(d).normal(
        size=(m.n, d)).astype(np.float32)).to(device, prec.value_torch)
    torch.full((m.n, d), float("nan"), dtype=b.dtype, device=device)
    torch.full((layout.num_chunks, 2, d), float("nan"), device=device)
    before = kernels.launch_counts()["rowsplit_spmm"]
    got = rowsplit_spmm(layout, b)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rowsplit_spmm"] == before + 2
    _sparse_check(m, got, rowsplit_spmm_plain(layout, b), b, prec.eps,
                  f"rowsplit/{token} n={m.n} d={d}")
    return layout, b, got


@pytest.mark.gpu
@pytest.mark.parametrize("d,walk", [(4, "narrow"), (64, "wide")])
def test_csr_kernel_counts_its_walk(cuda_device, d, walk):
    """A CUDA operand of width d launches the walk csr_variant names, and
    LAUNCHES_BY_VARIANT counts it and no other."""
    m = serving_suite(512)["scale-free"]()
    before = dict(csr_module.LAUNCHES_BY_VARIANT)
    _run(m, "csr", "f32i32", cuda_device, d=d)
    assert csr_variant(d)[0] == walk
    assert {k: v - before[k]
            for k, v in csr_module.LAUNCHES_BY_VARIANT.items()} == {
        k: int(k == walk) for k in csr_module.VARIANTS}


@pytest.mark.gpu
@pytest.mark.parametrize("token", ["f32i32", "bf16i32", "bf16i16"])
@pytest.mark.parametrize("d", [1, 40, 64, 130])
def test_rowsplit_kernel_at_ragged_widths(cuda_device, d, token):
    """Odd d takes scalar loads, even d one vector per lane; d = 130 runs
    three column slices, the last two columns wide."""
    m = _hub_with_empty_rows()
    layout, _, got = _rowsplit_case(m, token, cuda_device, d)
    assert layout.carry_rows.numel() and layout.empty_rows.numel()
    assert not bool(got[layout.empty_rows.long()].any())


@pytest.mark.gpu
@pytest.mark.parametrize("structure", sorted(ROWSPLIT_MATRICES))
def test_rowsplit_kernel_writes_every_row_of_a_dirty_buffer(cuda_device,
                                                          structure):
    """C and the carry buffer come from torch.empty with NaN left in the
    allocator's cache: every row of C must be written -- owned rows, carry
    rows and the rows with no entry, as zeros."""
    m = ROWSPLIT_MATRICES[structure]()
    layout, _, got = _rowsplit_case(m, "f32i32", cuda_device, 40)
    assert bool(torch.isfinite(got).all())
    empty = torch.ones(m.n, dtype=torch.bool, device=cuda_device)
    empty[torch.from_numpy(m.rows.astype(np.int64)).to(cuda_device)] = False
    assert torch.equal(torch.nonzero(empty).flatten(),
                       layout.empty_rows.long())
    assert not bool(got[empty].any())


@pytest.mark.gpu
@pytest.mark.parametrize("token", ["f32i32", "bf16i32", "bf16i16"])
def test_rowsplit_kernel_is_deterministic_without_partials(cuda_device,
                                                          token,
                                                          monkeypatch):
    """Two calls give C equal bit for bit; the CUDA path calls no
    index_add_ and allocates less than the [C * W, d] fp32 window
    partials it once wrote."""
    m = serving_suite(4096)["scale-free"]()
    layout, b, first = _rowsplit_case(m, token, cuda_device, 64)

    def refuse(*args, **kwargs):
        raise AssertionError("index_add_ on the CUDA path")
    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    second = rowsplit_spmm(layout, b)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_device) - base
    partials = layout.num_chunks * layout.window * 64 * 4
    assert peak < partials, f"{peak} bytes allocated, partials {partials}"
    bits = torch.int32 if first.dtype == torch.float32 else torch.int16
    assert torch.equal(first.view(bits), second.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [4, 40])
@pytest.mark.parametrize("token", ["f32i32", "bf16i32"])
@pytest.mark.parametrize("fmt", ["csr", "binned"])
def test_row_tile_kernels_write_every_row_of_a_dirty_buffer(cuda_device, fmt,
                                                           token, d):
    """C comes from torch.empty: with NaN left in the allocator's cache,
    every row must still be written, the empty tiles' rows as zeros."""
    m = _with_empty_tiles()
    _, got = _row_tile_case(m, fmt, token, cuda_device, b_tile=512, d=d,
                            poison=float("nan"))
    empty = torch.ones(m.n, dtype=torch.bool, device=cuda_device)
    empty[torch.from_numpy(m.rows.astype(np.int64)).to(cuda_device)] = False
    assert bool(empty.any()) and not bool(got[empty].any())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [4, 40])
@pytest.mark.parametrize("token", ["f32i32", "bf16i32"])
@pytest.mark.parametrize("fmt", ["csr", "binned"])
def test_row_tile_kernels_keep_explicit_zeros_and_skip_padding(cuda_device,
                                                               fmt, token, d):
    """Explicit zero values are real entries (0 * inf is NaN, as in the
    plain version); padding slots are never read (NaN there changes
    nothing)."""
    m = _with_empty_tiles(zeros=True)
    layout, got = _row_tile_case(m, fmt, token, cuda_device, b_tile=512, d=d)
    pad = (torch.arange(layout.vals.shape[1], device=cuda_device)[None, :]
           >= layout.chunk_len[:, None])
    assert bool(pad.any())
    poisoned = dataclasses.replace(
        layout, vals=layout.vals.masked_fill(pad, float("nan")))
    b = torch.from_numpy(np.random.default_rng(2).normal(
        size=(m.n, d)).astype(np.float32)).to(cuda_device,
                                              layout.vals.dtype)
    kernel = ROW_TILE_KERNELS[fmt][2]
    assert torch.equal(kernel(poisoned, b).isnan(), got.isnan())
    # An infinite B row times an explicit zero is NaN in both versions.
    zero_col = int(m.cols[np.flatnonzero(m.vals == 0)[0]])
    b[zero_col] = float("inf")
    inf_got = kernel(layout, b)
    inf_ref = ROW_TILE_KERNELS[fmt][3](layout, b)
    torch.cuda.synchronize()
    assert torch.equal(inf_got.isnan(), inf_ref.isnan())
    assert bool(inf_got.isnan().any())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bm,k", [(64, 2), (128, 8)])
def test_grouped_kernel_matches_plain_version(cuda_device, dtype, bm, k):
    args = types.SimpleNamespace(tokens=300, d_model=256, experts=16,
                                 d_ff=384, dtype=dtype, seed=bm + k)
    x, w, router = moe_block.make_inputs(args, cuda_device)
    routed = moe_block.route_and_block(x, router, num_experts=16, k=k,
                                       bm=bm)
    before = kernels.launch_counts()["grouped_matmul"]
    got = grouped_matmul(routed.x, w, routed.group_ids, bm=bm)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["grouped_matmul"] == before + 1
    ref = grouped_matmul_plain(routed.x, w, routed.group_ids, bm=bm)
    absprod = grouped_matmul_plain(
        routed.x.abs().float(), w.abs().float(), routed.group_ids, bm=bm)
    g, r = got.double(), ref.double()
    assert got.dtype == x.dtype and bool(torch.isfinite(g).all())
    bound = moe_block.grouped_tolerance(absprod.double(), x.dtype, g, r)
    worst = float((g - r).abs().sub(bound).max())
    assert worst <= 0, f"grouped {dtype} bm={bm}: exceeds by {worst:.3e}"
    moe_block.expert_error(x, w, routed, got)


def _grouped_padding_case(device, dtype, bm: int, K: int) -> None:
    """Expert 1's only row block is padding (zero rows) and must come out
    zero; the kernel wrapper is called directly, so K need only divide by
    the 64-deep k step (the reference's bk is 128)."""
    rng = np.random.default_rng(bm + K)
    E, N = 4, 384
    gids = torch.tensor([0, 0, 1, 2, 3, 3, 3, 0], dtype=torch.int32,
                        device=device)
    x = rng.normal(size=(gids.numel() * bm, K)).astype(np.float32)
    x[2 * bm:3 * bm] = 0.0
    x = torch.from_numpy(x).to(device, dtype)
    w = torch.from_numpy(rng.normal(size=(E, K, N)).astype(np.float32)).to(
        device, dtype)
    before = kernels.launch_counts()["grouped_matmul"]
    got = grouped_matmul_cuda(x, w, gids, bm=bm)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["grouped_matmul"] == before + 1
    ref = grouped_matmul_plain(x, w, gids, bm=bm)
    absprod = grouped_matmul_plain(x.abs().float(), w.abs().float(), gids,
                                   bm=bm)
    g, r = got.double(), ref.double()
    assert got.dtype == dtype and bool(torch.isfinite(g).all())
    bound = moe_block.grouped_tolerance(absprod.double(), x.dtype, g, r)
    worst = float((g - r).abs().sub(bound).max())
    assert worst <= 0, f"grouped {dtype} bm={bm} K={K}: exceeds by {worst:.3e}"
    assert not bool(got[2 * bm:3 * bm].any())


@pytest.mark.gpu
@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("K", [192, 256])
def test_grouped_bf16_kernel_with_a_padding_only_expert(cuda_device, bm, K):
    """K = 192 is a multiple of the 64-deep k step but not of 128."""
    _grouped_padding_case(cuda_device, torch.bfloat16, bm, K)


@pytest.mark.gpu
@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("K", [192, 4096])
def test_grouped_f32_kernel_with_a_padding_only_expert(cuda_device, bm, K):
    """The 64-row and the 128-row tile, over 24 and 512 k-slices of the
    double buffer."""
    _grouped_padding_case(cuda_device, torch.float32, bm, K)


@pytest.mark.gpu
def test_grouped_kernel_refuses_what_it_does_not_tile(cuda_device):
    x = torch.zeros(128, 80, device=cuda_device)
    w = torch.zeros(2, 80, 128, device=cuda_device)
    gids = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="K % 64"):
        grouped_matmul(x, w, gids, bm=32, bk=16)
    # The ids are checked once, when the spec binds its operand.
    with pytest.raises(ValueError, match="group ids"):
        registry.get("grouped", "cuda").bind(
            (torch.zeros(1, 128, 128, device=cuda_device), gids[:1] + 1, 128,
             128, 128), registry.KernelContext(device=cuda_device))


# ---------------------------------------------------------------------- #
# BCSR: the t = 64 variants (tile64_f32, wgmma_bf16) and the generic one.
# ---------------------------------------------------------------------- #

def _adv(n, rows, cols) -> COOMatrix:
    rows = np.asarray(rows, dtype=np.int32)
    cols = np.asarray(cols, dtype=np.int32)
    vals = 1.0 + np.arange(rows.shape[0], dtype=np.float32)
    return COOMatrix(n=n, rows=rows, cols=cols, vals=vals,
                     pattern="adversarial")


#: The reference's adversarial set, case for case.
ADVERSARIAL = {
    "all_zero": _adv(16, [], []),
    "n1_empty": _adv(1, [], []),
    "n1_dense": _adv(1, [0], [0]),
    "single_dense_row": _adv(16, [3] * 16, range(16)),
    "singleton_rows": _adv(24, range(24),
                           np.random.default_rng(0).permutation(24)),
    "empty_rows": _adv(32, [r for r in range(32) if r % 2 == 0] * 2,
                       list(range(0, 32, 2)) + list(range(1, 32, 2))),
    "corner": _adv(17, [16, 16, 0], [16, 0, 16]),
}

ADV_CASES = [(case, t) for case in sorted(ADVERSARIAL)
             for t in (1, 2, 4, 8, 16, 17) if ADVERSARIAL[case].n % t == 0]


def _bcsr_call(layout, b):
    """One kernel call; asserts that exactly the variant ``bcsr_variant``
    names for the shape launched, once."""
    want = bcsr_variant(layout.t, b.shape[1], b.dtype)
    before = dict(bcsr_module.LAUNCHES_BY_VARIANT)
    got = bcsr_spmm(layout, b)
    torch.cuda.synchronize()
    moved = {k: v - before[k]
             for k, v in bcsr_module.LAUNCHES_BY_VARIANT.items()}
    assert moved == {k: int(k == want) for k in moved}, moved
    return got


def _bcsr_check(layout, got, b, what):
    """``got`` against the plain version; ``|A| @ |B|`` from the plain
    version on the blocks' and B's magnitudes in fp32 (no dense A)."""
    ref = bcsr_spmm_plain(layout, b)
    mag = dataclasses.replace(layout, blocks=layout.blocks.abs().float())
    absprod = bcsr_spmm_plain(mag, b.abs().float()).double()
    eps = float(torch.finfo(b.dtype).eps)
    g, r = got.double(), ref.double()
    assert g.shape == r.shape and bool(torch.isfinite(g).all()), what
    bound = 2 * (4.0 * eps * absprod + ATOL) + RTOL * (g.abs() + r.abs())
    worst = float((g - r).abs().sub(bound).max())
    assert worst <= 0, f"{what}: exceeds the bound by {worst:.3e}"


def _bcsr_prepare(m, token, device, t):
    ctx = registry.KernelContext(bcsr_block=t, precision=as_precision(token),
                                 device=device)
    return registry.get("bcsr", "cuda").prepare(m, ctx)


def _bcsr_b(n, d, token, device, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, d)).astype(np.float32)).to(device,
                                            as_precision(token).value_torch)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("token", ["f32i32", "bf16i32"])
@pytest.mark.parametrize("case,t", ADV_CASES,
                         ids=[f"{c}-t{t}" for c, t in ADV_CASES])
def test_bcsr_kernel_on_adversarial(cuda_device, case, t, token, d):
    m = ADVERSARIAL[case]
    layout = _bcsr_prepare(m, token, cuda_device, t)
    b = _bcsr_b(m.n, d, token, cuda_device, seed=d)
    got = _bcsr_call(layout, b)
    _bcsr_check(layout, got, b, f"{case} t={t} {token} d={d}")
    _check(m, got, bcsr_spmm_plain(layout, b), b, as_precision(token).eps,
           f"{case} t={t} {token} d={d} vs dense")


@pytest.mark.gpu
@pytest.mark.parametrize("token", ["f32i32", "bf16i32"])
@pytest.mark.parametrize("d", [1, 8, 31, 64, 200])
@pytest.mark.parametrize("t", [16, 32, 64, 128])
def test_bcsr_kernel_at_block_edges_and_widths(cuda_device, t, d, token):
    """Several blocks per block row at every edge; at t = 64 the fast
    variants take d = 8, 64 and 200 (a ragged last 64-column slice), the
    generic kernel d = 1 and 31."""
    m = blocked(1024, 32, 160, 300.0, seed=t + d)
    layout = _bcsr_prepare(m, token, cuda_device, t)
    b = _bcsr_b(m.n, d, token, cuda_device)
    got = _bcsr_call(layout, b)
    _bcsr_check(layout, got, b, f"t={t} d={d} {token}")
    _check(m, got, bcsr_spmm_plain(layout, b), b, as_precision(token).eps,
           f"t={t} d={d} {token} vs dense")


def _ring_layout(nb: int, device, dtype, seed: int) -> BCSRMatrix:
    """t = 64 blocks, 0-5 per block row (empty rows padded), one row of
    48 blocks: more block rows than resident thread blocks, so each walks
    pairs inside a row and across rows."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 6, size=nb)
    counts[nb // 2] = 48
    rows = np.repeat(np.arange(nb), counts).astype(np.int32)
    cols = np.concatenate([np.sort(rng.choice(nb, size=k, replace=False))
                           for k in counts]).astype(np.int32)
    blocks = torch.from_numpy(rng.normal(
        size=(rows.shape[0], 64, 64)).astype(np.float32)).to(device, dtype)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    a = BCSRMatrix(blocks=blocks,
                   block_rows=torch.from_numpy(rows).to(device),
                   block_cols=torch.from_numpy(cols).to(device),
                   block_ptr=torch.from_numpy(ptr).to(device),
                   n=nb * 64, t=64, nnz=rows.shape[0] * 64 * 64)
    return registry.pad_empty_block_rows(a)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 200])
@pytest.mark.parametrize("token", ["f32i32", "bf16i32"])
def test_bcsr_ring_runs_within_and_across_block_rows(cuda_device, token, d):
    """2048 block rows of up to 48 blocks; two calls equal bit for bit."""
    dtype = as_precision(token).value_torch
    layout = _ring_layout(2048, cuda_device, dtype, seed=d)
    assert bool((torch.diff(layout.block_ptr) >= 1).all())
    b = _bcsr_b(layout.n, d, token, cuda_device)
    first = _bcsr_call(layout, b)
    _bcsr_check(layout, first, b, f"ring {token} d={d}")
    second = _bcsr_call(layout, b)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(first.view(bits), second.view(bits))


@pytest.mark.gpu
@pytest.mark.parametrize("token,variant", [("f32i32", "tile64_f32"),
                                           ("bf16i32", "wgmma_bf16")])
def test_bcsr_fast_variants_on_the_main_path_shape(cuda_device, token,
                                                   variant):
    """``moe-block`` through the registry's default block edge (t = 64)
    at d = 64: the fast variant, equal bit for bit from call to call."""
    m = serving_suite(32768)["moe-block"]()
    layout = registry.get("bcsr", "cuda").prepare(
        m, registry.KernelContext(precision=as_precision(token),
                                  device=cuda_device))
    b = _bcsr_b(m.n, 64, token, cuda_device)
    assert bcsr_variant(layout.t, 64, b.dtype) == variant
    first = _bcsr_call(layout, b)
    _bcsr_check(layout, first, b, f"moe-block {token}")
    bits = torch.int32 if b.dtype == torch.float32 else torch.int16
    assert torch.equal(first.view(bits), _bcsr_call(layout, b).view(bits))


def _quadrant_layout(nb: int, device, seed: int) -> BCSRMatrix:
    """t = 64 blocks whose quadrants held follow every one of the 16
    masks (0 a stored all-zero block), 0-6 blocks per block row (empty
    rows padded), one row of 48: masks mixed within rows and across the
    ring.  Carries its quadrant mask as the cuda prepare packs it."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, 7, size=nb)
    counts[nb // 3] = 48
    assert (counts == 0).any()
    rows = np.repeat(np.arange(nb), counts).astype(np.int32)
    cols = np.concatenate([np.sort(rng.choice(nb, size=k, replace=False))
                           for k in counts]).astype(np.int32)
    num = rows.shape[0]
    masks = rng.permutation(np.arange(num) % 16)
    held = (masks[:, None] >> np.arange(4)) & 1             # bit 2 rh + kh
    keep = np.repeat(np.repeat(held.reshape(num, 2, 2), 32, 1), 32, 2)
    blocks = (rng.normal(size=(num, 64, 64)) * keep).astype(np.float32)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    a = BCSRMatrix(blocks=torch.from_numpy(blocks).to(device),
                   block_rows=torch.from_numpy(rows).to(device),
                   block_cols=torch.from_numpy(cols).to(device),
                   block_ptr=torch.from_numpy(ptr).to(device),
                   n=nb * 64, t=64, nnz=int(np.count_nonzero(blocks)))
    return bcsr_module.with_quadrants(registry.pad_empty_block_rows(a))


def _masked_against_bare(layout, b, what):
    """The masked kernel's C: counted as masked, within the plain
    version's bound, and bitwise equal to the same layout run without its
    mask (which does every quadrant's work)."""
    masked = bcsr_module.LAUNCHES_MASKED
    got = _bcsr_call(layout, b)
    assert bcsr_module.LAUNCHES_MASKED == masked + 1, what
    _bcsr_check(layout, got, b, what)
    full = _bcsr_call(dataclasses.replace(layout, quadrants=None), b)
    assert bcsr_module.LAUNCHES_MASKED == masked + 1, what
    assert torch.equal(got.view(torch.int32), full.view(torch.int32)), what
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("d", [4, 8, 60, 64, 68, 128])
def test_bcsr_tile64_skips_the_quadrants_the_mask_leaves_out(cuda_device,
                                                             d):
    """Every one of the 16 masks, 2048 block rows (more than the resident
    thread blocks), padded rows among them."""
    layout = _quadrant_layout(2048, cuda_device, seed=d)
    assert set(layout.quadrants.tolist()) == set(range(16))
    b = _bcsr_b(layout.n, d, "f32i32", cuda_device, seed=d)
    _masked_against_bare(layout, b, f"16 masks d={d}")


@pytest.mark.gpu
@pytest.mark.parametrize("d", [4, 64])
def test_bcsr_tile64_mask_on_the_fem_operator(cuda_device, d):
    """``paper_suite``'s 32 x 32-block FEM operator packed at t = 64, as
    the plan packs ``fem-n20``."""
    m = paper_suite(14)["fem_14_t32"]()
    layout = _bcsr_prepare(m, "f32i32", cuda_device, 64)
    assert layout.quadrants is not None
    b = _bcsr_b(m.n, d, "f32i32", cuda_device, seed=d)
    got = _masked_against_bare(layout, b, f"fem d={d}")
    _check(m, got, bcsr_spmm_plain(layout, b), b,
           as_precision("f32i32").eps, f"fem d={d} vs dense")


#: The adversarial set placed in a 128 x 128 matrix at t = 64, so that its
#: entries fall in every quadrant and across blocks (as on the CPU in
#: ``tests/test_torch_bcsr.py``).
SHIFTS = ((0, 0), (32, 0), (0, 32), (40, 80), (96, 96))

T64_CASES = [(case, dr, dc) for case in sorted(ADVERSARIAL)
             for dr, dc in SHIFTS]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [4, 64])
@pytest.mark.parametrize("token", ["f32i32", "bf16i32"])
@pytest.mark.parametrize("case,dr,dc", T64_CASES,
                         ids=[f"{c}-at{r}x{k}" for c, r, k in T64_CASES])
def test_bcsr_t64_kernels_on_shifted_adversarial(cuda_device, case, dr, dc,
                                                 token, d):
    m = ADVERSARIAL[case]
    m = dataclasses.replace(m, n=128, rows=m.rows + dr, cols=m.cols + dc)
    layout = _bcsr_prepare(m, token, cuda_device, 64)
    b = _bcsr_b(m.n, d, token, cuda_device, seed=d)
    what = f"{case} at ({dr}, {dc}) {token} d={d}"
    if token == "f32i32":
        got = _masked_against_bare(layout, b, what)
    else:
        got = _bcsr_call(layout, b)
        _bcsr_check(layout, got, b, what)
    _check(m, got, bcsr_spmm_plain(layout, b), b, as_precision(token).eps,
           f"{what} vs dense")


# ---------------------------------------------------------------------- #
# The learning loop on the card: the calibration sweep and the harvest.
# ---------------------------------------------------------------------- #

#: The SpMM kernels the calibration sweep of the ``cuda`` backend runs.
SWEPT_KERNELS = ("csr_spmm", "binned_spmm", "rowsplit_spmm", "bcsr_spmm",
                 "banded_spmm")


@pytest.mark.gpu
def test_calibration_sweep_launches_the_kernels_and_calibrates_plans(
        cuda_device, tmp_path):
    from repro_torch.core.calibrate import CalibrationStore, calibrate
    from repro_torch.core.hardware import h100_from_device
    from repro_torch.sparse.dispatch import FORMATS, Dispatcher
    hw = h100_from_device(cuda_device)
    store = CalibrationStore(tmp_path)
    kernels.reset_launch_counts()
    cal = calibrate(hw, backend="cuda", device=cuda_device, scale=12,
                    bcsr_block=64, repeats=1, store=store)
    counts = kernels.launch_counts()
    assert all(counts[k] > 0 for k in SWEPT_KERNELS), counts
    assert [e.format for e in cal.entries] == list(FORMATS)
    assert all(v > 0 for e in cal.entries for v in e.measured.values())
    loaded = store.load(hw, "cuda")
    assert loaded is not None
    assert loaded.registry_version == registry.REGISTRY_VERSION
    disp = Dispatcher(device=cuda_device, calibration=store, tree=False)
    for name, gen in serving_suite(4096).items():
        plan = disp.plan(gen(), 64)
        assert plan.backend == "cuda"
        assert plan.candidate(plan.chosen).ceiling_source == "calibrated", \
            name


@pytest.mark.gpu
def test_harvest_on_two_vendored_matrices_with_the_kernels(cuda_device,
                                                           tmp_path):
    import shutil

    from repro_torch.data import corpus
    from repro_torch.data.dtree import DispatchTreeStore
    from repro_torch.launch import harvest_dispatch
    root = tmp_path / "corpus"
    root.mkdir()
    for name in ("blocked__fem_256_t32.smtx", "scale_free__hub_256_21.smtx"):
        shutil.copy(corpus.SAMPLES_DIR / name, root / name)
    store = DispatchTreeStore(tmp_path / "store")
    args = harvest_dispatch.parser().parse_args(
        ["--corpus-root", str(root), "--d", "32", "--repeats", "2",
         "--backend", "cuda", "--device", str(cuda_device),
         "--out-dir", str(tmp_path / "out")])
    kernels.reset_launch_counts()
    rec = harvest_dispatch.harvest(args, store=store)
    assert rec["backend"] == "cuda"
    assert sum(kernels.launch_counts().values()) > 0
    assert {r["matrix"] for r in rec["rows"]} == {"fem_256_t32",
                                                 "hub_256_21"}
    assert all(g > 0 for s in rec["samples"] for g in s["measured"].values())
    assert store.load("cuda") is not None
    assert len(rec["audit"]) == 2


# ---------------------------------------------------------------------- #
# The reference's adversarial set through the other SpMM kernels.
# ---------------------------------------------------------------------- #

#: kernel -> the format whose ``cuda`` spec packs its layout.
ADV_KERNELS = {"csr_spmm": "csr", "binned_spmm": "binned",
               "rowsplit_spmm": "rowsplit", "banded_spmm": "dia"}
ADV_KERNEL_CASES = [
    (name, case, tok) for name, f in ADV_KERNELS.items()
    for case in sorted(ADVERSARIAL)
    for tok in registry.get(f, "cuda").supported_precisions]


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("name,case,token", ADV_KERNEL_CASES,
                         ids=[f"{n}-{c}-{t}" for n, c, t in ADV_KERNEL_CASES])
def test_kernel_on_adversarial(cuda_device, name, case, token, d):
    m = ADVERSARIAL[case]
    spec = registry.get(ADV_KERNELS[name], "cuda")
    prec = as_precision(token)
    ctx = registry.KernelContext(plan_d=d, precision=prec,
                                 device=cuda_device)
    layout = spec.prepare(m, ctx)
    b = torch.from_numpy(np.random.default_rng(d).normal(
        size=(m.n, d)).astype(np.float32)).to(cuda_device, prec.value_torch)
    before = kernels.launch_counts()[name]
    got = spec.run(layout, b, ctx)
    torch.cuda.synchronize()
    if m.nnz:
        assert kernels.launch_counts()[name] > before
    ref = getattr(kernels.KERNEL_MODULES[name], f"{name}_plain")(layout, b)
    _check(m, got, ref, b, prec.eps, f"{name} {case} {token} d={d}")


# ---------------------------------------------------------------------- #
# The serving engine and the sharded tier on the card.
# ---------------------------------------------------------------------- #

@pytest.mark.gpu
def test_engine_serves_a_cuda_plan_with_staged_transfers(cuda_device):
    from repro_torch import sparse
    from repro_torch.sparse.dispatch import Dispatcher
    m = serving_suite(2048)["moe-block"]()
    disp = Dispatcher(device=cuda_device, calibration=False, tree=False)
    plan = sparse.plan(m, sparse.BSpec(d=64, reuse=64), dispatcher=disp)
    assert plan.chosen == "bcsr"
    eng = sparse.ServingEngine(max_queue=64)
    eng.register("spmm", plan)
    eng.warmup("spmm")
    rng = np.random.default_rng(0)
    bs = [torch.from_numpy(rng.standard_normal((m.n, w), dtype=np.float32))
          for w in (64, 32, 64, 32, 64, 64)]
    bs[0] = bs[0].pin_memory()          # a pinned operand is sent as is
    kernels.reset_launch_counts()
    eng.start()
    try:
        tickets = [eng.submit("spmm", b) for b in bs]
        outs = [t.result(timeout=120.0) for t in tickets]
    finally:
        eng.stop(timeout=120.0)
    # One launch per planned-width block of each batch, nothing else.
    calls = sum(-(-r.cols // r.block_d) for r in eng.batch_log)
    assert kernels.launch_counts()["bcsr_spmm"] == calls > 0
    for out, b in zip(outs, bs):
        assert out.device.type == "cpu"
        bd = b.to(cuda_device)
        want = bcsr_spmm_plain(plan.layout, bd)
        _check(m, out.to(cuda_device), want, bd, 2.0 ** -23, "engine")
    s = eng.stats()
    assert s["served"] == len(bs)
    assert len(eng.transfer_log) == s["batches"]
    for rec in eng.transfer_log:
        assert rec.kernel_ms > 0 and rec.h2d_ms >= 0 and rec.d2h_ms >= 0
        assert rec.bytes_in > 0 and rec.bytes_out > 0


@pytest.mark.gpu
@pytest.mark.parametrize("structure", sorted(serving_suite(64)))
def test_sharded_plan_on_one_card_matches_the_unsharded_plan(cuda_device,
                                                             structure):
    from repro_torch import sparse
    from repro_torch.launch.mesh import ShardMesh
    from repro_torch.sparse.dispatch import Dispatcher
    m = serving_suite(4096)[structure]()
    disp = Dispatcher(device=cuda_device, calibration=False, tree=False)
    single = sparse.plan(m, 64, dispatcher=disp)
    b = torch.from_numpy(np.random.default_rng(1).normal(
        size=(m.n, 64)).astype(np.float32)).to(cuda_device)
    want = single.execute(b)
    mesh = ShardMesh(["cuda:0"] * 4)
    for strat in sparse.B_STRATEGIES:
        try:
            p = sparse.plan(m, 64, mesh=mesh, b_strategy=strat,
                            dispatcher=disp)
        except ValueError:
            assert single.chosen == "dia" and strat == "all_gather"
            continue
        assert p.num_shards == 4 and p.chosen == single.chosen
        _check(m, p.execute(b), want, b, 2.0 ** -23, f"{structure}/{strat}")


# ---------------------------------------------------------------------- #
# The LM serving path: the MoE expert FFN on the grouped kernel.
# ---------------------------------------------------------------------- #

def _lm_config(layers: int = 2):
    """olmoe-1b-7b's reduced config at the widths the kernel tiles:
    d_model = moe_d_ff = 128 (K % 64 and N % 128 must be 0)."""
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config("olmoe-1b-7b").reduced(),
                               d_model=128, moe_d_ff=128, num_layers=layers)


class _CheckedGrouped:
    """A grouped product that launches the kernel and holds every launch
    against the plain version on the same operands within
    ``moe_block.grouped_tolerance``; padding rows (all-zero x rows) must
    come out exactly 0."""

    def __init__(self):
        self.launches, self.bounds = 0, []

    def __call__(self, x, w, gids, *, bm, bk, bn, expert_rows=None):
        out = grouped_matmul(x, w, gids, bm=bm, bk=bk, bn=bn,
                             expert_rows=expert_rows)
        ref = grouped_matmul_plain(x, w, gids, bm=bm, bk=bk, bn=bn,
                                   expert_rows=expert_rows)
        absprod = grouped_matmul_plain(x.abs().float(), w.abs().float(),
                                       gids, bm=bm)
        g, r = out.double(), ref.double()
        assert out.dtype == x.dtype and bool(torch.isfinite(g).all())
        bound = moe_block.grouped_tolerance(absprod.double(), x.dtype, g, r)
        worst = float((g - r).abs().sub(bound).max())
        assert worst <= 0, f"grouped {tuple(x.shape)}: exceeds by {worst}"
        padding = ~x.bool().any(dim=1)
        assert bool(padding.any()) and not bool(out[padding].any())
        self.launches += 1
        self.bounds.append(float(bound.max()))
        return out


@pytest.mark.gpu
@pytest.mark.parametrize("tokens", [4, 96])
def test_moe_ffn_kernel_matches_plain_version(cuda_device, tokens):
    """4 tokens: a decode step's batch (no slot dropped); 96: capacity
    overflows.  Each launch within the grouped tolerance; the layer's
    output, a combine of rows with weights summing to 1, within the
    largest launch bound plus two bf16 roundings per side."""
    from repro_torch.models.moe import MoE
    cfg = _lm_config()
    gen = torch.Generator(cuda_device).manual_seed(tokens)
    moe = MoE(cfg.d_model, cfg.moe_d_ff, cfg.num_experts,
              cfg.num_experts_per_token, cfg.moe_capacity_factor,
              dtype=torch.bfloat16, device=cuda_device, generator=gen)
    x = torch.randn(1, tokens, cfg.d_model, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    checked = _CheckedGrouped()
    got = moe(x, checked)
    ref = moe(x, grouped_matmul_plain)
    torch.cuda.synchronize()
    assert checked.launches == 2
    g, r = got.double(), ref.double()
    eps = float(torch.finfo(torch.bfloat16).eps)
    bound = max(checked.bounds) + 2 * eps * (g.abs() + r.abs())
    worst = float((g - r).abs().sub(bound).max())
    assert worst <= 0, f"moe_ffn T={tokens}: exceeds by {worst:.3e}"


@pytest.mark.gpu
def test_decode_step_launches_the_planned_grouped_count(cuda_device):
    from repro_torch.models.model import init_params
    cfg = _lm_config(layers=2)
    model = init_params(cfg, device=cuda_device,
                        generator=torch.Generator(cuda_device).manual_seed(0))
    cache = model.init_cache(4, 8)
    tokens = torch.tensor([3, 5, 7, 11], device=cuda_device)
    before = dict(kernels.launch_counts())
    logits = model.decode_step(cache, tokens, 0)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert model.grouped_launches_per_step() == 4
    assert after["grouped_matmul"] - before["grouped_matmul"] == 4
    assert all(after[k] == before[k] for k in after if k != "grouped_matmul")
    assert logits.shape == (4, cfg.padded_vocab)
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())


@pytest.mark.gpu
def test_capacity_buffer_padding_rows_come_out_zero(cuda_device):
    """The [E, C_pad, d] buffer's rows past each expert's routed tokens are
    zero going in and must be exactly zero coming out of both launches."""
    from repro_torch.models.moe import (MoE, bucket_local, capacity,
                                        padded_capacity, router)
    cfg = _lm_config()
    gen = torch.Generator(cuda_device).manual_seed(1)
    moe = MoE(cfg.d_model, cfg.moe_d_ff, cfg.num_experts,
              cfg.num_experts_per_token, cfg.moe_capacity_factor,
              dtype=torch.bfloat16, device=cuda_device, generator=gen)
    x = torch.randn(4, cfg.d_model, generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    weights, ids = router(x, moe.router, moe.k)
    cap = capacity(4, moe.k, moe.num_experts, moe.capacity_factor)
    buf, (e_idx, c_idx, w) = bucket_local(x, weights, ids, 0,
                                          moe.num_experts, cap,
                                          rows=padded_capacity(cap))
    assert buf.shape == (moe.num_experts, 64, cfg.d_model)
    out = moe.expert_ffn(buf)
    torch.cuda.synchronize()
    occupied = torch.zeros(buf.shape[:2], dtype=torch.bool,
                           device=cuda_device)
    occupied[e_idx[w > 0], c_idx[w > 0]] = True
    assert int(occupied.sum()) == 4 * moe.k
    assert not bool(buf[~occupied].any())
    assert not bool(out[~occupied].any())
    assert bool(out[occupied].any(dim=-1).all())


# ---------------------------------------------------------------------- #
# The training path: the grouped kernel's backward, a train step's
# launches, checkpoints of CUDA state.
# ---------------------------------------------------------------------- #

def _grouped_grad_case(dev, dtype, experts=8, rows=128, d=128, n=256,
                       routed=88, seed=0):
    """x ``[E * rows, d]`` whose rows past ``routed`` in each expert's run
    are zero (padding), w ``[E, d, n]``, dout zero on the padding rows (as
    the combine leaves it), and the expert-major group ids at bm = 64."""
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn(experts, rows, d, generator=gen, device=dev)
    x[:, routed:] = 0
    dout = torch.randn(experts, rows, n, generator=gen, device=dev)
    dout[:, routed:] = 0
    w = torch.randn(experts, d, n, generator=gen, device=dev) * d ** -0.5
    gids = torch.arange(experts, dtype=torch.int32,
                        device=dev).repeat_interleave(rows // 64)
    return (x.reshape(-1, d).to(dtype), w.to(dtype),
            dout.reshape(-1, n).to(dtype), gids)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_grouped_autograd_on_the_kernel_matches_plain(cuda_device, dtype):
    """``GroupedMatmulFn`` on the card: forward and ``dx`` launch the kernel
    (2 launches), ``dw`` is the batched product; each against autograd
    through ``grouped_matmul_plain`` within ``grouped_tolerance`` of its
    own |.| product.  ``dw`` may also reduce split-K partials in bf16
    (cuBLAS), which one more ``eps(dtype) * |x|^T |dout|`` covers.
    Padding rows get exactly zero ``dx``."""
    x, w, dout, gids = _grouped_grad_case(cuda_device, dtype)
    grads = {}
    for name, fn in (("kernel", grouped_matmul),
                     ("plain", grouped_matmul_plain)):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        before = kernels.launch_counts()["grouped_matmul"]
        fn(xg, wg, gids, bm=64, bk=128, bn=128,
           expert_rows=x.shape[0] // w.shape[0]).backward(dout)
        torch.cuda.synchronize()
        launched = kernels.launch_counts()["grouped_matmul"] - before
        assert launched == (2 if name == "kernel" else 0)
        grads[name] = (xg.grad, wg.grad)
    (dx, dw), (dx_p, dw_p) = grads["kernel"], grads["plain"]
    assert dx.dtype == dtype and dw.dtype == dtype
    eps = float(torch.finfo(dtype).eps)
    abs_dx = grouped_matmul_plain(dout.abs().float(),
                                  w.abs().float().transpose(1, 2)
                                  .contiguous(), gids, bm=64)
    e = w.shape[0]
    abs_dw = torch.bmm(x.abs().float().reshape(e, -1, x.shape[1])
                       .transpose(1, 2),
                       dout.abs().float().reshape(e, -1, dout.shape[1]))
    for what, got, ref, absprod, extra in (
            ("dx", dx, dx_p, abs_dx, 0.0), ("dw", dw, dw_p, abs_dw, eps)):
        g, r = got.double(), ref.double()
        assert bool(torch.isfinite(g).all()), what
        bound = moe_block.grouped_tolerance(absprod.double(), dtype, g, r) \
            + extra * absprod.double()
        worst = float((g - r).abs().sub(bound).max())
        assert worst <= 0, f"{what} {dtype}: exceeds the bound by {worst}"
    padding = ~dout.bool().any(dim=1)
    assert bool(padding.any()) and not bool(dx[padding].any())


def _train_batch(cfg, dev, batch=2, seq=64, seed=0):
    toks = np.random.default_rng(seed).integers(
        2, cfg.vocab_size - 1, size=(batch, seq + 1))
    t = torch.from_numpy(toks).to(dev)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


@pytest.mark.gpu
def test_train_step_launches_six_grouped_per_moe_layer(cuda_device):
    """One ``step_fn`` of a 2-layer MoE model with fp32 masters: forward,
    recompute and input gradient launch the kernel, 6 x 2 times, and the
    loss, the gradients and the updated weights are finite."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import train_step
    cfg = _lm_config(layers=2)
    model = init_params(cfg, device=cuda_device, masters=True,
                        generator=torch.Generator(cuda_device).manual_seed(0))
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in model.parameters())
    batch = _train_batch(cfg, cuda_device)
    planned = model.grouped_launches_per_step(train=True)
    assert planned == 12
    before = kernels.launch_counts()["grouped_matmul"]
    loss, grads = train_step.make_grads(cfg)(model, batch)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["grouped_matmul"] - before == planned
    assert bool(torch.isfinite(loss)) and set(grads) == \
        {n for n, _ in model.named_parameters()}
    assert all(bool(torch.isfinite(g).all()) for g in grads.values())
    assert float(grads["layers.0.moe.w_gate_up"].abs().max()) > 0
    step = train_step.make_train_step(
        cfg, ShapeConfig("t", 64, 2, "train"),
        schedule_kwargs={"warmup_steps": 1, "total_steps": 4})
    opt = adamw.init_state(dict(model.named_parameters()),
                           adamw.AdamWConfig())
    before = dict(kernels.launch_counts())
    metrics = step(model, opt, batch, 1)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["grouped_matmul"] - before["grouped_matmul"] == planned
    assert all(after[k] == before[k] for k in after if k != "grouped_matmul")
    assert bool(torch.isfinite(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0 and int(opt["count"]) == 1
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())


@pytest.mark.gpu
def test_checkpoint_round_trip_of_cuda_state_with_bf16_moments(cuda_device,
                                                               tmp_path):
    """A CUDA model's masters and bf16 ``mu`` / ``nu`` after one step come
    back from disk onto the card bit for bit, the bf16 leaves as
    ``"bfloat16"`` in the manifest."""
    import json
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import leaves
    from repro_torch.models.model import init_params
    from repro_torch.optim import adamw
    from repro_torch.train import train_step
    cfg = _lm_config(layers=2)
    model = init_params(cfg, device=cuda_device, masters=True,
                        generator=torch.Generator(cuda_device).manual_seed(1))
    opt_cfg = adamw.AdamWConfig(state_dtype="bfloat16")
    opt = adamw.init_state(dict(model.named_parameters()), opt_cfg)
    train_step.make_train_step(cfg, ShapeConfig("t", 64, 2, "train"),
                               opt_cfg=opt_cfg)(
        model, opt, _train_batch(cfg, cuda_device), 600)
    tree = {"params": {n: p.detach() for n, p in model.named_parameters()},
            "opt": opt}
    ck = Checkpointer(str(tmp_path))
    path = ck.save(0, tree)
    back = ck.restore(device=cuda_device, like=tree)
    with open(f"{path}/manifest.json") as f:
        dtypes = {k: v["dtype"] for k, v in json.load(f)["arrays"].items()}
    assert dtypes["opt/mu/layers.0.moe.w_down"] == "bfloat16"
    assert dtypes["params/layers.0.moe.w_down"] == "float32"
    assert int(back["opt"]["count"]) == 1
    got = dict(leaves(back))
    for name, leaf in leaves(tree):
        assert got[name].device.type == "cuda", name
        assert got[name].dtype == leaf.dtype, name
        assert torch.equal(got[name], leaf), name


@pytest.mark.gpu
def test_restart_on_the_card_equals_uninterrupted_training(cuda_device,
                                                           tmp_path):
    """A 2-layer MoE model trained 6 steps without a break, and trained 3
    steps, checkpointed, restored by a new trainer and trained 3 more, end
    with every weight and AdamW leaf equal bit for bit: the stated bound
    on the card is 0.  Every reduction on this path is ordered the same
    from run to run (``index_put_`` with ``accumulate`` sorts its indices
    on CUDA; the grouped kernel sums each tile in one block; cuBLAS picks
    the same algorithm for the same shapes): on an H100 a restart and a
    rerun both reproduced the run bit for bit."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import leaves
    from repro_torch.train.trainer import Trainer, TrainerConfig
    cfg = _lm_config(layers=2)

    def trainer(d, every):
        return Trainer(cfg, ShapeConfig("t", 64, 4, "train"),
                       TrainerConfig(ckpt_dir=str(tmp_path / d),
                                     ckpt_every=every,
                                     schedule_kwargs={"warmup_steps": 2,
                                                      "total_steps": 6}),
                       device=cuda_device)
    full = trainer("full", 100)
    full.run(6)
    first = trainer("resumed", 100)
    first.run(6, stop_after=3)
    second = trainer("resumed", 100)
    assert second.init_or_restore() == 3
    second.run(6)
    assert [h["loss"] for h in first.history + second.history] == \
        [h["loss"] for h in full.history]
    got = dict(leaves(second.state()))
    for name, leaf in leaves(full.state()):
        assert torch.equal(got[name], leaf), name


# ---------------------------------------------------------------------- #
# The local, vlm and encdec families: the card against the CPU port.
# ---------------------------------------------------------------------- #

@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen2-vl-7b",
                                  "whisper-base"])
def test_family_logits_on_the_card_match_the_cpu(cuda_device, arch):
    """The reduced arch's weights, drawn once on the CPU, on both devices
    at bf16: ``forward`` on the data pipeline's batch (gemma3 at S = 64 >
    its window of 32; qwen2-vl's ``mm_embeds`` and ``positions_3d``;
    whisper's ``frames``) and 48 teacher-forced ``decode_step`` calls
    (gemma3's 32-slot rings wrap; qwen2-vl's steps take the batch's
    ``positions_3d``; whisper's cross cache primed), logits
    within ``models.model.logit_tolerance`` of the CPU's; no port kernel
    launches.  Then ``models.decode_check`` on the card: decode against
    forward within its bounds."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import DataConfig, Pipeline
    from repro_torch.models import decode_check
    from repro_torch.models.model import LM, logit_tolerance
    cfg = get_config(arch).reduced()
    cpu = LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(cuda_device)
    batch = {k: torch.from_numpy(v) for k, v in Pipeline(
        cfg, ShapeConfig("t", 64, 2, "train"),
        DataConfig(seed=0)).batch_for_step(0).items() if k != "labels"}
    kw = {k: v for k, v in batch.items() if k != "tokens"}
    before = dict(kernels.launch_counts())

    def run(model, dev):
        args = {k: v.to(dev) for k, v in kw.items()}
        toks = batch["tokens"].to(dev)
        with torch.inference_mode():
            logits = model(toks, **args)
            cache = model.init_cache(2, 48)
            if cfg.family == "encdec":
                model.prime_cross_cache(cache, model.encode(args["frames"]))
            p3 = args.get("positions_3d")
            steps = torch.stack([model.decode_step(
                cache, toks[:, t], t,
                positions_3d=None if p3 is None else p3[:, :, t:t + 1])
                for t in range(48)], dim=1)
        return logits.cpu().double(), steps.cpu().double()

    for got, want in zip(run(card, cuda_device), run(cpu, "cpu")):
        rms = want.pow(2).mean(dim=-1, keepdim=True).sqrt()
        bound = logit_tolerance(cfg, rms, want.numel())
        assert bool(torch.isfinite(got).all())
        worst = float(((got - want).abs() - bound).max())
        assert worst <= 0, f"{arch}: exceeds the bf16 bound by {worst:.3e}"
    assert kernels.launch_counts() == before
    toks = batch["tokens"].to(cuda_device)
    enc, fkw = None, {}
    if cfg.family == "encdec":
        fkw["frames"] = kw["frames"].to(cuda_device)
        with torch.inference_mode():
            enc = card.encode(fkw["frames"])
    if cfg.mrope:
        fkw["positions_3d"] = kw["positions_3d"].to(cuda_device)
    got = decode_check.compare(
        card, decode_check.forward_trace(card, toks, **fkw),
        decode_check.decode_trace(card, toks, 64, enc_out=enc,
                                  positions_3d=fkw.get("positions_3d")))
    assert got["ok"], got
