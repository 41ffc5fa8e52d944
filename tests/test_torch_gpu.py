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
                                       serving_suite)
from repro_torch.core.precision import as_precision
from repro_torch.kernels import bcsr_spmm as bcsr_module
from repro_torch.kernels import registry
from repro_torch.kernels.bcsr_spmm import (bcsr_spmm, bcsr_spmm_plain,
                                           bcsr_variant)
from repro_torch.kernels.binned_spmm import (binned_spmm,
                                             binned_spmm_plain,
                                             csr_to_slab_bins,
                                             slab_bin_layout)
from repro_torch.kernels.csr_spmm import (csr_spmm, csr_spmm_plain,
                                          csr_to_row_tiles, row_tile_layout,
                                          with_work_list)
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
    """t = pallas_band_tile(n) is 1, 2, 4 and 128 here."""
    _run(banded(n, 3, fill=0.9, seed=n), "dia", "f32i32", cuda_device, d=40)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [1, 31, 33, 200])
def test_row_tile_kernels_at_ragged_widths(cuda_device, d):
    """Column slices that do not fill a warp or a 128-column block."""
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
    got = kernel(layout, b)
    torch.cuda.synchronize()
    assert kernels.launch_counts()[f"{fmt}_spmm"] == before + 1
    _sparse_check(m, got, plain(layout, b), b, prec.eps,
                  f"{fmt}/{token} n={m.n}")
    return layout, got


@pytest.mark.gpu
@pytest.mark.parametrize("d", [40, 200])
@pytest.mark.parametrize("token", ["f32i32", "bf16i32", "bf16i16"])
@pytest.mark.parametrize("fmt", ["csr", "binned"])
def test_row_tile_kernels_split_a_long_hub_row(cuda_device, fmt, token, d):
    """A hub row of 50,000 nonzeros (30,000 at bf16i16, whose layouts
    need n <= 32,767) next to singleton rows, cut into pieces of at most
    256 real entries that run in parallel; at d = 200 four column slices
    of a split tile add into the same rows."""
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
@pytest.mark.parametrize("token", ["f32i32", "bf16i32"])
@pytest.mark.parametrize("fmt", ["csr", "binned"])
def test_row_tile_kernels_write_every_row_of_a_dirty_buffer(cuda_device, fmt,
                                                           token):
    """C comes from torch.empty: with NaN left in the allocator's cache,
    every row must still be written, the empty tiles' rows as zeros."""
    m = _with_empty_tiles()
    _, got = _row_tile_case(m, fmt, token, cuda_device, b_tile=512,
                            poison=float("nan"))
    empty = torch.ones(m.n, dtype=torch.bool, device=cuda_device)
    empty[torch.from_numpy(m.rows.astype(np.int64)).to(cuda_device)] = False
    assert bool(empty.any()) and not bool(got[empty].any())


@pytest.mark.gpu
@pytest.mark.parametrize("token", ["f32i32", "bf16i32"])
@pytest.mark.parametrize("fmt", ["csr", "binned"])
def test_row_tile_kernels_keep_explicit_zeros_and_skip_padding(cuda_device,
                                                               fmt, token):
    """Explicit zero values are real entries (0 * inf is NaN, as in the
    plain version); padding slots are never read (NaN there changes
    nothing)."""
    m = _with_empty_tiles(zeros=True)
    layout, got = _row_tile_case(m, fmt, token, cuda_device, b_tile=512)
    pad = (torch.arange(layout.vals.shape[1], device=cuda_device)[None, :]
           >= layout.chunk_len[:, None])
    assert bool(pad.any())
    poisoned = dataclasses.replace(
        layout, vals=layout.vals.masked_fill(pad, float("nan")))
    b = torch.from_numpy(np.random.default_rng(2).normal(
        size=(m.n, 40)).astype(np.float32)).to(cuda_device,
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

    def __call__(self, x, w, gids, *, bm, bk, bn):
        out = grouped_matmul(x, w, gids, bm=bm, bk=bk, bn=bn)
        ref = grouped_matmul_plain(x, w, gids, bm=bm, bk=bk, bn=bn)
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
