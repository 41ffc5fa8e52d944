"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips when ``torch.cuda.is_available()``
is false (decided in a fixture, never at import).  The file imports neither
``jax`` nor the reference package, so it runs on a GPU host that has only
PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each SpMM kernel runs at every precision its spec declares, on the
serving-suite structure of its regime, at small n; the grouped matmul runs
at fp32 and bf16 on routed tokens (the full-size check is
``chip_smoke.py``).  Tolerance: ``4 * eps * (|A| @ |B|) + ATOL + RTOL * |C|``
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
from repro_torch.core.patterns import COOMatrix, banded, serving_suite
from repro_torch.core.precision import as_precision
from repro_torch.kernels import registry
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
from repro_torch.kernels.rowsplit_spmm import (rowsplit_partials_cuda,
                                               rowsplit_partials_plain)
from repro_torch.launch import moe_block
from repro_torch.sparse.formats import coo_to_dense, csr_host_arrays

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
    assert kernels.launch_counts()[name] == before + 1
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


@pytest.mark.gpu
@pytest.mark.parametrize("structure", ["skew", "scale-free"])
def test_rowsplit_kernel_writes_every_window_slot(cuda_device, structure):
    """Slots past a chunk's last row map to real rows of later chunks, so
    the kernel must write them as zeros (its partials are torch.empty)."""
    m = _skewed() if structure == "skew" else \
        serving_suite(1024)["scale-free"]()
    ctx = registry.KernelContext(plan_d=40, device=cuda_device)
    layout = registry.get("rowsplit", "cuda").prepare(m, ctx)
    b = torch.from_numpy(np.random.default_rng(1).normal(
        size=(m.n, 40)).astype(np.float32)).to(cuda_device)
    torch.full((layout.num_chunks * layout.window, 40), float("nan"),
               device=cuda_device)      # leave garbage in the cache
    got = rowsplit_partials_cuda(layout, b)
    ref = rowsplit_partials_plain(layout, b)
    torch.cuda.synchronize()
    used = torch.zeros(layout.num_chunks, layout.window, dtype=torch.bool,
                       device=cuda_device)
    used.scatter_(1, layout.slots.long(), True)
    unused = ~used.reshape(-1)
    assert bool((got[unused] == 0).all()), "an unused slot was not zeroed"
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    _run(m, "rowsplit", "bf16i16", cuda_device, d=40)


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


@pytest.mark.gpu
@pytest.mark.parametrize("bm", [64, 128])
@pytest.mark.parametrize("K", [192, 256])
def test_grouped_bf16_kernel_with_a_padding_only_expert(cuda_device, bm, K):
    """Expert 1's only row block is padding (zero rows) and must come out
    zero; K = 192 is a multiple of the 64-deep k step but not of 128, so
    the kernel wrapper is called directly (the reference's bk is 128)."""
    rng = np.random.default_rng(bm + K)
    E, N = 4, 384
    gids = torch.tensor([0, 0, 1, 2, 3, 3, 3, 0], dtype=torch.int32,
                        device=cuda_device)
    x = rng.normal(size=(gids.numel() * bm, K)).astype(np.float32)
    x[2 * bm:3 * bm] = 0.0
    x = torch.from_numpy(x).to(cuda_device, torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(E, K, N)).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
    before = kernels.launch_counts()["grouped_matmul"]
    got = grouped_matmul_cuda(x, w, gids, bm=bm)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["grouped_matmul"] == before + 1
    ref = grouped_matmul_plain(x, w, gids, bm=bm)
    absprod = grouped_matmul_plain(x.abs().float(), w.abs().float(), gids,
                                   bm=bm)
    g, r = got.double(), ref.double()
    assert bool(torch.isfinite(g).all())
    bound = moe_block.grouped_tolerance(absprod.double(), x.dtype, g, r)
    worst = float((g - r).abs().sub(bound).max())
    assert worst <= 0, f"grouped bf16 bm={bm} K={K}: exceeds by {worst:.3e}"
    assert not bool(got[2 * bm:3 * bm].any())


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
