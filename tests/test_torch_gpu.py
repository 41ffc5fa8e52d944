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

import types

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.patterns import COOMatrix, banded, serving_suite
from repro_torch.core.precision import as_precision
from repro_torch.kernels import registry
from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                grouped_matmul_plain)
from repro_torch.kernels.rowsplit_spmm import (rowsplit_partials_cuda,
                                               rowsplit_partials_plain)
from repro_torch.launch import moe_block
from repro_torch.sparse.formats import coo_to_dense

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
def test_grouped_kernel_refuses_what_it_does_not_tile(cuda_device):
    x = torch.zeros(128, 80, device=cuda_device)
    w = torch.zeros(2, 80, 128, device=cuda_device)
    gids = torch.zeros(4, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="K % 32"):
        grouped_matmul(x, w, gids, bm=32, bk=16)
    # The ids are checked once, when the spec binds its operand.
    with pytest.raises(ValueError, match="group ids"):
        registry.get("grouped", "cuda").bind(
            (torch.zeros(1, 128, 128, device=cuda_device), gids[:1] + 1, 128,
             128, 128), registry.KernelContext(device=cuda_device))
