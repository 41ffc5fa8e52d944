"""The CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips when ``torch.cuda.is_available()``
is false (decided in a fixture, never at import).  The file imports neither
``jax`` nor the reference package, so it runs on a GPU host that has only
PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Each kernel runs at every precision its spec declares, on the serving-suite
structure of its regime, at small n (the full-size check is
``chip_smoke.py``).  Tolerance: ``4 * eps * (|A| @ |B|) + ATOL + RTOL * |C|``
per side, the sum of both sides for two computed results.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.patterns import banded, serving_suite
from repro_torch.core.precision import as_precision
from repro_torch.kernels import registry
from repro_torch.sparse.formats import coo_to_dense

RTOL = ATOL = 5e-4

#: format -> (kernel name, serving-suite structure of its regime).
KERNEL_OF = {"csr": ("csr_spmm", "uniform"),
             "ell_coo": ("csr_spmm", "scale-free"),
             "binned": ("binned_spmm", "scale-free"),
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
    for fmt in ("csr", "binned", "bcsr"):
        _run(m, fmt, "f32i32", cuda_device, d=d)
