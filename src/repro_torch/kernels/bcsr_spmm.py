"""BCSR (dense t x t block) SpMM (CUDA kernel).

The counterpart of the reference's ``bcsr_spmm_pallas``.  A is a
:class:`~repro_torch.sparse.formats.BCSRMatrix` whose every block row
owns at least one block (``registry.pad_empty_block_rows``).
:func:`bcsr_spmm` runs ``C = A @ B``: the hand-written kernel
``csrc/bcsr_spmm.cu`` for a CUDA operand (one thread block per block row
and 32-column slice, fp32 FMA on CUDA cores), the plain PyTorch version
:func:`bcsr_spmm_plain` for a CPU operand.  Block products are exact in
fp32 (no rounding at the operand dtype, as with the reference's
``preferred_element_type=float32``); C is cast once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.csr_spmm import check_operands, value_code
from repro_torch.sparse.spmm import bcsr_spmm as _torch_bcsr_spmm

#: Kernel launches made by :func:`bcsr_spmm` (a plain counter).
LAUNCHES = 0

#: Largest block edge the kernel holds in shared memory.
MAX_T = 128

#: The plain PyTorch version of the kernel on the same layout: the
#: ``torch`` backend's BCSR implementation (fp32 block products summed into
#: their block rows, one cast at the end).
bcsr_spmm_plain = _torch_bcsr_spmm


_P = ctypes.c_void_p
_ARGTYPES = (ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, _P)


def _kernel():
    fn = build.library("bcsr_spmm").bcsr_spmm_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def bcsr_spmm_cuda(a, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/bcsr_spmm.cu``) on a CUDA operand."""
    global LAUNCHES
    if not 1 <= a.t <= MAX_T:
        raise ValueError(f"bcsr_spmm: block edge t={a.t} outside "
                         f"[1, {MAX_T}]")
    check_operands("bcsr_spmm", (a.block_ptr, a.block_cols, a.blocks), b,
                   a.blocks)
    if b.shape[0] != a.n or a.n % a.t:
        raise ValueError(f"bcsr_spmm: b has {b.shape[0]} rows, the matrix "
                         f"{a.n} in blocks of {a.t}")
    d = b.shape[1]
    c = torch.empty(a.n, d, dtype=b.dtype, device=b.device)
    err = _kernel()(value_code(b.dtype), build.ptr(a.block_ptr),
                    build.ptr(a.block_cols), build.ptr(a.blocks),
                    build.ptr(b), build.ptr(c), a.nb, a.t, d,
                    build.stream_ptr(b.device))
    LAUNCHES += 1
    build.check(err, "bcsr_spmm")
    return c


def bcsr_spmm(a, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` for a padded BCSR matrix: the CUDA kernel for a CUDA
    operand, :func:`bcsr_spmm_plain` for a CPU one.

    Args:
        a: BCSR matrix with every block row non-empty, on ``b``'s device.
        b: ``[n, d]`` float32 or bfloat16, the blocks' dtype.

    Returns:
        ``C`` as ``[n, d]`` in ``b``'s dtype.
    """
    if b.device.type == "cuda":
        return bcsr_spmm_cuda(a, b)
    if b.device.type == "cpu":
        return bcsr_spmm_plain(a, b)
    raise ValueError(f"bcsr_spmm runs on CUDA or the CPU, not {b.device}")
