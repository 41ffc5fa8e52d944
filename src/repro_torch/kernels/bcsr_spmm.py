"""BCSR (dense t x t block) SpMM (CUDA kernels).

The counterpart of the reference's ``bcsr_spmm_pallas``.  A is a
:class:`~repro_torch.sparse.formats.BCSRMatrix` whose every block row
owns at least one block (``registry.pad_empty_block_rows``).
:func:`bcsr_spmm` runs ``C = A @ B``: for a CUDA operand, the kernel of
``csrc/bcsr_spmm.cu`` that :func:`bcsr_variant` names for the shape;
for a CPU operand, the plain PyTorch version :func:`bcsr_spmm_plain`.

The variants:

* ``tile64_f32`` (t = 64, float32, d % 4 == 0): persistent blocks walk
  block rows as one ring of (A block, B tile) pairs staged by
  ``cp.async``, true fp32 FMA from a register tile (no TF32);
* ``wgmma_bf16`` (t = 64, bfloat16, d % 8 == 0): the same walk with TMA
  loads into an mbarrier ring feeding ``wgmma.m64n64k16``;
* ``generic`` (any other t <= 128 or d): one block per (block row,
  32-column slice), fp32 FMA from shared memory.

Block products are exact in fp32 (no rounding at the operand dtype, as
with the reference's ``preferred_element_type=float32``); C is cast once.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.csr_spmm import check_operands, value_code
from repro_torch.sparse.spmm import bcsr_spmm as _torch_bcsr_spmm

#: Kernel launches made by :func:`bcsr_spmm` (a plain counter).
LAUNCHES = 0

#: The kernel variants, in the order of their codes in ``csrc/bcsr_spmm.cu``.
VARIANTS = ("generic", "tile64_f32", "wgmma_bf16")

#: Launches by variant (the same launches as :data:`LAUNCHES`).
LAUNCHES_BY_VARIANT = dict.fromkeys(VARIANTS, 0)

#: Largest block edge the generic kernel holds in shared memory.
MAX_T = 128

#: The plain PyTorch version of the kernel on the same layout: the
#: ``torch`` backend's BCSR implementation (fp32 block products summed into
#: their block rows, one cast at the end).
bcsr_spmm_plain = _torch_bcsr_spmm


def bcsr_variant(t: int, d: int, dtype: torch.dtype) -> str:
    """The kernel a CUDA operand of block edge ``t``, width ``d`` and value
    type ``dtype`` launches: ``"tile64_f32"`` at t = 64, float32 and
    d % 4 == 0 (16-byte copies of B rows); ``"wgmma_bf16"`` at t = 64,
    bfloat16 and d % 8 == 0 (the TMA map's 16-byte row stride); else
    ``"generic"``."""
    if t == 64 and dtype == torch.float32 and d % 4 == 0:
        return "tile64_f32"
    if t == 64 and dtype == torch.bfloat16 and d % 8 == 0:
        return "wgmma_bf16"
    return "generic"


_P = ctypes.c_void_p
_ARGTYPES = (ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, _P)


def _kernel():
    fn = build.library("bcsr_spmm").bcsr_spmm_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def bcsr_spmm_cuda(a, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel :func:`bcsr_variant` names on a CUDA operand."""
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
    variant = bcsr_variant(a.t, d, b.dtype)
    c = torch.empty(a.n, d, dtype=b.dtype, device=b.device)
    if variant != "generic" and any(x.data_ptr() % 16
                                    for x in (a.blocks, b, c)):
        raise ValueError(f"bcsr_spmm: the {variant} kernel copies 16-byte "
                         f"chunks and needs 16-byte aligned operands")
    err = _kernel()(VARIANTS.index(variant), value_code(b.dtype),
                    build.ptr(a.block_ptr), build.ptr(a.block_cols),
                    build.ptr(a.blocks), build.ptr(b), build.ptr(c), a.nb,
                    a.num_blocks, a.t, d, build.stream_ptr(b.device))
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    build.check(err, f"bcsr_spmm ({variant})")
    return c


def bcsr_spmm(a, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` for a padded BCSR matrix: the CUDA kernel that
    :func:`bcsr_variant` names for a CUDA operand, :func:`bcsr_spmm_plain`
    for a CPU one.

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
