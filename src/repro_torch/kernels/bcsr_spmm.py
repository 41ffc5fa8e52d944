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
  ``cp.async``, true fp32 FMA from a register tile (no TF32); where the
  layout carries its :func:`quadrant_mask` (:func:`with_quadrants`, as the
  ``cuda`` prepare packs it), a pair copies and multiplies only the 32 x 32
  quadrants of A that hold a nonzero and the B rows they read;
* ``wgmma_bf16`` (t = 64, bfloat16, d % 8 == 0): the same walk with TMA
  loads into an mbarrier ring feeding ``wgmma.m64n64k16``;
* ``generic`` (any other t <= 128 or d): one block per (block row,
  32-column slice), fp32 FMA from shared memory.

Block products are exact in fp32 (no rounding at the operand dtype, as
with the reference's ``preferred_element_type=float32``); C is cast once.
A skipped quadrant holds only zeros, and ``fmaf(0, b, acc) == acc`` for
finite b, so the mask leaves C bitwise as it was.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.core import trace
from repro_torch.kernels import build
from repro_torch.kernels.csr_spmm import check_operands, value_code
from repro_torch.sparse.spmm import bcsr_spmm as _torch_bcsr_spmm

#: Kernel launches made by :func:`bcsr_spmm` (a plain counter).
LAUNCHES = 0

#: The kernel variants, in the order of their codes in ``csrc/bcsr_spmm.cu``.
VARIANTS = ("generic", "tile64_f32", "wgmma_bf16")

#: Launches by variant (the same launches as :data:`LAUNCHES`).
LAUNCHES_BY_VARIANT = dict.fromkeys(VARIANTS, 0)

#: ``tile64_f32`` launches that were given a quadrant mask.
LAUNCHES_MASKED = 0

#: Largest block edge the generic kernel holds in shared memory.
MAX_T = 128

#: Block edge of the kernels that read a quadrant mask.
MASK_T = 64

#: Blocks whose quadrants :func:`quadrant_mask` tests at once: the
#: temporary stays at 16 MB of booleans at t = 64.
QUADRANT_CHUNK = 4096

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


def quadrant_mask(blocks: torch.Tensor) -> torch.Tensor:
    """The occupancy of each block's four quadrants, on ``blocks``' device.

    Args:
        blocks: ``[N, t, t]`` block values, t even.

    Returns:
        ``[N]`` uint8: bit ``2 * rh + kh`` set where the t/2 x t/2 quadrant
        of row half rh and column half kh holds a value that is not zero
        (a NaN counts as held).
    """
    num, t = blocks.shape[0], blocks.shape[1]
    if t % 2:
        raise ValueError(f"quadrant_mask: block edge t={t} is odd")
    h = t // 2
    weights = torch.tensor([1, 2, 4, 8], dtype=torch.uint8,
                           device=blocks.device)
    out = torch.empty(num, dtype=torch.uint8, device=blocks.device)
    for lo in range(0, num, QUADRANT_CHUNK):
        held = blocks[lo:lo + QUADRANT_CHUNK].reshape(-1, 2, h, 2, h).ne(0)
        held = held.any(4).any(2).reshape(-1, 4)      # [c, (rh, kh)]
        out[lo:lo + QUADRANT_CHUNK] = (held * weights).sum(1)
    return out


def with_quadrants(a):
    """BCSR layout ``a`` with its :func:`quadrant_mask` at t = 64 (the
    kernels that read one); ``a`` itself at any other t.

    Under a set-up root (the pack) the mask is the span
    ``spmm.pack.quadrants``, with the count of blocks and of quadrants
    held.
    """
    if a.t != MASK_T:
        return a
    if not trace.in_setup():
        return dataclasses.replace(a, quadrants=quadrant_mask(a.blocks))
    with trace.span("spmm.pack.quadrants") as span:
        mask = quadrant_mask(a.blocks)
        bits = torch.arange(4, dtype=torch.uint8, device=mask.device)
        span.attrs.update(blocks=a.num_blocks, quadrants=int(
            ((mask[:, None] >> bits) & 1).sum()))
    return dataclasses.replace(a, quadrants=mask)


_P = ctypes.c_void_p
_ARGTYPES = (ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, _P)


def _kernel():
    fn = build.library("bcsr_spmm").bcsr_spmm_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def bcsr_spmm_cuda(a, b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel :func:`bcsr_variant` names on a CUDA operand, with
    the layout's quadrant mask where it has one (``tile64_f32`` reads it;
    the other variants do every quadrant's work)."""
    global LAUNCHES, LAUNCHES_MASKED
    traced = trace.recording()
    if traced:
        t_check = trace.now()
    if not 1 <= a.t <= MAX_T:
        raise ValueError(f"bcsr_spmm: block edge t={a.t} outside "
                         f"[1, {MAX_T}]")
    mask = a.quadrants
    check_operands("bcsr_spmm", (a.block_ptr, a.block_cols, a.blocks,
                                 *(() if mask is None else (mask,))), b,
                   a.blocks)
    if mask is not None and (mask.dtype != torch.uint8
                             or tuple(mask.shape) != (a.num_blocks,)):
        raise ValueError(f"bcsr_spmm: the quadrant mask must be uint8 "
                         f"[{a.num_blocks}], got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    if b.shape[0] != a.n or a.n % a.t:
        raise ValueError(f"bcsr_spmm: b has {b.shape[0]} rows, the matrix "
                         f"{a.n} in blocks of {a.t}")
    d = b.shape[1]
    variant = bcsr_variant(a.t, d, b.dtype)
    masked = variant == "tile64_f32" and mask is not None
    if traced:
        t_alloc = trace.now()
    c = torch.empty(a.n, d, dtype=b.dtype, device=b.device)
    if traced:
        t_launch = trace.now()
    if variant != "generic" and any(x.data_ptr() % 16
                                    for x in (a.blocks, b, c)):
        raise ValueError(f"bcsr_spmm: the {variant} kernel copies 16-byte "
                         f"chunks and needs 16-byte aligned operands")
    err = _kernel()(VARIANTS.index(variant), value_code(b.dtype),
                    build.ptr(a.block_ptr), build.ptr(a.block_cols),
                    build.ptr(mask) if masked else None,
                    build.ptr(a.blocks), build.ptr(b), build.ptr(c), a.nb,
                    a.num_blocks, a.t, d, build.stream_ptr(b.device))
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    LAUNCHES_MASKED += masked
    if traced:
        trace.record_launch(t_check, t_alloc, t_launch)
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
