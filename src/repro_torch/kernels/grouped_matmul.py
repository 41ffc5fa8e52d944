"""Grouped matmul: the MoE expert FFN as a block-diagonal SpMM (CUDA kernel).

The counterpart of the reference's ``grouped_matmul_pallas``.  After the
routed tokens are sorted by expert and each expert's rows are padded to
whole blocks of ``bm`` rows (``repro_torch.launch.moe_block``), the expert
FFN is an SpMM whose A is block-diagonal with dense blocks, the best case
of the blocked regime (z = t):

    out[i*bm:(i+1)*bm] = x[i*bm:(i+1)*bm] @ w[group_ids[i]]

:func:`grouped_matmul` launches the hand-written kernel
``csrc/grouped_matmul.cu`` for CUDA operands (fp32 FMA on CUDA cores for
float32; for bfloat16, ``wgmma`` fed by a ring of TMA loads, 128-row tiles
where ``bm % 128 == 0`` and 64-row tiles otherwise; fp32 accumulators
either way) and takes the plain PyTorch version
:func:`grouped_matmul_plain` for CPU operands.  Products are exact in fp32,
sums run in fp32 and the output is cast once to x's dtype, as the
reference's ``preferred_element_type=float32``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.csr_spmm import value_code

#: Kernel launches made by :func:`grouped_matmul` (a plain counter).
LAUNCHES = 0

#: What the CUDA kernels tile by: bm, N and K must divide by these (the
#: bf16 kernel's smallest row tile, its output columns per block and its
#: k step; a row tile must not straddle two row blocks).
TILE_M, TILE_N, TILE_K = 64, 128, 64


def tile_rows(dtype: torch.dtype, bm: int) -> int:
    """Rows of x per output tile of the CUDA kernel: 128 for bf16 where
    ``bm % 128 == 0``, else :data:`TILE_M`."""
    return 128 if dtype == torch.bfloat16 and bm % 128 == 0 else TILE_M


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         group_ids: torch.Tensor, *, bm: int
                         ) -> torch.Tensor:
    """The plain PyTorch version: one fp32 product per run of row blocks
    that share an expert, cast once to x's dtype."""
    T, N = x.shape[0], w.shape[2]
    out = torch.empty(T, N, dtype=x.dtype, device=x.device)
    gids = group_ids.to("cpu", torch.int64).numpy()
    starts = np.flatnonzero(np.diff(gids, prepend=-1))
    for s, e in zip(starts, np.append(starts[1:], gids.shape[0])):
        rows = slice(int(s) * bm, int(e) * bm)
        out[rows] = (x[rows].float() @ w[int(gids[s])].float()).to(x.dtype)
    return out


_P = ctypes.c_void_p
_ARGTYPES = (ctypes.c_int, _P, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)


def _kernel():
    fn = build.library("grouped_matmul").grouped_matmul_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def _check_cuda_operands(x, w, group_ids, bm: int) -> None:
    T, K = x.shape
    N = w.shape[2]
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"grouped_matmul: x and w must share float32 or "
                        f"bfloat16, got {x.dtype} and {w.dtype}")
    if group_ids.dtype != torch.int32 or group_ids.shape != (T // bm,):
        raise TypeError(f"grouped_matmul: group_ids must be int32 "
                        f"[{T // bm}], got {group_ids.dtype} "
                        f"{tuple(group_ids.shape)}")
    for t in (x, w, group_ids):
        if t.device != x.device:
            raise ValueError(f"grouped_matmul: operands on {t.device} and "
                             f"{x.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("grouped_matmul: operands must be contiguous "
                             "and 16-byte aligned")
    if bm % TILE_M or K % TILE_K or N % TILE_N:
        raise ValueError(f"the grouped_matmul kernel needs bm % {TILE_M}, "
                         f"K % {TILE_K} and N % {TILE_N} to be 0, got "
                         f"bm={bm}, K={K}, N={N}")


def check_group_ids(group_ids: torch.Tensor, num_experts: int) -> None:
    """Raise ``ValueError`` unless every id lies in ``[0, num_experts)``.

    It reads the ids back to the host, so it runs once per bound operand
    (the ``("grouped", "cuda")`` spec's ``prepare``), not per launch: the
    kernel indexes ``w`` by the ids unchecked.
    """
    if group_ids.numel():
        lo, hi = torch.aminmax(group_ids)
        if int(lo) < 0 or int(hi) >= num_experts:
            raise ValueError(f"grouped_matmul: group ids outside "
                             f"[0, {num_experts})")


def grouped_matmul_cuda(x: torch.Tensor, w: torch.Tensor,
                        group_ids: torch.Tensor, *, bm: int) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/grouped_matmul.cu``)."""
    global LAUNCHES
    _check_cuda_operands(x, w, group_ids, bm)
    T, K = x.shape
    N = w.shape[2]
    out = torch.empty(T, N, dtype=x.dtype, device=x.device)
    if T == 0:
        return out
    err = _kernel()(value_code(x.dtype), build.ptr(group_ids), build.ptr(x),
                    build.ptr(w), build.ptr(out), T, K, N, w.shape[0], bm,
                    build.stream_ptr(x.device))
    LAUNCHES += 1
    build.check(err, "grouped_matmul")
    return out


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_ids: torch.Tensor, *, bm: int = 128, bk: int = 128,
                   bn: int = 128) -> torch.Tensor:
    """``out[r] = x[r] @ w[group_ids[r // bm]]``: the CUDA kernel for CUDA
    operands, :func:`grouped_matmul_plain` for CPU ones.

    Args:
        x: ``[T, K]`` expert-sorted, block-aligned rows (float32 or
            bfloat16).
        w: ``[E, K, N]`` expert weights in x's dtype.
        group_ids: ``[T // bm]`` int32 expert of each row block, each in
            ``[0, E)``; the kernel does not check them
            (:func:`check_group_ids` does, once per operand).
        bm, bk, bn: the reference's tiles; T, K and N must divide by them.

    Returns:
        ``[T, N]`` in x's dtype.

    Raises:
        ValueError: when a shape does not divide by its tile, or the
            operands lie on another device than the CUDA or the CPU.
    """
    T, K = x.shape
    E, K2, N = w.shape
    if K != K2:
        raise ValueError(f"grouped_matmul: x has K={K}, w has K={K2}")
    if T % bm or K % bk or N % bn:
        raise ValueError(f"shapes ({T},{K},{N}) not divisible by tiles "
                         f"({bm},{bk},{bn})")
    if x.device.type == "cuda":
        return grouped_matmul_cuda(x, w, group_ids, bm=bm)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, group_ids, bm=bm)
    raise ValueError(f"grouped_matmul runs on CUDA or the CPU, not "
                     f"{x.device}")
