"""Grouped matmul: the MoE expert FFN as a block-diagonal SpMM (CUDA kernel).

The counterpart of the reference's ``grouped_matmul_pallas``.  After the
routed tokens are sorted by expert and each expert's rows are padded to
whole blocks of ``bm`` rows (``repro_torch.launch.moe_block``), the expert
FFN is an SpMM whose A is block-diagonal with dense blocks, the best case
of the blocked regime (z = t):

    out[i*bm:(i+1)*bm] = x[i*bm:(i+1)*bm] @ w[group_ids[i]]

:func:`grouped_matmul` launches the hand-written kernel
``csrc/grouped_matmul.cu`` for CUDA operands (for float32 a
double-buffered register-tiled SGEMM, true fp32 FMA on the CUDA cores; for
bfloat16, ``wgmma`` fed by a ring of TMA loads; 128-row tiles where
``bm % 128 == 0`` and 64-row tiles otherwise, fp32 accumulators either
way) and takes the plain PyTorch version
:func:`grouped_matmul_plain` for CPU operands.  Products are exact in fp32,
sums run in fp32 and the output is cast once to x's dtype, as the
reference's ``preferred_element_type=float32``.  Operands on the
``meta`` device (the dry run, ``launch.dryrun``) take a shape-only path
that gives ``[T, N]`` and launches nothing; any other device raises.

Where an operand requires a gradient, :func:`grouped_matmul` goes through
:class:`GroupedMatmulFn`.  Its input gradient is a grouped product of the
same form, ``dx = dout @ w[g]^T``, launched on the same kernel with the
weights transposed into a copy (``[E, N, K]``).  Its weight gradient
``dw[e] = sum over the blocks i of expert e of x_i^T dout_i`` is a plain
batched product (``torch.bmm``, as the reference leaves the gradient of
its expert einsum to XLA) and needs the MoE layout: expert-major blocks
in equal runs of ``expert_rows`` rows each, which the caller states
(``MoE.expert_ffn``); without it the weight gradient raises.  The reference's
Pallas kernel has no backward, so no second kernel is owed.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.csr_spmm import value_code

#: Kernel launches made by :func:`grouped_matmul` (a plain counter).
LAUNCHES = 0

#: The step counter (``core.step_cost``) while one is counting, else None:
#: each grouped product reports itself to it as one op,
#: ``OBSERVER.grouped(x, w, out)``, whatever device it ran on, and the
#: counter ignores the ops the product issues inside
#: ``OBSERVER.opaque()``.
OBSERVER = None

#: What the CUDA kernels tile by: bm, N and K must divide by these (the
#: bf16 kernel's smallest row tile, its output columns per block and its
#: k step; a row tile must not straddle two row blocks).
TILE_M, TILE_N, TILE_K = 64, 128, 64


def tile_rows(bm: int) -> int:
    """Rows of x per output tile of the CUDA kernel, at either dtype: 128
    where ``bm % 128 == 0``, else :data:`TILE_M`."""
    return 128 if bm % 128 == 0 else TILE_M


def grouped_matmul_plain(x: torch.Tensor, w: torch.Tensor,
                         group_ids: torch.Tensor, *, bm: int,
                         bk: Optional[int] = None,
                         bn: Optional[int] = None,
                         expert_rows: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version: one fp32 product per run of row blocks
    that share an expert, cast once to x's dtype.  ``bk``, ``bn`` and
    ``expert_rows``, where given, are checked as :func:`grouped_matmul`
    checks them, so either function can be passed where the other is
    expected (its autograd takes any layout)."""
    if bk is not None or bn is not None:
        _check_tiles(x, w, bm, bk or 1, bn or 1)
    if expert_rows is not None:
        _check_expert_rows(x, w, group_ids, bm, expert_rows)
    T, N = x.shape[0], w.shape[2]
    out = torch.empty(T, N, dtype=x.dtype, device=x.device)
    gids = group_ids.to("cpu", torch.int64).numpy()
    starts = np.flatnonzero(np.diff(gids, prepend=-1))
    for s, e in zip(starts, np.append(starts[1:], gids.shape[0])):
        rows = slice(int(s) * bm, int(e) * bm)
        out[rows] = (x[rows].float() @ w[int(gids[s])].float()).to(x.dtype)
    return out


def _check_tiles(x: torch.Tensor, w: torch.Tensor, bm: int, bk: int,
                 bn: int) -> None:
    T, K = x.shape
    E, K2, N = w.shape
    if K != K2:
        raise ValueError(f"grouped_matmul: x has K={K}, w has K={K2}")
    if T % bm or K % bk or N % bn:
        raise ValueError(f"shapes ({T},{K},{N}) not divisible by tiles "
                         f"({bm},{bk},{bn})")


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
    kernel indexes ``w`` by the ids unchecked.  ``meta`` ids hold no values
    and are skipped: the dry run makes them by construction
    (``MoE.group_ids``).
    """
    if group_ids.numel() and group_ids.device.type != "meta":
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


def grouped_matmul_meta(x: torch.Tensor, w: torch.Tensor,
                        group_ids: torch.Tensor, *,
                        bm: int) -> torch.Tensor:
    """The shape-only path for ``meta`` operands: ``[T, N]`` in x's dtype,
    after the shape checks the kernel's wrapper makes."""
    T = x.shape[0]
    if w.device.type != "meta" or group_ids.shape != (T // bm,):
        raise ValueError(f"grouped_matmul on meta: w on {w.device}, "
                         f"{tuple(group_ids.shape)} ids for {T // bm} "
                         f"blocks")
    return torch.empty(T, w.shape[2], dtype=x.dtype, device="meta")


def _device_product(x, w, group_ids, bm: int) -> torch.Tensor:
    if x.device.type == "cuda":
        return grouped_matmul_cuda(x, w, group_ids, bm=bm)
    if x.device.type == "cpu":
        return grouped_matmul_plain(x, w, group_ids, bm=bm)
    if x.device.type == "meta":
        return grouped_matmul_meta(x, w, group_ids, bm=bm)
    raise ValueError(f"grouped_matmul runs on CUDA, the CPU or meta, not "
                     f"{x.device}")


def _grouped(x: torch.Tensor, w: torch.Tensor, group_ids: torch.Tensor,
             bm: int, bk: int, bn: int) -> torch.Tensor:
    """The product without autograd: the kernel, the plain version or the
    shape-only path; reported to :data:`OBSERVER` as one op."""
    _check_tiles(x, w, bm, bk, bn)
    obs = OBSERVER
    if obs is None:
        return _device_product(x, w, group_ids, bm)
    with obs.opaque():
        out = _device_product(x, w, group_ids, bm)
    obs.grouped(x, w, out)
    return out


def _check_expert_rows(x: torch.Tensor, w: torch.Tensor,
                       group_ids: torch.Tensor, bm: int,
                       expert_rows: int) -> None:
    """Raise ``ValueError`` unless the shapes fit the stated layout: each of
    w's E experts owns ``expert_rows`` rows of x, whole blocks of ``bm``."""
    e = w.shape[0]
    if expert_rows <= 0 or expert_rows % bm or \
            x.shape[0] != e * expert_rows or \
            group_ids.shape[0] != x.shape[0] // bm:
        raise ValueError(f"grouped_matmul: expert_rows={expert_rows} does "
                         f"not fit x {tuple(x.shape)}, {e} experts, bm={bm} "
                         f"and {group_ids.shape[0]} group ids")


class GroupedMatmulFn(torch.autograd.Function):
    """:func:`grouped_matmul` with a backward.

    ``dx = dout @ w[g]^T`` runs on the same kernel (CUDA operands) or the
    plain version (CPU ones), with ``w`` transposed into a contiguous
    ``[E, N, K]`` copy; its tiles are the forward's ``bn`` and ``bk``
    swapped.  ``dw`` is one ``torch.bmm`` over the ``[E, T / E, .]`` views
    in w's dtype, valid for the expert-major layout only: the caller states
    it by passing ``expert_rows`` (each expert's rows, whole blocks), and
    the weight gradient raises ``ValueError`` where it did not.
    Padding rows of x are zero and get zero ``dout`` from the combine, so
    their share of ``dw`` is exactly zero.
    """

    @staticmethod
    def forward(ctx, x, w, group_ids, bm: int, bk: int, bn: int,
                expert_rows: Optional[int] = None):
        if expert_rows is not None:
            _check_expert_rows(x, w, group_ids, bm, expert_rows)
        ctx.save_for_backward(x, w, group_ids)
        ctx.tiles = (bm, bk, bn)
        ctx.expert_rows = expert_rows
        return _grouped(x, w, group_ids, bm, bk, bn)

    @staticmethod
    def backward(ctx, dout):
        x, w, group_ids = ctx.saved_tensors
        bm, bk, bn = ctx.tiles
        dout = dout.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = _grouped(dout, w.transpose(1, 2).contiguous(), group_ids,
                          bm, bn, bk)
        if ctx.needs_input_grad[1]:
            if ctx.expert_rows is None:
                raise ValueError("grouped_matmul: the weight gradient needs "
                                 "expert-major group ids in equal runs "
                                 "(the MoE capacity buffer's layout), "
                                 "stated by expert_rows")
            e = w.shape[0]
            dw = torch.bmm(x.reshape(e, -1, x.shape[1]).transpose(1, 2),
                           dout.reshape(e, -1, dout.shape[1])).to(w.dtype)
        return dx, dw, None, None, None, None, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_ids: torch.Tensor, *, bm: int = 128, bk: int = 128,
                   bn: int = 128,
                   expert_rows: Optional[int] = None) -> torch.Tensor:
    """``out[r] = x[r] @ w[group_ids[r // bm]]``: the CUDA kernel for CUDA
    operands, :func:`grouped_matmul_plain` for CPU ones; through
    :class:`GroupedMatmulFn` where x or w requires a gradient.

    Args:
        x: ``[T, K]`` expert-sorted, block-aligned rows (float32 or
            bfloat16).
        w: ``[E, K, N]`` expert weights in x's dtype.
        group_ids: ``[T // bm]`` int32 expert of each row block, each in
            ``[0, E)``; the kernel does not check them
            (:func:`check_group_ids` does, once per operand).
        bm, bk, bn: the reference's tiles; T, K and N must divide by them.
        expert_rows: where given, the caller's statement that the ids are
            expert-major in equal runs of this many rows (the MoE capacity
            buffer's layout), which the weight gradient needs.

    Returns:
        ``[T, N]`` in x's dtype.

    Raises:
        ValueError: when a shape does not divide by its tile or does not
            fit ``expert_rows``, or the operands lie on another device than
            the CUDA or the CPU.
    """
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return GroupedMatmulFn.apply(x, w, group_ids, bm, bk, bn,
                                     expert_rows)
    return _grouped(x, w, group_ids, bm, bk, bn)
