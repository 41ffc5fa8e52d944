"""Row-split SpMM for the scale-free regime (CUDA kernel).

The counterpart of the reference's ``rowsplit_spmm_pallas``.  The host
packer :func:`pack_rowsplit_chunks` cuts the row-major nonzero stream into
chunks of exactly ``chunk`` entries, whatever the row degrees, so a hub row
spreads over many chunks instead of serialising one thread block.  Each
chunk owns a window of ``W`` rows: slot ``w`` of chunk ``c`` is global row
``row_map[c, w]``, or the sentinel ``n`` past the chunk's last row.

:func:`rowsplit_spmm` runs ``C = A @ B`` on a :class:`RowSplitLayout`: the
hand-written kernel ``csrc/rowsplit_spmm.cu`` writes one fp32 window
partial ``[W, d]`` per chunk, and an fp32 ``index_add_`` over ``row_map``
folds the partials into ``[n + 1, d]``; row ``n`` is dropped and C is cast
once.  A CPU operand takes the plain PyTorch version
:func:`rowsplit_spmm_plain`.  ``index_add_`` on a CUDA tensor sums with
atomics, so the order in which a row's partials are added, and the last
bits of C, can change from run to run.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.kernels import build
from repro_torch.kernels.csr_spmm import (
    accumulate_chunks, check_operands, index_code, index_extent_check,
    value_code)

#: Kernel launches made by :func:`rowsplit_spmm` (a plain counter).
LAUNCHES = 0


def pack_rowsplit_chunks(indptr: np.ndarray, indices: np.ndarray,
                         data: np.ndarray, *, n: int, chunk: int = 128,
                         index_dtype=np.int32
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                    np.ndarray]:
    """Cut the row-major nonzero stream into equal-``chunk`` work units.

    Returns ``(row_map[C, W], cols[C, chunk], row_slots[C, chunk],
    vals[C, chunk])``: slot ``w`` of chunk ``c`` is global row
    ``row_map[c, w]`` (the sentinel ``n`` past the chunk's last row), and
    ``W`` is the widest chunk's row span rounded up to a multiple of 8.
    Within a chunk the slots never decrease, and the padding repeats the
    last slot with value 0.  Columns are global, so int16 is legal only
    when ``n`` fits.  The arrays are byte-identical to the reference
    packer's.
    """
    indptr = np.asarray(indptr)
    indices = np.asarray(indices)
    data = np.asarray(data)
    index_extent_check(n, index_dtype)
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(indptr).astype(np.int64))
    num_chunks = max(1, -(-nnz // chunk))
    padded = num_chunks * chunk
    cols_p = np.zeros(padded, dtype=index_dtype)
    vals_p = np.zeros(padded, dtype=data.dtype)
    cols_p[:nnz] = indices[:nnz]
    vals_p[:nnz] = data[:nnz]
    nonempty = np.flatnonzero(np.diff(indptr) > 0).astype(np.int64)
    ranks = np.searchsorted(nonempty, rows)
    ranks_p = np.zeros(padded, dtype=np.int64)
    ranks_p[:nnz] = ranks
    ranks_p[nnz:] = ranks_p[nnz - 1] if nnz else 0
    ranks_c = ranks_p.reshape(num_chunks, chunk)
    rank_lo = ranks_c[:, 0]
    slots = (ranks_c - rank_lo[:, None]).astype(index_dtype)
    span = int((slots.max() + 1)) if nnz else 1
    window = max(8, -(-span // 8) * 8)
    flat = rank_lo[:, None] + np.arange(window)[None, :]
    row_map = np.where(flat < nonempty.shape[0],
                       nonempty[np.minimum(flat, nonempty.shape[0] - 1)]
                       if nonempty.shape[0] else 0,
                       n).astype(np.int32)
    if nonempty.shape[0] == 0:
        row_map[:] = n
    return (row_map, cols_p.reshape(num_chunks, chunk), slots,
            vals_p.reshape(num_chunks, chunk))


@dataclasses.dataclass(frozen=True)
class RowSplitLayout:
    """The packed operand of :func:`rowsplit_spmm`, on one device.

    The arrays are :func:`pack_rowsplit_chunks`'s, unchanged.  Build it
    with :func:`rowsplit_layout`, which checks the kernel's contract: the
    slots of every chunk never decrease and stay below ``window``.
    """

    row_map: torch.Tensor   # [C, W] int32 global row per slot, n = sentinel
    cols: torch.Tensor      # [C, chunk] int32 or int16, global columns
    slots: torch.Tensor     # [C, chunk] int32 or int16, window slots
    vals: torch.Tensor      # [C, chunk] float32 or bfloat16
    n: int
    window: int

    @property
    def num_chunks(self) -> int:
        """Number of equal-nnz chunks."""
        return int(self.cols.shape[0])

    @property
    def device(self) -> torch.device:
        """The device the layout lives on."""
        return self.vals.device


def rowsplit_layout(row_map, cols, slots, vals, *, n: int,
                    device=None) -> RowSplitLayout:
    """Move :func:`pack_rowsplit_chunks`'s arrays to ``device`` as a layout.

    Raises:
        ValueError: when a chunk's slots decrease or reach the window (the
            kernel flushes its accumulator on every slot change, so it
            needs them in order).
    """
    from repro_torch.sparse.formats import tensor_from_host
    row_map = np.asarray(row_map)
    slots = np.asarray(slots)
    window = int(row_map.shape[1])
    if slots.size and (np.any(np.diff(slots, axis=1) < 0)
                       or int(slots.min()) < 0
                       or int(slots.max()) >= window):
        raise ValueError("rowsplit layout: the slots of every chunk must "
                         f"be non-decreasing and in [0, {window})")
    return RowSplitLayout(
        row_map=tensor_from_host(row_map, device),
        cols=tensor_from_host(np.asarray(cols), device),
        slots=tensor_from_host(slots, device),
        vals=tensor_from_host(np.asarray(vals), device),
        n=n, window=window)


def fold_windows(layout: RowSplitLayout, partials: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """The epilogue: fp32 sum of the window partials per row through
    ``row_map``; the sentinel row ``n`` is dropped and C is cast once."""
    out = torch.zeros(layout.n + 1, partials.shape[1], dtype=torch.float32,
                      device=partials.device)
    out.index_add_(0, layout.row_map.reshape(-1).long(), partials)
    return out[:layout.n].to(dtype)


def rowsplit_partials_plain(layout: RowSplitLayout,
                            b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch kernel body: the fp32 window partials ``[C*W, d]``."""
    out = torch.zeros(layout.num_chunks * layout.window, b.shape[1],
                      dtype=torch.float32, device=b.device)
    owners = torch.arange(layout.num_chunks, dtype=torch.int32,
                          device=b.device)
    return accumulate_chunks(out, owners, torch.zeros_like(owners),
                             layout.cols, layout.slots, layout.vals, b,
                             b_tile=None, row_tile=layout.window)


def rowsplit_spmm_plain(layout: RowSplitLayout, b: torch.Tensor
                        ) -> torch.Tensor:
    """The plain PyTorch version of the row-split kernel on the same
    layout."""
    return fold_windows(layout, rowsplit_partials_plain(layout, b), b.dtype)


_P = ctypes.c_void_p
_ARGTYPES = (ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)


def _kernel():
    fn = build.library("rowsplit_spmm").rowsplit_spmm_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def rowsplit_partials_cuda(layout: RowSplitLayout,
                           b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/rowsplit_spmm.cu``): fp32 window
    partials ``[C*W, d]``, every slot written (zeros past a chunk's rows)."""
    global LAUNCHES
    check_operands("rowsplit_spmm", (layout.row_map, layout.cols,
                                     layout.slots, layout.vals),
                   b, layout.vals)
    if b.shape[0] != layout.n:
        raise ValueError(f"rowsplit_spmm: b has {b.shape[0]} rows, the "
                         f"layout {layout.n}")
    if layout.slots.dtype != layout.cols.dtype:
        raise TypeError("rowsplit_spmm: cols and slots must share a dtype")
    d = b.shape[1]
    partials = torch.empty(layout.num_chunks * layout.window, d,
                           dtype=torch.float32, device=b.device)
    err = _kernel()(value_code(b.dtype), index_code(layout.cols.dtype),
                    build.ptr(layout.cols), build.ptr(layout.slots),
                    build.ptr(layout.vals), build.ptr(b),
                    build.ptr(partials), layout.num_chunks, layout.window,
                    d, layout.cols.shape[1], build.stream_ptr(b.device))
    LAUNCHES += 1
    build.check(err, "rowsplit_spmm")
    return partials


def rowsplit_spmm(layout: RowSplitLayout, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` with A as equal-nnz chunks: the CUDA kernel plus the
    fold for a CUDA operand, :func:`rowsplit_spmm_plain` for a CPU one.

    Args:
        layout: the packed operand, on ``b``'s device.
        b: ``[n, d]`` float32 or bfloat16, the layout's value dtype.

    Returns:
        ``C`` as ``[n, d]`` in ``b``'s dtype.
    """
    if b.device.type == "cuda":
        return fold_windows(layout, rowsplit_partials_cuda(layout, b),
                            b.dtype)
    if b.device.type == "cpu":
        return rowsplit_spmm_plain(layout, b)
    raise ValueError(f"rowsplit_spmm runs on CUDA or the CPU, not {b.device}")
