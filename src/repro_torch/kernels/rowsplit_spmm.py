"""Row-split SpMM for the scale-free regime (CUDA kernel).

The counterpart of the reference's ``rowsplit_spmm_pallas``.  The host
packer :func:`pack_rowsplit_chunks` cuts the row-major nonzero stream into
chunks of exactly ``chunk`` entries, whatever the row degrees, so a hub row
spreads over many chunks instead of serialising one thread block.  Each
chunk owns a window of ``W`` rows: slot ``w`` of chunk ``c`` is global row
``row_map[c, w]``, or the sentinel ``n`` past the chunk's last row.

Only a chunk's first and last rows can be shared with its neighbours, so
:func:`rowsplit_carries` derives once per layout, beside the packer's
arrays: each chunk's last slot and which of its end rows are shared, the
rows that span more than one chunk (*carry rows*, with their chunk range),
and the rows with no entry.  :func:`rowsplit_spmm` runs ``C = A @ B`` on a
:class:`RowSplitLayout` with two launches of ``csrc/rowsplit_spmm.cu``: the
main kernel stores every row a chunk owns alone straight into C and the
fp32 sums of shared end rows into a ``[C, 2, d]`` carry buffer; the second
sums each carry row's carries in chunk order and writes the rows with no
entry as zeros.  Every sum runs in a fixed order, so C is the same bit for
bit from run to run.  A CPU operand takes the plain PyTorch version
:func:`rowsplit_spmm_plain`, the same carry-and-fix-up fold.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.kernels import build
from repro_torch.kernels.csr_spmm import (
    accumulate_chunks, check_operands, index_code, index_extent_check,
    value_code)

#: Kernel launches made by :func:`rowsplit_spmm` (a plain counter; one per
#: kernel, so a call with carry or empty rows counts two).
LAUNCHES = 0

#: Bits of ``RowSplitLayout.shared``: the chunk's first row continues the
#: previous chunk's last row; its last row continues into the next chunk.
HEAD_SHARED, TAIL_SHARED = 1, 2


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

    The first four arrays are :func:`pack_rowsplit_chunks`'s, unchanged;
    the rest are derived from them by :func:`rowsplit_carries`.  Build it
    with :func:`rowsplit_layout`, which checks the kernel's contract.
    """

    row_map: torch.Tensor   # [C, W] int32 global row per slot, n = sentinel
    cols: torch.Tensor      # [C, chunk] int32 or int16, global columns
    slots: torch.Tensor     # [C, chunk] int32 or int16, window slots
    vals: torch.Tensor      # [C, chunk] float32 or bfloat16
    last_slot: torch.Tensor     # [C] int32 slot of the chunk's last row
    shared: torch.Tensor        # [C] int32 HEAD_SHARED | TAIL_SHARED bits
    carry_rows: torch.Tensor    # [R] int32 rows that span several chunks
    carry_chunks: torch.Tensor  # [R, 2] int32 first and last chunk of each
    empty_rows: torch.Tensor    # [Z] int32 rows with no entry
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


def rowsplit_carries(row_map: np.ndarray, slots: np.ndarray, n: int
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]:
    """What the kernel needs to fold the chunks into C without partials.

    The stream is row-major and a chunk's slots rise by 0 or 1 from 0, so
    a row can be shared only between one chunk's last row and the next
    chunk's first.  The padding of the last chunk repeats its last slot,
    so ``slots[:, -1]`` is every chunk's last real slot.

    Returns ``(last_slot[C], shared[C], carry_rows[R], carry_chunks[R, 2],
    empty_rows[Z])``, all int32: ``shared`` holds :data:`HEAD_SHARED` and
    :data:`TAIL_SHARED` bits; carry row ``k`` spans chunks
    ``carry_chunks[k, 0]`` to ``carry_chunks[k, 1]`` inclusive; the rows
    with no entry are those ``row_map`` never names.
    """
    row_map = np.asarray(row_map)
    slots = np.asarray(slots)
    num_chunks = row_map.shape[0]
    last_slot = slots[:, -1].astype(np.int32)
    head = row_map[:, 0].astype(np.int64)
    tail = row_map[np.arange(num_chunks), last_slot].astype(np.int64)
    # link[i]: chunk i's last row is chunk i + 1's first.
    link = (tail[:-1] == head[1:]) & (tail[:-1] < n)
    shared = np.zeros(num_chunks, np.int32)
    shared[1:] |= np.where(link, HEAD_SHARED, 0).astype(np.int32)
    shared[:-1] |= np.where(link, TAIL_SHARED, 0).astype(np.int32)
    # A row spanning chunks c0..c1 owns the consecutive links c0..c1 - 1.
    links = np.flatnonzero(link)
    rows = tail[links]
    first = np.flatnonzero(np.diff(rows, prepend=-1))
    final = np.append(first[1:], links.shape[0])[:first.shape[0]] - 1
    carry_rows = rows[first].astype(np.int32)
    carry_chunks = np.stack([links[first], links[final] + 1],
                            axis=1).astype(np.int32)
    named = np.zeros(n + 1, dtype=bool)
    named[row_map.reshape(-1)] = True
    empty_rows = np.flatnonzero(~named[:n]).astype(np.int32)
    return last_slot, shared, carry_rows, carry_chunks, empty_rows


def rowsplit_layout(row_map, cols, slots, vals, *, n: int,
                    device=None) -> RowSplitLayout:
    """Move :func:`pack_rowsplit_chunks`'s arrays to ``device`` as a layout,
    with what :func:`rowsplit_carries` derives from them.

    Raises:
        ValueError: when a chunk's slots do not start at 0 and rise by 0
            or 1 (non-decreasing, no gaps) within the window, or
            ``row_map`` names a row outside ``[0, n]`` (the kernel stores
            rows by ``row_map``).
    """
    from repro_torch.sparse.formats import tensor_from_host
    row_map = np.asarray(row_map)
    slots = np.asarray(slots)
    window = int(row_map.shape[1])
    if slots.size:
        steps = np.diff(slots, axis=1)
        if (np.any(steps < 0) or np.any(steps > 1)
                or np.any(slots[:, 0] != 0)
                or int(slots.max()) >= window):
            raise ValueError("rowsplit layout: the slots of every chunk "
                             "must start at 0, be non-decreasing with no "
                             f"gaps, and stay below the window {window}")
    if row_map.size and (int(row_map.min()) < 0 or int(row_map.max()) > n):
        raise ValueError(f"rowsplit layout: row_map must lie in [0, {n}]")
    derived = rowsplit_carries(row_map, slots, n)
    return RowSplitLayout(
        row_map=tensor_from_host(row_map, device),
        cols=tensor_from_host(np.asarray(cols), device),
        slots=tensor_from_host(slots, device),
        vals=tensor_from_host(np.asarray(vals), device),
        **{name: tensor_from_host(a, device) for name, a in zip(
            ("last_slot", "shared", "carry_rows", "carry_chunks",
             "empty_rows"), derived)},
        n=n, window=window)


def rowsplit_spmm_plain(layout: RowSplitLayout, b: torch.Tensor
                        ) -> torch.Tensor:
    """The plain PyTorch version of the two kernels on the same layout.

    Each chunk's rows are summed in fp32 (products at the operand dtype);
    rows a chunk owns alone go to C, the shared end rows become carries,
    each carry row sums its carries in chunk order, and the rows with no
    entry are zeros.  Every row of C is written from these three lists.
    """
    num_chunks, window, n = layout.num_chunks, layout.window, layout.n
    dev = b.device
    windows = torch.zeros(num_chunks * window, b.shape[1],
                          dtype=torch.float32, device=dev)
    owners = torch.arange(num_chunks, dtype=torch.int32, device=dev)
    accumulate_chunks(windows, owners, torch.zeros_like(owners), layout.cols,
                      layout.slots, layout.vals, b, b_tile=None,
                      row_tile=window)
    windows = windows.view(num_chunks, window, -1)
    chunks = torch.arange(num_chunks, device=dev)
    last = layout.last_slot.long()
    head = (layout.shared & HEAD_SHARED) != 0
    tail = (layout.shared & TAIL_SHARED) != 0
    out = torch.empty(n, b.shape[1], dtype=b.dtype, device=dev)
    # Rows a chunk owns alone: its real slots but the shared end rows.
    own = ((torch.arange(window, device=dev)[None, :] <= last[:, None])
           & (layout.row_map < n))
    own[:, 0] &= ~(head | (tail & (last == 0)))
    own[chunks, last] &= ~tail
    out[layout.row_map[own].long()] = windows[own].to(b.dtype)
    # Carry slot 0 holds a chunk's first row, slot 1 its last.
    carry = torch.stack([windows[:, 0], windows[chunks, last]], dim=1)
    lo = layout.carry_chunks[:, 0].long()
    length = layout.carry_chunks[:, 1].long() - lo + 1
    item = torch.repeat_interleave(
        torch.arange(lo.shape[0], device=dev), length)
    pos = torch.arange(item.shape[0], device=dev) - torch.repeat_interleave(
        torch.cumsum(length, 0) - length, length)
    which = ((pos == 0) & (last[lo[item]] > 0)).long()
    sums = torch.zeros(lo.shape[0], b.shape[1], dtype=torch.float32,
                       device=dev)
    sums.index_add_(0, item, carry[lo[item] + pos, which])
    out[layout.carry_rows.long()] = sums.to(b.dtype)
    out[layout.empty_rows.long()] = 0
    return out


_P = ctypes.c_void_p
_ARGTYPES = (ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P, _P,
             _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, _P)


def _kernel():
    fn = build.library("rowsplit_spmm").rowsplit_spmm_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def rowsplit_spmm_cuda(layout: RowSplitLayout,
                       b: torch.Tensor) -> torch.Tensor:
    """Launch the two CUDA kernels (``csrc/rowsplit_spmm.cu``): C at b's
    dtype, every row written; the carry buffer is scratch."""
    global LAUNCHES
    traced = trace.recording()
    if traced:
        t_check = trace.now()
    check_operands("rowsplit_spmm", (
        layout.row_map, layout.cols, layout.slots, layout.vals,
        layout.last_slot, layout.shared, layout.carry_rows,
        layout.carry_chunks, layout.empty_rows), b, layout.vals)
    if b.shape[0] != layout.n:
        raise ValueError(f"rowsplit_spmm: b has {b.shape[0]} rows, the "
                         f"layout {layout.n}")
    if layout.slots.dtype != layout.cols.dtype:
        raise TypeError("rowsplit_spmm: cols and slots must share a dtype")
    if layout.n >= 2 ** 31:
        raise ValueError(f"rowsplit_spmm: n={layout.n} needs 64-bit row ids")
    if traced:
        t_alloc = trace.now()
    d = b.shape[1]
    out = torch.empty(layout.n, d, dtype=b.dtype, device=b.device)
    carry = torch.empty(layout.num_chunks, 2, d, dtype=torch.float32,
                        device=b.device)
    if layout.n == 0:
        return out
    if traced:
        t_launch = trace.now()
    num_carry = int(layout.carry_rows.shape[0])
    num_empty = int(layout.empty_rows.shape[0])
    err = _kernel()(value_code(b.dtype), index_code(layout.cols.dtype),
                    build.ptr(layout.row_map), build.ptr(layout.last_slot),
                    build.ptr(layout.shared), build.ptr(layout.cols),
                    build.ptr(layout.slots), build.ptr(layout.vals),
                    build.ptr(b), build.ptr(layout.carry_rows),
                    build.ptr(layout.carry_chunks),
                    build.ptr(layout.empty_rows), build.ptr(carry),
                    build.ptr(out), layout.num_chunks, num_carry, num_empty,
                    layout.window, d, layout.cols.shape[1], layout.n,
                    build.stream_ptr(b.device))
    LAUNCHES += 1 if num_carry + num_empty == 0 else 2
    if traced:
        trace.record_launch(t_check, t_alloc, t_launch)
    build.check(err, "rowsplit_spmm")
    return out


def rowsplit_spmm(layout: RowSplitLayout, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` with A as equal-nnz chunks: the two CUDA kernels for a
    CUDA operand, :func:`rowsplit_spmm_plain` for a CPU one.

    Args:
        layout: the packed operand, on ``b``'s device.
        b: ``[n, d]`` float32 or bfloat16, the layout's value dtype.

    Returns:
        ``C`` as ``[n, d]`` in ``b``'s dtype.
    """
    if b.device.type == "cuda":
        return rowsplit_spmm_cuda(layout, b)
    if b.device.type == "cpu":
        return rowsplit_spmm_plain(layout, b)
    raise ValueError(f"rowsplit_spmm runs on CUDA or the CPU, not {b.device}")
