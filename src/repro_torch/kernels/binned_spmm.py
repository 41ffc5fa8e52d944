"""Two-phase binned SpMM for the scale-free regime (CUDA kernel).

The counterpart of the reference's ``binned_spmm_pallas``.  Phase one
(host, :func:`csr_to_slab_bins`) bins the nonzeros by the B row slab they
gather from and orders them column-major inside each slab; a *visit* is
one (slab, row tile) pair with nonzeros, and visits run slab-major.  Phase
two (:func:`binned_spmm`) walks the visits' real entries piece by piece
(the CSR kernel's work list, the visit as the owner) and folds each
piece's touched rows into C with fp32 atomics, in the kernel; C is cast
once.  The atomics add a tile's visits in no fixed order, so the last
bits of C can change from run to run.  The plain version keeps the
reference's shape: fp32 visit partials, then :func:`fold_visits`.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.kernels import build
from repro_torch.kernels.csr_spmm import (
    ROW_TILE, accumulate_chunks, check_operands, check_row_tile_layout,
    chunk_lengths, chunk_positions, index_code, index_extent_check,
    value_code, work_list)

#: Kernel launches made by :func:`binned_spmm` (a plain counter).
LAUNCHES = 0


def csr_to_slab_bins(indptr: np.ndarray, indices: np.ndarray,
                     data: np.ndarray, *, n: int, row_tile: int = 8,
                     chunk: int = 128, b_tile: Optional[int] = None,
                     index_dtype=np.int32
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray, np.ndarray]:
    """Bin CSR nonzeros by B row slab (phase one of the binned kernel).

    Returns ``(visit_tiles[V], chunk_visits[C], chunk_slabs[C],
    cols[C, chunk], row_slots[C, chunk], vals[C, chunk])``.  Visits are
    ordered slab-major, then by row tile; within a visit entries are
    sorted by column, then row.  ``cols`` are slab-local and
    ``row_slots`` are rows within the tile, both at ``index_dtype``.  An
    empty matrix still produces one all-zero visit.  The arrays are
    byte-identical to the reference packer's.
    """
    indptr = np.asarray(indptr)
    indices = np.asarray(indices).astype(np.int64)
    data = np.asarray(data)
    index_extent_check(n if b_tile is None else b_tile, index_dtype)
    nnz = int(indptr[-1])
    rows = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(indptr).astype(np.int64))
    cols = indices[:nnz]
    vals = data[:nnz]
    bt = n if b_tile is None else b_tile
    slabs = cols // bt
    tiles = rows // row_tile
    order = np.lexsort((rows, cols, tiles, slabs))
    rows, cols, vals = rows[order], cols[order], vals[order]
    slabs, tiles = slabs[order], tiles[order]
    if nnz == 0:
        g_tile = g_slab = g_count = np.zeros(1, np.int64)
    else:
        keys = slabs * ((n + row_tile - 1) // row_tile + 1) + tiles
        starts = np.flatnonzero(np.diff(keys, prepend=-1))
        g_tile, g_slab = tiles[starts], slabs[starts]
        g_count = np.diff(np.append(starts, nnz))
    chunks, pos = chunk_positions(g_count, chunk)
    total = int(chunks.sum()) * chunk
    out_cols = np.zeros(total, dtype=index_dtype)
    out_slots = np.zeros(total, dtype=index_dtype)
    out_vals = np.zeros(total, dtype=data.dtype)
    out_cols[pos] = (cols - slabs * bt).astype(index_dtype)
    out_slots[pos] = (rows - tiles * row_tile).astype(index_dtype)
    out_vals[pos] = vals
    return (g_tile.astype(np.int32),
            np.repeat(np.arange(g_tile.shape[0]), chunks).astype(np.int32),
            np.repeat(g_slab, chunks).astype(np.int32),
            out_cols.reshape(-1, chunk), out_slots.reshape(-1, chunk),
            out_vals.reshape(-1, chunk))


@dataclasses.dataclass(frozen=True)
class SlabBinLayout:
    """The packed operand of :func:`binned_spmm`, on one device.

    The six packed arrays are :func:`csr_to_slab_bins`'s, unchanged.
    ``chunk_len`` and the work list ``piece_ptr`` / ``piece_owner``
    (visits as owners) are derived from them once, as for the CSR layout
    (:func:`~repro_torch.kernels.csr_spmm.work_pieces`).
    """

    visit_tiles: torch.Tensor   # [V] int32 row tile of each visit
    chunk_visits: torch.Tensor  # [C] int32
    chunk_slabs: torch.Tensor   # [C] int32
    cols: torch.Tensor          # [C, chunk] int32 or int16, slab-local
    slots: torch.Tensor         # [C, chunk] int32 or int16
    vals: torch.Tensor          # [C, chunk] float32 or bfloat16
    chunk_len: torch.Tensor     # [C] int32 real entries per chunk
    piece_ptr: torch.Tensor     # [P + 1] int32 chunk range of each piece
    piece_owner: torch.Tensor   # [P] int32 visit of each piece
    n: int
    b_tile: Optional[int]
    row_tile: int = ROW_TILE

    @property
    def num_visits(self) -> int:
        """Number of (slab, row tile) visits."""
        return int(self.visit_tiles.shape[0])

    @property
    def num_tiles(self) -> int:
        """Row tiles covering the ``n`` rows."""
        return (self.n + self.row_tile - 1) // self.row_tile

    @property
    def num_pieces(self) -> int:
        """Entries of the work list."""
        return int(self.piece_owner.shape[0])

    @property
    def device(self) -> torch.device:
        """The device the layout lives on."""
        return self.vals.device


def slab_bin_layout(visit_tiles, chunk_visits, chunk_slabs, cols, slots,
                    vals, *, n: int, b_tile: Optional[int],
                    row_tile: int = ROW_TILE,
                    device=None) -> SlabBinLayout:
    """Move :func:`csr_to_slab_bins`'s arrays to ``device`` as a layout,
    with the chunk lengths and the work list derived from them."""
    from repro_torch.sparse.formats import tensor_from_host
    visit_tiles, chunk_visits, cols, slots, vals = (
        np.asarray(a) for a in (visit_tiles, chunk_visits, cols, slots,
                                vals))
    lens = chunk_lengths(cols, slots, vals)
    work = work_list(chunk_visits, visit_tiles.shape[0], lens,
                     chunk=cols.shape[1])
    return SlabBinLayout(
        visit_tiles=tensor_from_host(visit_tiles, device),
        chunk_visits=tensor_from_host(chunk_visits, device),
        chunk_slabs=tensor_from_host(np.asarray(chunk_slabs), device),
        cols=tensor_from_host(cols, device),
        slots=tensor_from_host(slots, device),
        vals=tensor_from_host(vals, device),
        chunk_len=tensor_from_host(lens, device),
        **{k: tensor_from_host(v, device) for k, v in work.items()},
        n=n, b_tile=b_tile, row_tile=row_tile)


def fold_visits(layout: SlabBinLayout, partials: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The epilogue: fp32 sum of the visit partials per row tile, cast."""
    rt, d = layout.row_tile, partials.shape[1]
    rows = (layout.visit_tiles.long()[:, None] * rt
            + torch.arange(rt, device=partials.device)).reshape(-1)
    out = torch.zeros(layout.num_tiles * rt, d, dtype=torch.float32,
                      device=partials.device)
    out.index_add_(0, rows, partials)
    return out[:layout.n].to(dtype)


def binned_partials_plain(layout: SlabBinLayout,
                          b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch phase two: the fp32 visit partials ``[V*rt, d]``."""
    out = torch.zeros(layout.num_visits * layout.row_tile, b.shape[1],
                      dtype=torch.float32, device=b.device)
    return accumulate_chunks(out, layout.chunk_visits, layout.chunk_slabs,
                             layout.cols, layout.slots, layout.vals, b,
                             b_tile=layout.b_tile, row_tile=layout.row_tile)


def binned_spmm_plain(layout: SlabBinLayout, b: torch.Tensor
                      ) -> torch.Tensor:
    """The plain PyTorch version of the binned kernel on the same layout."""
    return fold_visits(layout, binned_partials_plain(layout, b), b.dtype)


_P = ctypes.c_void_p
_ARGTYPES = (ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, _P, _P, _P, _P,
             _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_longlong, ctypes.c_int, _P)


def _kernel():
    fn = build.library("binned_spmm").binned_spmm_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def binned_spmm_cuda(layout: SlabBinLayout, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/binned_spmm.cu``) on a CUDA operand.

    The kernel folds every piece's touched rows into one fp32 ``[n, d]``
    accumulator with atomics: C itself at fp32, else a buffer that the
    launch then casts into C.
    """
    global LAUNCHES
    traced = trace.recording()
    if traced:
        t_check = trace.now()
    check_row_tile_layout("binned_spmm", layout, b)
    check_operands("binned_spmm", (layout.visit_tiles,), b, layout.vals)
    if traced:
        t_alloc = trace.now()
    n, d = b.shape
    acc = torch.zeros(n, d, dtype=torch.float32, device=b.device)
    c = acc if b.dtype == torch.float32 else \
        torch.empty(n, d, dtype=b.dtype, device=b.device)
    if traced:
        t_launch = trace.now()
    fn = _kernel()
    err = fn(value_code(b.dtype), index_code(layout.cols.dtype),
             build.ptr(layout.piece_ptr), build.ptr(layout.piece_owner),
             build.ptr(layout.visit_tiles), build.ptr(layout.chunk_len),
             build.ptr(layout.chunk_slabs), build.ptr(layout.cols),
             build.ptr(layout.slots), build.ptr(layout.vals), build.ptr(b),
             build.ptr(acc), build.ptr(c), layout.num_pieces, n, d,
             layout.n if layout.b_tile is None else layout.b_tile,
             layout.cols.shape[1], build.stream_ptr(b.device))
    LAUNCHES += 1
    if traced:
        trace.record_launch(t_check, t_alloc, t_launch)
    build.check(err, "binned_spmm")
    return c


def binned_spmm(layout: SlabBinLayout, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` with A as slab-binned chunks: the CUDA kernel for a
    CUDA operand, :func:`binned_spmm_plain` for a CPU one.

    Args:
        layout: the packed operand, on ``b``'s device.
        b: ``[n, d]`` float32 or bfloat16, the layout's value dtype.

    Returns:
        ``C`` as ``[n, d]`` in ``b``'s dtype.
    """
    if b.device.type == "cuda":
        return binned_spmm_cuda(layout, b)
    if b.device.type == "cpu":
        return binned_spmm_plain(layout, b)
    raise ValueError(f"binned_spmm runs on CUDA or the CPU, not {b.device}")
