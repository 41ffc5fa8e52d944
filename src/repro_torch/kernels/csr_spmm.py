"""CSR row-gather / segment-sum SpMM over row-tiled chunks (CUDA kernel).

The counterpart of the reference's ``csr_spmm_pallas``.  The host packer
:func:`csr_to_row_tiles` cuts each tile of ``row_tile`` rows into chunks of
``chunk`` nonzeros, grouped by the B row slab they gather from (``b_tile``
rows per slab, slab-local column ids), exactly as the reference packs them
(the port's packer is vectorised with numpy and byte-identical).

When a layout is moved to its device, two arrays are derived from the
packed ones, once: :func:`chunk_lengths` (the real entries of each chunk,
a prefix of its slots) and :func:`work_pieces` (the kernel's work list: an
owner's chunk range cut into pieces of at most :data:`PIECE_NNZ` real
entries, so that a hub row's tile is walked by many warps at once).

:func:`csr_spmm` runs ``C = A @ B`` on a :class:`RowTileLayout`: the
hand-written kernel ``csrc/csr_spmm.cu`` for a CUDA operand, the plain
PyTorch version :func:`csr_spmm_plain` for a CPU operand.  Products round
at the operand dtype, sums run in fp32 and C is cast once.  The kernel
walks a piece one of two ways, which :func:`csr_variant` picks from B's
width: ``"wide"`` (every lane of a warp on each entry, 64-column slices)
or ``"narrow"`` (d <= 32: a few lanes per entry, several entries a step).
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.kernels import build

#: Kernel launches made by :func:`csr_spmm` (a plain counter; reset by
#: assigning 0).
LAUNCHES = 0

#: The kernel's walks, in the order of their codes in ``csrc/csr_spmm.cu``.
VARIANTS = ("wide", "narrow")

#: Launches by walk (the same launches as :data:`LAUNCHES`).
LAUNCHES_BY_VARIANT = dict.fromkeys(VARIANTS, 0)

#: Lanes of a warp, and the widest B the narrow walk takes (one column
#: per lane).
WARP = 32

#: Rows per C tile the kernel is compiled for.
ROW_TILE = 8

#: Gathered values the plain version materialises per step (bounds its
#: memory on large layouts).
PLAIN_STEP = 1 << 26

#: Most real entries of a work piece that holds more than one chunk.  One
#: warp walks a piece; a uniform row tile at n = 2**20 holds ~80 entries,
#: a hub row's tile ~95,000, which this cuts into ~250 pieces.  On the
#: H100, 512 beat 1024, 2048 and 4096 on scale-free and tied on uniform
#: (``python -m repro_torch.launch.bench_row_tile``).
PIECE_NNZ = 512

#: Chunks the packed arrays are scanned in when deriving chunk lengths
#: (bounds the host memory of the scan).
_SCAN_CHUNKS = 1 << 16


def csr_variant(d: int) -> Tuple[str, int]:
    """The walk a CUDA operand of width ``d`` launches, and its lanes per
    entry: ``("narrow", L)`` for d <= 32, L the smallest power of two
    >= d (one column per lane, 32 / L entries of a piece per step);
    ``("wide", 32)`` otherwise (every lane on each entry, two columns per
    lane in 64-column slices)."""
    if d < 1:
        raise ValueError(f"csr_variant: d must be >= 1, got {d}")
    if d <= WARP:
        return "narrow", 1 << (d - 1).bit_length()
    return "wide", WARP


def index_extent_check(extent: int, index_dtype) -> None:
    """Refuse an index dtype that cannot address ``extent`` positions.

    The packers reserve sentinel values equal to the extent itself, so
    the extent — not ``extent - 1`` — must be representable (an extent of
    exactly ``2**15`` is illegal for int16).
    """
    if np.dtype(index_dtype) == np.int16 and extent > 2 ** 15 - 1:
        raise ValueError(
            f"int16 indices cannot address extent {extent} "
            f"(max {2 ** 15 - 1} including the sentinel slot)")


def chunk_positions(group_counts: np.ndarray, chunk: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Chunk count per group and the flat slot of every member.

    Groups are padded to whole chunks, and an empty group still owns one
    all-zero chunk.  Returns ``(chunks_per_group, slot_of_member)`` where
    members are numbered group by group in order.
    """
    counts = np.asarray(group_counts, dtype=np.int64)
    chunks = np.maximum(1, -(-counts // chunk))
    first_slot = np.concatenate([[0], np.cumsum(chunks)[:-1]]) * chunk
    first_member = np.concatenate([[0], np.cumsum(counts)[:-1]])
    member = np.arange(int(counts.sum()), dtype=np.int64)
    group = np.repeat(np.arange(counts.shape[0]), counts)
    return chunks, first_slot[group] + member - first_member[group]


def csr_to_row_tiles(indptr: np.ndarray, indices: np.ndarray,
                     data: np.ndarray, *, n: int, row_tile: int = 8,
                     chunk: int = 128, b_tile: Optional[int] = None,
                     index_dtype=np.int32
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]:
    """Pack CSR arrays into fixed-size chunks grouped by row tile.

    Returns ``(tile_ids[C], b_tile_ids[C], cols[C, chunk],
    row_slots[C, chunk], vals[C, chunk])``: chunk ``c`` belongs to row
    tile ``tile_ids[c]`` and gathers only from B row slab
    ``b_tile_ids[c]``; ``row_slots`` are rows within the tile.  A tile's
    chunks are contiguous and visit its slabs in ascending order (a
    stable partition of the tile's nonzeros by ``col // b_tile``);
    empty tiles still get one all-zero chunk.  With ``b_tile=None`` there
    is one slab and ``cols`` are global; otherwise ``cols`` are
    slab-local.  ``cols``/``row_slots`` are stored at ``index_dtype``.
    The arrays are byte-identical to the reference packer's.
    """
    indptr = np.asarray(indptr).astype(np.int64)
    data = np.asarray(data)
    index_extent_check(n if b_tile is None else b_tile, index_dtype)
    nnz = int(indptr[n]) - int(indptr[0])
    num_tiles = (n + row_tile - 1) // row_tile
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr[:n + 1]))
    cols = np.asarray(indices)[int(indptr[0]):int(indptr[n])].astype(np.int64)
    vals = data[int(indptr[0]):int(indptr[n])]
    tiles = rows // row_tile
    slabs = np.zeros(nnz, np.int64) if b_tile is None else cols // b_tile
    # Stable sort by (tile, slab): within a tile the nonzeros keep their
    # CSR order inside each slab, as the reference's per-tile partition.
    order = np.lexsort((slabs, tiles))
    tiles, slabs, cols, vals = (tiles[order], slabs[order], cols[order],
                                vals[order])
    slots = rows[order] - tiles * row_tile
    # One group per (tile, slab) with nonzeros, plus one per empty tile.
    key = tiles * (n + 1) + slabs
    starts = np.flatnonzero(np.diff(key, prepend=-1)) if nnz else \
        np.zeros(0, np.int64)
    g_tile, g_slab = tiles[starts], slabs[starts]
    g_count = np.diff(np.append(starts, nnz))
    empty = np.setdiff1d(np.arange(num_tiles), g_tile)
    g_tile = np.concatenate([g_tile, empty])
    g_slab = np.concatenate([g_slab, np.zeros_like(empty)])
    g_count = np.concatenate([g_count, np.zeros_like(empty)])
    # Empty tiles hold no members, so sorting the groups keeps the members
    # of the nonempty ones in stream order.
    g_order = np.lexsort((g_slab, g_tile))
    g_tile, g_slab, g_count = g_tile[g_order], g_slab[g_order], \
        g_count[g_order]
    chunks, pos = chunk_positions(g_count, chunk)
    base = 0 if b_tile is None else b_tile
    total = int(chunks.sum()) * chunk
    out_cols = np.zeros(total, dtype=index_dtype)
    out_slots = np.zeros(total, dtype=index_dtype)
    out_vals = np.zeros(total, dtype=data.dtype)
    out_cols[pos] = (cols - slabs * base).astype(index_dtype)
    out_slots[pos] = slots.astype(index_dtype)
    out_vals[pos] = vals
    return (np.repeat(g_tile, chunks).astype(np.int32),
            np.repeat(g_slab, chunks).astype(np.int32),
            out_cols.reshape(-1, chunk), out_slots.reshape(-1, chunk),
            out_vals.reshape(-1, chunk))


def chunk_lengths(cols: np.ndarray, slots: np.ndarray,
                  vals: np.ndarray) -> np.ndarray:
    """``[C]`` int32: the real entries of each packed chunk.

    The packers place a (tile, slab) group's members at the first slots of
    its chunks, so each chunk's real entries are a prefix and every slot
    after it is padding, ``(col, slot, value) = (0, 0, +0.0)`` bit for bit.
    The length is one past the last slot whose triple is not all zero bits,
    so an explicit zero value inside the prefix stays a real entry.  The
    one entry this cannot see is a group whose only member is an explicit
    ``+0.0`` at slot 0, column 0: its chunk is byte-identical to an empty
    tile's, and its product is 0 for finite B.
    """
    cols, slots, vals = (np.ascontiguousarray(a) for a in (cols, slots, vals))
    num, chunk = cols.shape
    out = np.zeros(num, np.int32)
    for lo in range(0, num, _SCAN_CHUNKS):
        hi = min(num, lo + _SCAN_CHUNKS)
        real = (cols[lo:hi] != 0) | (slots[lo:hi] != 0)
        real |= vals[lo:hi].view(np.uint8).reshape(
            hi - lo, chunk, -1).any(axis=-1)
        last = chunk - np.argmax(real[:, ::-1], axis=1)
        out[lo:hi] = np.where(real.any(axis=1), last, 0)
    return out


def work_pieces(owner_ptr: np.ndarray, chunk_len: np.ndarray, *,
                chunk: int, piece_nnz: int = PIECE_NNZ
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The kernels' work list: ``(piece_ptr[P + 1], piece_owner[P])``.

    Piece ``p`` walks chunks ``[piece_ptr[p], piece_ptr[p + 1])`` of owner
    ``piece_owner[p]``.  Pieces are contiguous, in chunk order, never
    cross an owner, and cover every chunk once; every owner has at least
    one.  A piece holds at most ``piece_nnz`` real entries: chunk ``c`` of
    an owner goes to that owner's piece ``s_c // (piece_nnz - chunk + 1)``,
    where ``s_c`` counts the owner's real entries before ``c``.
    """
    if piece_nnz < chunk:
        raise ValueError(f"piece_nnz={piece_nnz} is below one chunk "
                         f"({chunk})")
    owner_ptr = np.asarray(owner_ptr, np.int64)
    lens = np.asarray(chunk_len, np.int64)
    num = lens.shape[0]
    owner = np.repeat(np.arange(owner_ptr.shape[0] - 1),
                      np.diff(owner_ptr))
    before = np.cumsum(lens) - lens
    local = (before - before[owner_ptr[owner]]) // (piece_nnz - chunk + 1)
    first = np.arange(num) == owner_ptr[owner]
    starts = np.flatnonzero(first | (local != np.roll(local, 1)))
    return (np.append(starts, num).astype(np.int32),
            owner[starts].astype(np.int32))


def split_owners(piece_owner: np.ndarray, num_owners: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """``(split[S], piece_split[P])``: the owners cut into more than one
    piece, ascending, and each piece's rank among them (-1 for a piece
    that is its owner's only one)."""
    pieces = np.bincount(np.asarray(piece_owner, np.int64),
                         minlength=num_owners)
    split = np.flatnonzero(pieces > 1)
    rank = np.full(num_owners, -1, np.int64)
    rank[split] = np.arange(split.shape[0])
    return split.astype(np.int32), rank[piece_owner].astype(np.int32)


@dataclasses.dataclass(frozen=True)
class RowTileLayout:
    """The packed CSR operand of :func:`csr_spmm`, on one device.

    The five packed arrays are :func:`csr_to_row_tiles`'s, unchanged.  The
    others are derived from them once (:func:`row_tile_layout`):
    ``chunk_len`` (:func:`chunk_lengths`), the work list ``piece_ptr`` /
    ``piece_owner`` (:func:`work_pieces`, tiles as owners), and the tiles
    cut into several pieces (:func:`split_owners`).
    """

    tile_ids: torch.Tensor      # [C] int32
    chunk_slabs: torch.Tensor   # [C] int32
    cols: torch.Tensor          # [C, chunk] int32 or int16, slab-local
    slots: torch.Tensor         # [C, chunk] int32 or int16
    vals: torch.Tensor          # [C, chunk] float32 or bfloat16
    chunk_len: torch.Tensor     # [C] int32 real entries per chunk
    piece_ptr: torch.Tensor     # [P + 1] int32 chunk range of each piece
    piece_owner: torch.Tensor   # [P] int32 row tile of each piece
    piece_split: torch.Tensor   # [P] int32 rank of a split tile, or -1
    split_tiles: torch.Tensor   # [S] int32 tiles cut into several pieces
    n: int
    b_tile: Optional[int]       # None: one slab, global columns
    row_tile: int = ROW_TILE

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


def owner_ptr(owner_ids: np.ndarray, num_owners: int) -> np.ndarray:
    """``[num_owners + 1]`` chunk ranges of non-decreasing owner ids."""
    counts = np.bincount(np.asarray(owner_ids, np.int64),
                         minlength=num_owners)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def work_list(owner_ids, num_owners: int, chunk_len, *, chunk: int,
              piece_nnz: int = PIECE_NNZ, split: bool = False) -> dict:
    """The work-list fields of a layout whose chunk ``c`` belongs to owner
    ``owner_ids[c]`` (non-decreasing): ``piece_ptr`` and ``piece_owner``
    (:func:`work_pieces`) and, with ``split``, ``split_tiles`` and
    ``piece_split`` (:func:`split_owners`), as numpy arrays."""
    ptr, owner = work_pieces(owner_ptr(owner_ids, num_owners), chunk_len,
                             chunk=chunk, piece_nnz=piece_nnz)
    out = {"piece_ptr": ptr, "piece_owner": owner}
    if split:
        out["split_tiles"], out["piece_split"] = split_owners(owner,
                                                              num_owners)
    return out


def row_tile_layout(tile_ids, b_tile_ids, cols, slots, vals, *, n: int,
                    b_tile: Optional[int], row_tile: int = ROW_TILE,
                    device=None) -> RowTileLayout:
    """Move :func:`csr_to_row_tiles`'s arrays to ``device`` as a layout,
    with the chunk lengths and the work list derived from them.

    ``vals`` may be a float32 array or bf16 bits as ``uint16`` (or a numpy
    ``bfloat16`` array); they become float32 or bfloat16 tensors.
    """
    from repro_torch.sparse.formats import tensor_from_host
    num_tiles = (n + row_tile - 1) // row_tile
    tile_ids, cols, slots, vals = (np.asarray(a) for a in
                                   (tile_ids, cols, slots, vals))
    lens = chunk_lengths(cols, slots, vals)
    work = work_list(tile_ids, num_tiles, lens, chunk=cols.shape[1],
                     split=True)
    return RowTileLayout(
        tile_ids=tensor_from_host(tile_ids, device),
        chunk_slabs=tensor_from_host(np.asarray(b_tile_ids), device),
        cols=tensor_from_host(cols, device),
        slots=tensor_from_host(slots, device),
        vals=tensor_from_host(vals, device),
        chunk_len=tensor_from_host(lens, device),
        **{k: tensor_from_host(v, device) for k, v in work.items()},
        n=n, b_tile=b_tile, row_tile=row_tile)


def with_work_list(layout, piece_nnz: int):
    """``layout`` (a :class:`RowTileLayout` or a binned ``SlabBinLayout``)
    with its work list re-derived at ``piece_nnz``; every other field is
    shared.  For tests and tuning: the layout builders use
    :data:`PIECE_NNZ`."""
    from repro_torch.sparse.formats import tensor_from_host
    tiles = isinstance(layout, RowTileLayout)
    owners, num = ((layout.tile_ids, layout.num_tiles) if tiles else
                   (layout.chunk_visits, layout.num_visits))
    work = work_list(owners.cpu().numpy(), num,
                     layout.chunk_len.cpu().numpy(),
                     chunk=layout.cols.shape[1], piece_nnz=piece_nnz,
                     split=tiles)
    return dataclasses.replace(layout, **{
        k: tensor_from_host(v, layout.device) for k, v in work.items()})


def accumulate_chunks(out: torch.Tensor, owners: torch.Tensor,
                      chunk_slabs: torch.Tensor, cols: torch.Tensor,
                      slots: torch.Tensor, vals: torch.Tensor,
                      b: torch.Tensor, *, b_tile: Optional[int],
                      row_tile: int) -> torch.Tensor:
    """``out[owner * row_tile + slot] += B[slab * b_tile + col] * val``.

    The plain PyTorch chunk walk shared by the CSR and binned versions:
    products at the operand dtype, an fp32 ``index_add_`` into ``out``.
    """
    d = b.shape[1]
    chunk = cols.shape[1]
    step = max(1, PLAIN_STEP // (chunk * d))
    base = 0 if b_tile is None else b_tile
    for lo in range(0, cols.shape[0], step):
        hi = lo + step
        gcols = (chunk_slabs[lo:hi].long()[:, None] * base
                 + cols[lo:hi].long())
        scaled = b[gcols] * vals[lo:hi, :, None]
        rows = owners[lo:hi].long()[:, None] * row_tile + slots[lo:hi].long()
        out.index_add_(0, rows.reshape(-1),
                       scaled.reshape(-1, d).to(torch.float32))
    return out


def csr_spmm_plain(layout: RowTileLayout, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the CSR kernel on the same layout."""
    out = torch.zeros(layout.num_tiles * layout.row_tile, b.shape[1],
                      dtype=torch.float32, device=b.device)
    accumulate_chunks(out, layout.tile_ids, layout.chunk_slabs, layout.cols,
                      layout.slots, layout.vals, b, b_tile=layout.b_tile,
                      row_tile=layout.row_tile)
    return out[:layout.n].to(b.dtype)


def check_operands(kernel: str, tensors, b: torch.Tensor,
                   vals: torch.Tensor) -> None:
    """The kernels' contract: one device, contiguous, matching dtypes."""
    if b.ndim != 2 or b.shape[1] < 1:
        raise ValueError(f"{kernel}: b must be [n, d] with d >= 1, "
                         f"got {tuple(b.shape)}")
    if b.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{kernel}: b must be float32 or bfloat16, "
                        f"got {b.dtype}")
    if vals.dtype != b.dtype:
        raise TypeError(f"{kernel}: layout values are {vals.dtype} but b "
                        f"is {b.dtype}")
    for t in (*tensors, b):
        if t.device != b.device:
            raise ValueError(f"{kernel}: operands on {t.device} and "
                             f"{b.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: operands must be contiguous")


def value_code(dtype: torch.dtype) -> int:
    """The kernels' value type code (0 float32, 1 bfloat16)."""
    return 1 if dtype == torch.bfloat16 else 0


def index_code(dtype: torch.dtype) -> int:
    """The kernels' index type code (0 int32, 1 int16)."""
    if dtype not in (torch.int32, torch.int16):
        raise TypeError(f"indices must be int32 or int16, got {dtype}")
    return 1 if dtype == torch.int16 else 0


def check_row_tile_layout(kernel: str, layout, b: torch.Tensor) -> None:
    """The row-tile kernels' contract on a layout and its B operand."""
    if layout.row_tile != ROW_TILE:
        raise ValueError(f"{kernel}: the kernel is built for row_tile="
                         f"{ROW_TILE}, got {layout.row_tile}")
    check_operands(kernel, (layout.chunk_len, layout.piece_ptr,
                            layout.piece_owner, layout.chunk_slabs,
                            layout.cols, layout.slots, layout.vals),
                   b, layout.vals)
    if b.shape[0] != layout.n:
        raise ValueError(f"{kernel}: b has {b.shape[0]} rows, the layout "
                         f"{layout.n}")
    if layout.slots.dtype != layout.cols.dtype:
        raise TypeError(f"{kernel}: cols and slots must share a dtype")
    if layout.n >= 2 ** 31:
        raise ValueError(f"{kernel}: n={layout.n} needs 64-bit row ids")


_P = ctypes.c_void_p
_ARGTYPES = (ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
             _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_int, _P)


def _kernel():
    fn = build.library("csr_spmm").csr_spmm_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def csr_spmm_cuda(layout: RowTileLayout, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/csr_spmm.cu``) on a CUDA operand,
    with the walk :func:`csr_variant` picks for its width.

    A tile walked by one piece is stored once; the pieces of a split tile
    add into an fp32 buffer of the split tiles' rows, which the launch
    then stores into C.
    """
    global LAUNCHES
    traced = trace.recording()
    if traced:
        t_check = trace.now()
    check_row_tile_layout("csr_spmm", layout, b)
    check_operands("csr_spmm", (layout.piece_split, layout.split_tiles), b,
                   layout.vals)
    if traced:
        t_alloc = trace.now()
    n, d = b.shape
    c = torch.empty(n, d, dtype=b.dtype, device=b.device)
    num_split = int(layout.split_tiles.shape[0])
    split_acc = torch.zeros(num_split * ROW_TILE, d, dtype=torch.float32,
                            device=b.device)
    if traced:
        t_launch = trace.now()
    variant, lanes = csr_variant(d)
    fn = _kernel()
    err = fn(VARIANTS.index(variant), lanes, value_code(b.dtype),
             index_code(layout.cols.dtype),
             build.ptr(layout.piece_ptr), build.ptr(layout.piece_owner),
             build.ptr(layout.piece_split), build.ptr(layout.split_tiles),
             build.ptr(layout.chunk_len), build.ptr(layout.chunk_slabs),
             build.ptr(layout.cols), build.ptr(layout.slots),
             build.ptr(layout.vals), build.ptr(b), build.ptr(c),
             build.ptr(split_acc), layout.num_pieces, num_split, n, d,
             layout.b_tile or 0, layout.cols.shape[1],
             build.stream_ptr(b.device))
    LAUNCHES += 1
    LAUNCHES_BY_VARIANT[variant] += 1
    if traced:
        trace.record_launch(t_check, t_alloc, t_launch)
    build.check(err, f"csr_spmm ({variant}, {lanes} lanes)")
    return c


def csr_spmm(layout: RowTileLayout, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` with A as row-tiled chunks: the CUDA kernel for a CUDA
    operand, :func:`csr_spmm_plain` for a CPU one.

    Args:
        layout: the packed operand, on ``b``'s device.
        b: ``[n, d]`` float32 or bfloat16, the layout's value dtype.

    Returns:
        ``C`` as ``[n, d]`` in ``b``'s dtype.
    """
    if b.device.type == "cuda":
        return csr_spmm_cuda(layout, b)
    if b.device.type == "cpu":
        return csr_spmm_plain(layout, b)
    raise ValueError(f"csr_spmm runs on CUDA or the CPU, not {b.device}")
