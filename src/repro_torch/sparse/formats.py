"""Sparse matrix containers as frozen dataclasses of tensors.

The seven layouts of the reference package (CSR / ELL / BCSR / DIA and the
scale-free tier BINNED / ROWSPLIT / ELL_COO), field for field.  Each
container holds torch tensors on one device (``container.device``) and
moves with ``container.to(device)``; static shape information (n, t, nnz,
offsets) is plain Python.

The converters build the same arrays as the reference converters, in the
same order, with index arithmetic in numpy.  Values are cast exactly as
the reference casts them: float64 -> float32 in numpy, then to the target
dtype with torch (bf16 rounds to nearest even from the float32 value).
Host-side numpy copies of bf16 values carry the raw bits as ``uint16``
(:func:`host_values` / :func:`tensor_from_host`), since numpy has no
bfloat16.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.core.device import device_of
from repro_torch.core.precision import (  # noqa: F401  (re-export)
    DEFAULT_PRECISION, INT16_MAX_EXTENT, PRECISION_BF16, PRECISION_BF16_I32,
    PRECISION_FP32, PRECISIONS, Precision, as_precision, int16_extent_ok)


class _Tensors:
    """Mixin: device of the tensor fields and a copy on another device."""

    @property
    def device(self) -> torch.device:
        """The device every tensor field lives on."""
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                return v.device
        return torch.device("cpu")

    def to(self, device):
        """A copy of this container with every tensor on ``device``."""
        return dataclasses.replace(self, **{
            f.name: to_device(getattr(self, f.name), device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


@dataclasses.dataclass(frozen=True)
class CSRMatrix(_Tensors):
    """CSR with a precomputed per-nonzero row-id vector (segment ids)."""

    data: torch.Tensor      # [nnz] values
    indices: torch.Tensor   # [nnz] column ids (int32)
    indptr: torch.Tensor    # [n+1] row pointers (int32)
    row_ids: torch.Tensor   # [nnz] row id per nonzero (int32)
    n: int

    @property
    def nnz(self) -> int:
        """Number of stored nonzeros."""
        return int(self.data.shape[0])


@dataclasses.dataclass(frozen=True)
class ELLMatrix(_Tensors):
    """Padded (ELLPACK) layout: fixed nonzeros-per-row, zero padding."""

    data: torch.Tensor      # [n, k] values, zero-padded
    indices: torch.Tensor   # [n, k] column ids, padded with 0
    n: int

    @property
    def k(self) -> int:
        """Padded slots per row (the max row degree at conversion time)."""
        return int(self.data.shape[1])


@dataclasses.dataclass(frozen=True)
class BCSRMatrix(_Tensors):
    """Block-CSR with dense t x t blocks, sorted by (block_row, block_col)."""

    blocks: torch.Tensor      # [N, t, t] dense block values
    block_rows: torch.Tensor  # [N] block-row id (int32)
    block_cols: torch.Tensor  # [N] block-col id (int32)
    block_ptr: torch.Tensor   # [nb+1] first block of each block row (int32)
    n: int
    t: int
    nnz: int                  # true nonzeros (for FLOP accounting)

    @property
    def num_blocks(self) -> int:
        """Count of stored (nonzero) t x t blocks — the paper's N."""
        return int(self.blocks.shape[0])

    @property
    def nb(self) -> int:
        """Number of block rows/cols (n / t)."""
        return self.n // self.t


@dataclasses.dataclass(frozen=True)
class DIAMatrix(_Tensors):
    """Diagonal storage: one row of values per stored offset."""

    data: torch.Tensor        # [num_offsets, n] values (zero out of band)
    offsets: Tuple[int, ...]  # diagonal offsets
    n: int

    @property
    def num_offsets(self) -> int:
        """Number of stored diagonals."""
        return int(self.data.shape[0])


@dataclasses.dataclass(frozen=True)
class BinnedMatrix(_Tensors):
    """Slab-binned COO: nonzeros grouped by B-row slab (``col //
    slab_rows``), column-major inside each slab."""

    data: torch.Tensor      # [nnz] values, slab-major order
    cols: torch.Tensor      # [nnz] column ids (int32), ascending per slab
    rows: torch.Tensor      # [nnz] row id per nonzero (int32)
    slab_ptr: torch.Tensor  # [num_slabs+1] first nonzero of each slab
    slab_rows: int
    n: int

    @property
    def nnz(self) -> int:
        """Number of stored nonzeros."""
        return int(self.data.shape[0])

    @property
    def num_slabs(self) -> int:
        """Number of B-row slabs (ceil(n / slab_rows))."""
        return int(self.slab_ptr.shape[0]) - 1


@dataclasses.dataclass(frozen=True)
class RowSplitMatrix(_Tensors):
    """Equal-nnz work chunks over the row-major nonzero stream, padded
    with value-0 entries at row 0 to a whole number of chunks."""

    data: torch.Tensor   # [P] values, row-major, zero-padded
    cols: torch.Tensor   # [P] column ids (int32), 0-padded
    rows: torch.Tensor   # [P] row id per nonzero (int32), 0-padded
    chunk: int
    n: int
    nnz: int             # true nonzeros (excludes padding)

    @property
    def num_chunks(self) -> int:
        """Number of equal-work chunks (padded length / chunk)."""
        return int(self.data.shape[0]) // self.chunk


@dataclasses.dataclass(frozen=True)
class ELLCOOMatrix(_Tensors):
    """Hybrid layout: sorted-ELL body + COO tail above a width cutoff."""

    body_data: torch.Tensor     # [n, k_cut] values, zero-padded
    body_indices: torch.Tensor  # [n, k_cut] column ids, padded with 0
    tail_data: torch.Tensor     # [tail_nnz] overflow values
    tail_cols: torch.Tensor     # [tail_nnz] overflow column ids (int32)
    tail_rows: torch.Tensor     # [tail_nnz] overflow row ids (int32)
    n: int
    nnz: int

    @property
    def k_cut(self) -> int:
        """Padded body slots per row (the per-matrix width cutoff)."""
        return int(self.body_data.shape[1])

    @property
    def tail_nnz(self) -> int:
        """Nonzeros stored in the COO tail."""
        return int(self.tail_data.shape[0])


# --------------------------------------------------------------------------
# Host <-> tensor value plumbing.
# --------------------------------------------------------------------------

def to_device(t: torch.Tensor, device, dtype=None) -> torch.Tensor:
    """``t`` on ``device`` (the CPU for None), cast to ``dtype`` if given.

    Every copy of this module to the card goes through here: one that
    leaves the CPU while a set-up span is open (``spmm.plan`` /
    ``spmm.pack``) is recorded as a ``spmm.pack.copy`` span with the bytes
    it wrote.
    """
    dev = device_of(device)
    if dev.type == "cpu" or not trace.in_setup():
        return t.to(device=dev, dtype=dtype)
    with trace.span("spmm.pack.copy") as s:
        out = t.to(device=dev, dtype=dtype)
        s.attrs["bytes"] = out.numel() * out.element_size()
    return out


def host_values(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of value tensor ``t``; bf16 comes back as uint16 bits."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def tensor_from_host(a: np.ndarray, device=None) -> torch.Tensor:
    """Inverse of :func:`host_values`: a tensor on ``device``.

    ``uint16`` arrays and numpy ``bfloat16`` arrays (as the reference
    package's packers produce) become bf16 tensors bit for bit; every
    other dtype converts as is.
    """
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # e.g. a view of another framework's buffer
        a = a.copy()
    if a.dtype == np.uint16 or a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return to_device(t, device)


def _cast(a32: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Cast a float32 numpy array to a ``dtype`` tensor on ``device``."""
    return to_device(torch.from_numpy(np.ascontiguousarray(a32)), device,
                     dtype)


def _idx(a: np.ndarray, device) -> torch.Tensor:
    return to_device(torch.from_numpy(np.ascontiguousarray(a)), device)


# --------------------------------------------------------------------------
# Converters from the numpy COO patterns (repro_torch.core.patterns).
# --------------------------------------------------------------------------

def csr_host_arrays(m, dtype=torch.float32
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Row-major CSR arrays of ``m`` on the host: ``(indptr, indices,
    data)``, with ``data`` at ``dtype`` (bf16 as uint16 bits)."""
    order = np.lexsort((m.cols, m.rows))
    rows = m.rows[order]
    vals = m.vals[order].astype(np.float32)
    counts = np.bincount(rows, minlength=m.n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    data = host_values(_cast(vals, dtype, "cpu"))
    return indptr, m.cols[order].astype(np.int32), data


def coo_to_csr(m, dtype=torch.float32, device=None) -> CSRMatrix:
    """Convert a COO pattern to CSR on ``device`` (default: the CPU)."""
    order = np.lexsort((m.cols, m.rows))
    rows = m.rows[order]
    counts = np.bincount(rows, minlength=m.n)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return CSRMatrix(
        data=_cast(m.vals[order].astype(np.float32), dtype, device),
        indices=_idx(m.cols[order].astype(np.int32), device),
        indptr=_idx(indptr, device),
        row_ids=_idx(rows.astype(np.int32), device),
        n=m.n)


def coo_to_ell(m, dtype=torch.float32, max_k: int | None = None,
               device=None) -> ELLMatrix:
    """Convert a COO pattern to padded ELLPACK (entries past ``max_k`` in
    a row are dropped, as in the reference)."""
    counts = np.bincount(m.rows, minlength=m.n)
    k = int(counts.max()) if (max_k is None and m.n) else (max_k or 0)
    k = max(k, 1)
    order = np.lexsort((m.cols, m.rows))
    rows = m.rows[order].astype(np.int64)
    indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    slot = np.arange(rows.shape[0], dtype=np.int64) - indptr[rows]
    keep = slot < k
    data = np.zeros((m.n, k), dtype=np.float32)
    indices = np.zeros((m.n, k), dtype=np.int32)
    data[rows[keep], slot[keep]] = m.vals[order][keep]
    indices[rows[keep], slot[keep]] = m.cols[order][keep]
    return ELLMatrix(data=_cast(data, dtype, device),
                     indices=_idx(indices, device), n=m.n)


def coo_to_bcsr(m, t: int, dtype=torch.float32, device=None) -> BCSRMatrix:
    """Convert a COO pattern to dense-block BCSR (``m.n`` must divide by
    ``t``; raises ``ValueError`` otherwise)."""
    if m.n % t != 0:
        raise ValueError(f"matrix dim {m.n} not divisible by block size {t}")
    bi = m.rows.astype(np.int64) // t
    bj = m.cols.astype(np.int64) // t
    nb = m.n // t
    blin = bi * nb + bj
    uniq, inverse = np.unique(blin, return_inverse=True)
    N = uniq.shape[0]
    blocks = np.zeros((N, t, t), dtype=np.float32)
    blocks[inverse.reshape(-1), m.rows % t, m.cols % t] = \
        m.vals.astype(np.float32)
    block_rows = (uniq // nb).astype(np.int32)
    block_cols = (uniq % nb).astype(np.int32)
    counts = np.bincount(block_rows, minlength=nb)
    block_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return BCSRMatrix(blocks=_cast(blocks, dtype, device),
                      block_rows=_idx(block_rows, device),
                      block_cols=_idx(block_cols, device),
                      block_ptr=_idx(block_ptr, device),
                      n=m.n, t=t, nnz=m.nnz)


def coo_to_dia(m, dtype=torch.float32, max_offsets: int = 64,
               device=None) -> DIAMatrix:
    """Convert a COO pattern to diagonal storage (refuses more than
    ``max_offsets`` distinct diagonals with ``ValueError``)."""
    diag = m.cols.astype(np.int64) - m.rows
    offs = np.unique(diag)
    if offs.shape[0] > max_offsets:
        raise ValueError(
            f"{offs.shape[0]} distinct diagonals exceeds max_offsets="
            f"{max_offsets}; DIA only suits banded matrices")
    data = np.zeros((offs.shape[0], m.n), dtype=np.float32)
    data[np.searchsorted(offs, diag), m.rows] = m.vals
    return DIAMatrix(data=_cast(data, dtype, device),
                     offsets=tuple(int(o) for o in offs), n=m.n)


def default_slab_rows(n: int) -> int:
    """Deterministic default B-slab height for :func:`coo_to_binned`
    (512 rows; the CUDA path sizes its slabs from the L2 budget)."""
    return max(1, min(n, 512))


def coo_to_binned(m, dtype=torch.float32, slab_rows: int | None = None,
                  device=None) -> BinnedMatrix:
    """Convert a COO pattern to the slab-binned layout, sorted by (slab,
    column, row)."""
    slab_rows = default_slab_rows(m.n) if slab_rows is None else slab_rows
    if slab_rows < 1:
        raise ValueError(f"slab_rows must be >= 1, got {slab_rows}")
    slabs = m.cols.astype(np.int64) // slab_rows
    order = np.lexsort((m.rows, m.cols, slabs))
    num_slabs = max(1, -(-m.n // slab_rows))
    counts = np.bincount(slabs[order], minlength=num_slabs)
    slab_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return BinnedMatrix(
        data=_cast(m.vals[order].astype(np.float32), dtype, device),
        cols=_idx(m.cols[order].astype(np.int32), device),
        rows=_idx(m.rows[order].astype(np.int32), device),
        slab_ptr=_idx(slab_ptr, device), slab_rows=slab_rows, n=m.n)


def coo_to_rowsplit(m, dtype=torch.float32, chunk: int = 128,
                    device=None) -> RowSplitMatrix:
    """Convert a COO pattern to equal-nnz work chunks."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    order = np.lexsort((m.cols, m.rows))
    padded = -(-max(m.nnz, 0) // chunk) * chunk
    data = np.zeros(padded, dtype=np.float32)
    cols = np.zeros(padded, dtype=np.int32)
    rows = np.zeros(padded, dtype=np.int32)
    data[:m.nnz] = m.vals[order]
    cols[:m.nnz] = m.cols[order]
    rows[:m.nnz] = m.rows[order]
    return RowSplitMatrix(data=_cast(data, dtype, device),
                          cols=_idx(cols, device), rows=_idx(rows, device),
                          chunk=chunk, n=m.n, nnz=m.nnz)


def ell_coo_cutoff(row_degrees) -> int:
    """Storage-optimal ELL body width for the hybrid ELL/COO layout.

    Minimizes ``n * k + 2 * tail_nnz(k)`` over cutoffs ``k``.
    """
    deg = np.asarray(row_degrees, dtype=np.int64).ravel()
    n = deg.shape[0]
    kmax = int(deg.max()) if n else 1
    if kmax <= 1:
        return 1
    hist = np.bincount(deg, minlength=kmax + 1)
    rows_gt = n - np.cumsum(hist[:kmax + 1])       # rows with degree > j
    suffix = np.concatenate([np.cumsum(rows_gt[::-1])[::-1], [0]])
    k_values = np.arange(1, kmax + 1)
    cost = n * k_values + 2 * suffix[1:kmax + 1]
    return int(k_values[int(np.argmin(cost))])


def coo_to_ell_coo(m, dtype=torch.float32, k_cut: int | None = None,
                   device=None) -> ELLCOOMatrix:
    """Convert a COO pattern to the hybrid sorted-ELL + COO-tail layout."""
    deg = np.bincount(m.rows, minlength=m.n)
    if k_cut is None:
        k_cut = ell_coo_cutoff(deg) if m.nnz else 1
    k_cut = max(1, int(k_cut))
    order = np.lexsort((m.cols, m.rows))
    rows = m.rows[order].astype(np.int64)
    cols = m.cols[order]
    vals = m.vals[order].astype(np.float32)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    slot = np.arange(rows.shape[0], dtype=np.int64) - indptr[rows]
    in_body = slot < k_cut
    body_data = np.zeros((m.n, k_cut), dtype=np.float32)
    body_indices = np.zeros((m.n, k_cut), dtype=np.int32)
    body_data[rows[in_body], slot[in_body]] = vals[in_body]
    body_indices[rows[in_body], slot[in_body]] = cols[in_body]
    tail = ~in_body
    return ELLCOOMatrix(
        body_data=_cast(body_data, dtype, device),
        body_indices=_idx(body_indices, device),
        tail_data=_cast(vals[tail], dtype, device),
        tail_cols=_idx(cols[tail].astype(np.int32), device),
        tail_rows=_idx(rows[tail].astype(np.int32), device),
        n=m.n, nnz=m.nnz)


def nnz_balanced_splits(weights, num_shards: int, *,
                        align: int = 1) -> np.ndarray:
    """Contiguous split points balancing a weight vector across shards.

    Returns monotone int64 bounds ``[num_shards + 1]`` with
    ``bounds[0] == 0`` and ``bounds[-1] == n``; cut points are multiples
    of ``align``.  Raises ``ValueError`` on ``num_shards < 1``,
    ``align < 1`` or ``n`` not a multiple of ``align``.
    """
    counts = np.asarray(weights, dtype=np.int64).ravel()
    n = counts.shape[0]
    if num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    if align < 1:
        raise ValueError(f"align must be >= 1, got {align}")
    if n % align != 0:
        raise ValueError(f"{n} items not divisible by align={align}")
    csum = np.concatenate([[0], np.cumsum(counts)])
    cand = np.arange(0, n + 1, align)
    targets = csum[-1] * np.arange(1, num_shards) / num_shards
    pos = np.clip(np.searchsorted(csum[cand], targets), 1, cand.size - 1)
    left, right = cand[pos - 1], cand[pos]
    pick = np.where(targets - csum[left] <= csum[right] - targets,
                    left, right)
    bounds = np.concatenate([[0], pick, [n]])
    return np.maximum.accumulate(bounds).astype(np.int64)


def coo_to_dense(m, dtype=torch.float32, device=None) -> torch.Tensor:
    """Materialize the full dense [n, n] tensor (reference/tests only)."""
    dense = np.zeros((m.n, m.n), dtype=np.float32)
    dense[m.rows, m.cols] = m.vals
    return _cast(dense, dtype, device)
