"""SpMM implementations per sparse layout in plain PyTorch (the ``"torch"``
backend).

The counterparts of the reference's pure-JAX implementations, and the
reference semantics the CUDA kernels are held against:

  csr_spmm       gather rows of B per nonzero, multiply, segment-sum by row.
  ell_spmm       padded column-slot loop.
  bcsr_spmm      batched dense t x t block products + block-row sum.
  dia_spmm       per-diagonal static shift and axpy.
  binned_spmm    slab-major gather/segment-sum.
  rowsplit_spmm  equal-nnz chunk gather/segment-sum.
  ell_coo_spmm   ELL body slot loop + COO-tail gather/segment-sum.

All return ``C = A @ B`` as ``[n, d]`` in B's dtype.  Products round at
the operand dtype; every sum runs in fp32 (``index_add_`` into an fp32
buffer, fp32 block products) and the result is cast once at the end.
Gathers run in slices so a large operand never materialises more than
:data:`STEP` gathered values at once.
"""
from __future__ import annotations

import torch

from repro_torch.sparse.formats import (
    BCSRMatrix, BinnedMatrix, CSRMatrix, DIAMatrix, ELLCOOMatrix, ELLMatrix,
    RowSplitMatrix)

#: Gathered values materialised per slice of a gather/segment-sum.
STEP = 1 << 26


def segment_sum(out: torch.Tensor, b: torch.Tensor, cols: torch.Tensor,
                vals: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``out[rows[k]] += B[cols[k]] * vals[k]`` in fp32, sliced."""
    d = b.shape[1]
    step = max(1, STEP // max(d, 1))
    for lo in range(0, cols.shape[0], step):
        scaled = b[cols[lo:lo + step].long()] * vals[lo:lo + step, None]
        out.index_add_(0, rows[lo:lo + step].long(),
                       scaled.to(torch.float32))
    return out


def _zeros(n: int, b: torch.Tensor) -> torch.Tensor:
    return torch.zeros(n, b.shape[1], dtype=torch.float32, device=b.device)


def csr_spmm(a: CSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """C[r] += val * B[c] for every nonzero (r, c, val)."""
    return segment_sum(_zeros(a.n, b), b, a.indices, a.data,
                       a.row_ids).to(b.dtype)


def ell_spmm(a: ELLMatrix, b: torch.Tensor) -> torch.Tensor:
    """Loop over the padded slots; zero padding contributes nothing."""
    out = _zeros(a.n, b)
    for k in range(a.k):
        out += (b[a.indices[:, k].long()] * a.data[:, k, None]).to(
            torch.float32)
    return out.to(b.dtype)


def bcsr_spmm(a: BCSRMatrix, b: torch.Tensor) -> torch.Tensor:
    """Batched block products: each nonzero block multiplies its B column
    tile in fp32 and accumulates into its row tile."""
    d = b.shape[1]
    b_tiles = b.reshape(a.nb, a.t, d)
    out = torch.zeros(a.nb, a.t, d, dtype=torch.float32, device=b.device)
    step = max(1, STEP // max(a.t * d, 1))
    for lo in range(0, a.num_blocks, step):
        prods = torch.bmm(a.blocks[lo:lo + step].to(torch.float32),
                          b_tiles[a.block_cols[lo:lo + step].long()]
                          .to(torch.float32))
        out.index_add_(0, a.block_rows[lo:lo + step].long(), prods)
    return out.reshape(a.n, d).to(b.dtype)


def dia_spmm(a: DIAMatrix, b: torch.Tensor) -> torch.Tensor:
    """C[r] += diag_k[r] * B[r + off_k], one static shift per offset."""
    n, d = a.n, b.shape[1]
    out = _zeros(n, b)
    for i, off in enumerate(a.offsets):
        zeros = torch.zeros(abs(off), d, dtype=b.dtype, device=b.device)
        if off >= 0:
            shifted = torch.cat([b[off:], zeros]) if off else b
        else:
            shifted = torch.cat([zeros, b[:n + off]])
        out += (a.data[i][:, None] * shifted).to(torch.float32)
    return out.to(b.dtype)


def binned_spmm(a: BinnedMatrix, b: torch.Tensor) -> torch.Tensor:
    """Slab-major gather/segment-sum: the algebra of :func:`csr_spmm` in
    the slab-binned order."""
    return segment_sum(_zeros(a.n, b), b, a.cols, a.data,
                       a.rows).to(b.dtype)


def rowsplit_spmm(a: RowSplitMatrix, b: torch.Tensor) -> torch.Tensor:
    """Equal-nnz chunk traversal; padding entries carry value 0 at row 0."""
    return segment_sum(_zeros(a.n, b), b, a.cols, a.data,
                       a.rows).to(b.dtype)


def ell_coo_spmm(a: ELLCOOMatrix, b: torch.Tensor) -> torch.Tensor:
    """ELL body slot loop up to ``k_cut`` plus a COO-tail segment sum."""
    out = _zeros(a.n, b)
    for k in range(a.k_cut):
        out += (b[a.body_indices[:, k].long()]
                * a.body_data[:, k, None]).to(torch.float32)
    if a.tail_nnz:
        out += segment_sum(_zeros(a.n, b), b, a.tail_cols, a.tail_data,
                           a.tail_rows)
    return out.to(b.dtype)


def dense_spmm(a_dense: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense reference (a plain matrix product) — the comparison point."""
    return a_dense @ b


IMPLEMENTATIONS = {
    "csr": csr_spmm,
    "ell": ell_spmm,
    "bcsr": bcsr_spmm,
    "dia": dia_spmm,
    "binned": binned_spmm,
    "rowsplit": rowsplit_spmm,
    "ell_coo": ell_coo_spmm,
}
