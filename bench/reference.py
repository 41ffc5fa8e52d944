"""The plain reference for C = A @ B and the comparison that decides ``correct``.

Plain PyTorch on the benchmark's own COO arrays and the same B tensors the
program was given: each block of rows gathers the B rows its nonzeros
name, multiplies them by the values in float64 and sums them into C with
``index_add_``. Nothing here imports the program or reads what it made.

The number compared is the largest elementwise error of the program's C
against this float64 C, each element measured against the sum of
magnitudes that forms it, ``(|A| @ |B|)_ij``. An element whose sum of
magnitudes is 0 (an empty row) must be exactly 0, else its error is
infinite.
"""
from __future__ import annotations

import numpy as np
import torch

#: Float64 elements one block of the reference holds per gathered operand.
BLOCK_ELEMENTS = 2**26


def row_ptr(rows: torch.Tensor, n: int) -> torch.Tensor:
    """CSR row pointers (int64 ``[n + 1]``) of row-sorted COO row ids."""
    counts = torch.bincount(rows.long(), minlength=n)
    return torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])


def row_blocks(ptr: np.ndarray, d: int,
               elements: int = BLOCK_ELEMENTS) -> list:
    """Split the rows into ``(r0, r1)`` blocks of about ``elements / d``
    nonzeros each; a row is never split."""
    nnz = int(ptr[-1])
    n = len(ptr) - 1
    step = max(elements // max(d, 1), 1)
    cuts = np.searchsorted(ptr, np.arange(step, nnz, step), side="left")
    edges = np.unique(np.concatenate([[0], cuts, [n]])).tolist()
    return list(zip(edges[:-1], edges[1:]))


def reference_block(rows, cols, vals, b, ptr_host, r0: int, r1: int):
    """Float64 ``C[r0:r1]`` and ``(|A| @ |B|)[r0:r1]``."""
    lo, hi = int(ptr_host[r0]), int(ptr_host[r1])
    local = (rows[lo:hi].long() - r0)
    prod = vals[lo:hi].double().unsqueeze(1) * b[cols[lo:hi].long()].double()
    c = torch.zeros(r1 - r0, b.shape[1], dtype=torch.float64,
                    device=b.device)
    s = torch.zeros_like(c)
    c.index_add_(0, local, prod)
    s.index_add_(0, local, prod.abs_())
    return c, s


def max_rel_err(rows: torch.Tensor, cols: torch.Tensor, vals: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor) -> float:
    """Largest ``|C - C_ref| / (|A| @ |B|)`` over every element of ``c``.

    Args:
        rows, cols, vals: the operator as row-sorted COO (``vals`` as the
            program was given them).
        b: the right-hand side ``[n, d]`` the program was given.
        c: the program's answer ``[n, d]``, any float dtype.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n, d = b.shape
    if tuple(c.shape) != (n, d):
        return float("inf")
    ptr_host = row_ptr(rows, n).cpu().numpy()
    worst = 0.0
    for r0, r1 in row_blocks(ptr_host, d):
        ref, mag = reference_block(rows, cols, vals, b, ptr_host, r0, r1)
        diff = (c[r0:r1].double() - ref).abs_().nan_to_num_(nan=float("inf"))
        err = torch.where(mag > 0, diff / mag.clamp_min(1e-300),
                          torch.where(diff > 0, float("inf"), 0.0))
        worst = max(worst, float(err.max()))
        if not np.isfinite(worst):
            break
    return worst
