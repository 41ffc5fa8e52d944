"""Shared helpers of the benchmark's matrix generators: clip, deduplicate
and sort a pattern row-major, and draw its values, on the device."""
from __future__ import annotations

import torch


def finalize(n: int, rows: torch.Tensor, cols: torch.Tensor):
    """Row-major, duplicate-free pattern.

    Returns:
        ``(rows, cols)``: int32 tensors on the inputs' device, sorted by row
        and then column.
    """
    rows, cols = rows.long(), cols.long()
    keep = (rows >= 0) & (rows < n) & (cols >= 0) & (cols < n)
    lin = torch.unique(rows[keep] * n + cols[keep])
    return (lin // n).to(torch.int32), (lin % n).to(torch.int32)


def values(nnz: int, low: float, high: float,
           gen: torch.Generator) -> torch.Tensor:
    """``nnz`` float32 values uniform in ``[low, high)`` on ``gen``'s
    device."""
    out = torch.empty(nnz, dtype=torch.float32, device=gen.device)
    return out.uniform_(low, high, generator=gen)


def uniform(size: int, gen: torch.Generator) -> torch.Tensor:
    """``size`` float64 draws uniform in ``[0, 1)`` on the generator's device."""
    out = torch.empty(size, dtype=torch.float64, device=gen.device)
    return out.uniform_(0.0, 1.0, generator=gen)


def randint(low: int, high: int, size: int,
            gen: torch.Generator) -> torch.Tensor:
    """``size`` int64 draws uniform in ``[low, high)`` on the generator's
    device."""
    return torch.randint(low, high, (size,), generator=gen,
                         device=gen.device)
