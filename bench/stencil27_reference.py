"""Plain reference for a 27-point stencil operator on a 3-D grid (HPCG's).

HPCG's ``GenerateProblem_ref`` builds, on a local ``nx x ny x nz`` grid, a
matrix with one row per grid point ``p = (z * ny + y) * nx + x`` and one
entry per neighbour ``(z + dz, y + dy, x + dx)``, ``dz, dy, dx`` in
``{-1, 0, 1}``, that lies inside the grid (26 on the diagonal and -1
elsewhere there).  Here every point carries its own coefficient per
neighbour, ``coef[s, z, y, x]`` for the ``s``-th of :data:`STENCIL`, and

    C[z, y, x] = sum_s coef[s, z, y, x] * B[z + dz_s, y + dy_s, x + dx_s]

with neighbours outside the grid counting as zero, in float64.  Written
from the grid alone: plain ``torch``, no sparse format, nothing of the
program under test, no JAX.  :func:`coo` gives the same operator as COO
``(rows, cols, vals)`` so the program can be handed it.

The test suite loads this file too; ``bench/stencil27_check.py`` holds a
benchmark run's answers to it at the full grid.
"""
from __future__ import annotations

import itertools
from typing import Optional, Tuple

import torch

#: The 27 neighbour shifts ``(dz, dy, dx)``, in increasing column order.
STENCIL = tuple(itertools.product((-1, 0, 1), repeat=3))


def offsets(nx: int, ny: int) -> Tuple[int, ...]:
    """Column minus row of each shift of :data:`STENCIL`."""
    return tuple(dz * nx * ny + dy * nx + dx for dz, dy, dx in STENCIL)


def random_coefficients(nx: int, ny: int, nz: int, seed: int,
                        low: float = 0.5, high: float = 1.5
                        ) -> torch.Tensor:
    """Float64 ``coef[27, nz, ny, nx]`` uniform in ``[low, high)``."""
    gen = torch.Generator().manual_seed(seed)
    coef = torch.rand((27, nz, ny, nx), generator=gen, dtype=torch.float64)
    return coef * (high - low) + low


def inside(nx: int, ny: int, nz: int, s: int) -> torch.Tensor:
    """Bool ``[nz, ny, nx]``: the points whose ``s``-th neighbour lies
    inside the grid."""
    dz, dy, dx = STENCIL[s]

    def axis(size, shift):
        i = torch.arange(size)
        return (i + shift >= 0) & (i + shift < size)
    return (axis(nz, dz)[:, None, None] & axis(ny, dy)[None, :, None]
            & axis(nx, dx)[None, None, :])


def apply(coef: torch.Tensor, b: torch.Tensor,
          planes: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``C = A @ B`` for the stencil ``coef`` in float64.

    Args:
        coef: ``[27, nz, ny, nx]`` coefficients (any float dtype).
        b: ``[nz * ny * nx, d]`` right-hand sides (any float dtype).
        planes: ``(z0, z1)`` to compute only the rows of z-planes ``z0 <=
            z < z1`` (B is read on planes ``z0 - 1`` to ``z1``); None for
            the whole grid.

    Returns:
        Float64 ``[(z1 - z0) * ny * nx, d]`` on ``b``'s device.
    """
    _, nz, ny, nx = coef.shape
    d = b.shape[1]
    z0, z1 = (0, nz) if planes is None else planes
    lo, hi = max(z0 - 1, 0), min(z1 + 1, nz)
    # B's planes lo..hi-1 with a zero border on every side.
    grid = torch.zeros((hi - lo + 2, ny + 2, nx + 2, d), dtype=torch.float64,
                       device=b.device)
    grid[1:-1, 1:-1, 1:-1] = b[lo * ny * nx:hi * ny * nx].reshape(
        hi - lo, ny, nx, d).double()
    out = torch.zeros((z1 - z0, ny, nx, d), dtype=torch.float64,
                      device=b.device)
    for s, (dz, dy, dx) in enumerate(STENCIL):
        z = z0 + dz - lo + 1
        shifted = grid[z:z + z1 - z0, 1 + dy:1 + dy + ny, 1 + dx:1 + dx + nx]
        mask = inside(nx, ny, nz, s)[z0:z1].to(b.device)
        c = coef[s, z0:z1].to(b.device, torch.float64) * mask
        out += c[..., None] * shifted
    return out.reshape(-1, d)


def coo(coef: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
    """The operator of ``coef`` as row-sorted COO: int64 ``rows``,
    ``cols`` and float64 ``vals``, one entry per point and neighbour
    inside the grid, columns increasing within a row."""
    _, nz, ny, nx = coef.shape
    n = nz * ny * nx
    p = torch.arange(n)
    offs = offsets(nx, ny)
    keep = torch.stack([inside(nx, ny, nz, s).reshape(-1)
                        for s in range(27)], 1)            # [n, 27]
    cols = p[:, None] + torch.tensor(offs)[None, :]
    rows = p[:, None].expand(n, 27)
    vals = coef.reshape(27, n).t().double()
    return rows[keep], cols[keep], vals[keep]
