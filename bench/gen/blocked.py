"""Block-structured operator (FEM stiffness style), after the paper's
blocked class: ``num_blocks`` t x t blocks, a ``diagonal_bias`` share of them
on or next to the block diagonal and the rest uniform, each with a
Poisson(``nnz_per_block``) count of entries placed uniformly inside it.
Duplicate blocks and entries are dropped.
"""
from __future__ import annotations

import torch

from bench.coo import finalize, randint


def generate(n: int, params: dict, gen: torch.Generator):
    """``(rows, cols)`` of the pattern on ``gen``'s device."""
    t = int(params["t"])
    nb = n // t
    if nb == 0:
        raise ValueError("block size exceeds matrix size")
    num_blocks = min(int(params["num_blocks"]), nb * nb)
    n_diag = int(num_blocks * float(params["diagonal_bias"]))
    bi = randint(0, nb, n_diag, gen)
    bj = (bi + randint(-1, 2, n_diag, gen)).clamp(0, nb - 1)
    bi2 = randint(0, nb, num_blocks - n_diag, gen)
    bj2 = randint(0, nb, num_blocks - n_diag, gen)
    blin = torch.unique(torch.cat([bi, bi2]) * nb + torch.cat([bj, bj2]))
    block_i, block_j = blin // nb, blin % nb
    rate = torch.full((blin.numel(),), float(params["nnz_per_block"]),
                      dtype=torch.float32, device=gen.device)
    per_block = torch.poisson(rate, generator=gen).long().clamp(1, t * t)
    owner = torch.repeat_interleave(
        torch.arange(blin.numel(), device=gen.device), per_block)
    total = owner.numel()
    rows = block_i[owner] * t + randint(0, t, total, gen)
    cols = block_j[owner] * t + randint(0, t, total, gen)
    return finalize(n, rows, cols)
