"""Power-law (scale-free) operator, after the SpMM roofline paper's hub model.

Row degrees follow a truncated power law p(k) ~ k^-alpha, rescaled to the
requested average degree. The top ``hub_fraction`` of columns receive the
share f^((alpha - 2) / (alpha - 1)) of the edges (the paper's Eq. 5), with
hub popularity itself heavy-tailed (a discrete power law of exponent
``hub_zipf`` folded onto the hubs); the other edges land uniformly.
Duplicates are dropped, so the achieved degree is below the requested one.
"""
from __future__ import annotations

import torch

from bench.coo import finalize, randint, uniform


def hub_edge_fraction(alpha: float, f: float) -> float:
    """The paper's Eq. 5: nnz_hub / nnz = f^((alpha - 2) / (alpha - 1))."""
    return f ** ((alpha - 2.0) / (alpha - 1.0))


def generate(n: int, params: dict, gen: torch.Generator):
    """``(rows, cols)`` of the pattern on ``gen``'s device."""
    alpha = float(params["alpha"])
    k_min = int(params.get("k_min", 1))
    kmax = max(n // 4, k_min + 1)
    k = k_min * uniform(n, gen).pow(-1.0 / (alpha - 1.0))
    k = k.clamp_max(kmax)
    k = (k * (float(params["avg_degree"]) * n / k.sum())).floor().long()
    rows = torch.repeat_interleave(
        torch.arange(n, device=gen.device), k.clamp_min(0))
    total = rows.numel()
    f = float(params["hub_fraction"])
    n_hub = max(1, int(n * f))
    is_hub = uniform(total, gen) < hub_edge_fraction(alpha, f)
    # k = floor(u^(-1 / (a - 1))) has p(k) ~ k^-a for large k.
    zipf = float(params.get("hub_zipf", 1.5))
    ranks = uniform(total, gen).clamp_min(1e-300).pow(-1.0 / (zipf - 1.0))
    ranks = ranks.clamp_max(2.0**62).long() % n_hub
    cols = torch.where(is_hub, ranks * (n // n_hub),
                       randint(0, n, total, gen))
    return finalize(n, rows, cols)
