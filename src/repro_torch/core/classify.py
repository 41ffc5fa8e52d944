"""Sparsity-structure classifier: recover the paper's regime + model
parameters from a concrete matrix.

The paper groups matrices by hand; a deployable system needs to *detect* the
regime so the right roofline model (and the right kernel) is selected
automatically.  The detector computes cheap structural statistics on the COO
pattern and scores each regime:

  diagonal    fraction of nnz within a small band of the main diagonal
  blocked     block-occupancy statistics at a probe block size t
              (paper's D = nnz/N and z = occupied columns per block)
  scale_free  tail heaviness of the degree distribution (Hill estimator of
              alpha, plus Gini coefficient of degree mass)
  random      the fallback when no structure is detected

Returns the regime, the fitted parameters for the matching AI model, and the
full statistics so callers can audit the decision.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.patterns import COOMatrix
from repro_torch.core import sparsity_models as sm


@dataclasses.dataclass(frozen=True)
class StructureReport:
    regime: str
    params: dict
    stats: dict

    def traffic(self, d: int, **overrides) -> sm.TrafficBreakdown:
        """Arithmetic-intensity estimate for this matrix at dense width d."""
        kwargs = dict(self.params)
        kwargs.update(overrides)
        n = self.stats["n"]
        nnz = self.stats["nnz"]
        return sm.arithmetic_intensity(self.regime, n, nnz, d, **kwargs)


def band_fraction(m: COOMatrix, rel_bandwidth: float = 0.01) -> float:
    """Fraction of nonzeros within a small band of the main diagonal.

    The window is ``rel_bandwidth * n`` wide with an absolute floor of
    ``min(8, n // 8)``: at corpus scales (n of a few hundred) a purely
    relative window is 1–2 entries wide and misses real FEM/DFT bands
    entirely — a bandwidth-5 matrix at n=224 measured 0.33 here and
    fell through to ``random``.
    """
    if m.nnz == 0:
        return 0.0
    w = max(1, int(m.n * rel_bandwidth), min(8, m.n // 8))
    return float(np.mean(np.abs(m.rows.astype(np.int64) - m.cols) < w))


def block_stats(m: COOMatrix, t: int = 64) -> dict:
    """Paper Section III-C statistics at probe block size t.

    Returns N (nonzero blocks), D (nnz per block), z_emp (measured occupied
    columns per block) and z_model (the paper's t(1-e^{-D/t}) prediction).
    """
    bi = m.rows.astype(np.int64) // t
    bj = m.cols.astype(np.int64) // t
    nb = (m.n + t - 1) // t
    blin = bi * nb + bj
    uniq_blocks, counts = np.unique(blin, return_counts=True)
    N = int(uniq_blocks.shape[0])
    D = m.nnz / max(N, 1)
    # Occupied columns per block: unique (block, col-within-block) pairs.
    col_in_block = (m.cols.astype(np.int64) % t)
    pair = blin * t + col_in_block
    occupied = np.unique(pair).shape[0]
    z_emp = occupied / max(N, 1)
    return {
        "t": t, "N": N, "D": float(D), "z_emp": float(z_emp),
        "z_model": sm.expected_occupied_columns(t, D),
        "block_fill": float(D / (t * t)),
    }


#: Minimum positive-degree sample for a meaningful Hill fit.  Below it
#: the estimator returns ``inf`` ("no detectable heavy tail") *by
#: design* — the scale-free gate in :func:`classify` then cannot fire,
#: so tiny matrices fall through to the block/random ladder instead of
#: being tail-classified off a handful of degrees.
HILL_MIN_DEGREES = 16


def hill_alpha(degrees: np.ndarray, tail_fraction: float = 0.05) -> float:
    """Hill estimator of the power-law exponent on the degree tail.

    Returns ``inf`` — explicitly meaning *no detectable heavy tail* —
    when the estimate is not meaningful: fewer than
    :data:`HILL_MIN_DEGREES` positive degrees, or a flat tail
    (``x_(k)`` equals the tail values, e.g. uniform or banded degree
    vectors).  Callers gate on a finite range (``classify`` uses
    ``1.5 < alpha < 3.5``), so ``inf`` always reads as "not
    scale-free".

    The tail index ``k`` is clamped to at most half the sample: the old
    ``k = min(k, size - 1)`` clamp let ``x_(k)`` be the *minimum*
    degree on small vectors, which silently degenerated the estimator
    (tail == whole distribution) and returned ``inf`` for genuinely
    skewed small matrices — the corpus-audit misclassification this
    clamp fixes.
    """
    deg = degrees[degrees > 0]
    if deg.size < HILL_MIN_DEGREES:
        return float("inf")
    deg = np.sort(deg)[::-1].astype(np.float64)
    k = int(np.clip(max(8, int(deg.size * tail_fraction)),
                    1, deg.size // 2))
    tail = deg[:k]
    x_k = deg[k]
    if x_k <= 0:
        return float("inf")
    hill = np.mean(np.log(tail / x_k))
    if hill <= 0:
        return float("inf")
    return 1.0 + 1.0 / float(hill)


def hub_dominance(degrees: np.ndarray, top_fraction: float = 0.01) -> float:
    """Edge share of the top ``top_fraction`` of nodes, relative to uniform.

    1.0 means the heaviest 1% of nodes own exactly their uniform share
    of the edges; scale-free hub structure measures an order of
    magnitude higher.  Unlike the Gini coefficient this statistic does
    not wash out at small n (where the power-law's ``kmax`` truncation
    compresses the whole distribution): the corpus-scale matrices that
    motivated it measure Gini ~0.49 but dominance ~9-13x.
    """
    total = degrees.sum()
    if total == 0:
        return 0.0
    top = max(1, int(np.ceil(degrees.size * top_fraction)))
    share = np.sort(degrees)[::-1][:top].sum() / total
    return float(share / (top / degrees.size))


def degree_gini(degrees: np.ndarray) -> float:
    """Gini coefficient of the degree distribution (0 = uniform, 1 = hub)."""
    d = np.sort(degrees.astype(np.float64))
    if d.sum() == 0:
        return 0.0
    n = d.size
    cum = np.cumsum(d)
    return float((n + 1 - 2 * (cum / cum[-1]).sum()) / n)


def classify(m: COOMatrix, probe_t: int = 64) -> StructureReport:
    """Detect the sparsity regime and fit the corresponding model params.

    Degree-tail statistics are computed on *both* axes and the
    heavier-tailed side (by Gini) drives the scale-free gate: hub
    structure lives in whichever axis concentrates the edges, and a
    column-hub matrix (e.g. the transpose of a scale-free web graph)
    has perfectly uniform row degrees — row-only statistics would let
    it fall through to ``random`` and pick the wrong AI model.  Both
    sides are recorded (``row_gini`` / ``col_gini`` / ``tail_axis``)
    so the decision is auditable.
    """
    row_deg = np.bincount(m.rows, minlength=m.n)
    col_deg = np.bincount(m.cols, minlength=m.n)
    row_gini, col_gini = degree_gini(row_deg), degree_gini(col_deg)
    tail_axis = "col" if col_gini > row_gini else "row"
    tail_deg = col_deg if tail_axis == "col" else row_deg
    bstats = block_stats(m, probe_t)
    stats = {
        "n": m.n,
        "nnz": m.nnz,
        "avg_degree": m.nnz / m.n,
        "band_fraction": band_fraction(m),
        "alpha_hill": hill_alpha(tail_deg),
        "degree_gini": degree_gini(tail_deg),
        "hub_dominance": hub_dominance(tail_deg),
        "row_gini": row_gini,
        "col_gini": col_gini,
        "tail_axis": tail_axis,
        **{f"block_{k}": v for k, v in bstats.items()},
    }

    # --- Decision ladder (most-specific structure first). ---
    if stats["band_fraction"] > 0.95 and stats["avg_degree"] < probe_t:
        return StructureReport("diagonal", {}, stats)

    # Scale-free gate: a heavy tail (finite Hill alpha in the paper's
    # modeled band) concentrated either globally (Gini) or in explicit
    # hubs (dominance — the small-matrix signal: at corpus scales the
    # kmax truncation keeps Gini below the 0.55 cut while the top 1% of
    # nodes still own ~10x their uniform edge share).
    gini = stats["degree_gini"]
    alpha = stats["alpha_hill"]
    if (gini > 0.55 or stats["hub_dominance"] > 7.0) and 1.5 < alpha < 3.5:
        return StructureReport(
            "scale_free", {"alpha": float(min(max(alpha, 2.05), 2.95)),
                           "hub_fraction": 0.001}, stats)

    # Blocked: the measured occupancy is far denser than a random pattern
    # of the same nnz would produce (random => N ~ min(nnz, nb^2), D ~ 1).
    # Small matrices re-probe at probe_t // 2: with fewer than ~16 block
    # rows at the primary probe the occupancy contrast is statistically
    # meaningless (a 256-row matrix has 16 probe-64 blocks total), which
    # sent every corpus-scale blocked matrix to ``random``.
    probes = [probe_t]
    if m.n < 16 * probe_t and probe_t >= 4:
        probes.append(probe_t // 2)
    for t in probes:
        bs = bstats if t == probe_t else block_stats(m, t)
        nb = (m.n + t - 1) // t
        expected_random_blocks = min(m.nnz, nb * nb)
        if bs["N"] < 0.5 * expected_random_blocks and bs["D"] > 4.0:
            stats.update({f"block_{k}": v for k, v in bs.items()})
            return StructureReport(
                "blocked", {"t": t, "num_blocks": bs["N"]}, stats)

    return StructureReport("random", {}, stats)
