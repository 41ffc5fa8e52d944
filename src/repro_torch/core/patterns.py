"""Sparse-pattern generators mirroring the paper's matrix classes (Table III).

The paper evaluates four structural regimes drawn from SuiteSparse plus
synthetic generators.  SuiteSparse is unavailable offline, so we generate each
regime synthetically with the same statistical definitions the paper's models
assume:

  random      Erdos-Renyi, ``er_<log2 n>_<avg_deg>`` (the paper's own generator)
  diagonal    banded matrices, incl. the paper's ``ideal_diagonal`` (1 nnz/row)
  blocked     t x t blocks placed uniformly, D nonzeros per block on average
  scale_free  power-law degree distribution p(k) ~ k^-alpha (configuration-style)

Everything is plain numpy COO -> sorted CSR arrays; no scipy dependency.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class COOMatrix:
    """Deduplicated, row-major-sorted COO pattern with values."""

    n: int
    rows: np.ndarray       # int32 [nnz]
    cols: np.ndarray       # int32 [nnz]
    vals: np.ndarray       # float [nnz]
    pattern: str           # generator regime tag
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def row_ptr(self) -> np.ndarray:
        """CSR row pointers (int32 [n+1])."""
        counts = np.bincount(self.rows, minlength=self.n)
        return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def _finalize(n: int, rows: np.ndarray, cols: np.ndarray, pattern: str,
              rng: np.random.Generator, meta: dict | None = None) -> COOMatrix:
    """Clip, deduplicate, sort row-major, and attach random values.

    Deduplication means a generator can deliver fewer nonzeros than it
    drew (birthday collisions); the *achieved* density is therefore
    recorded in ``meta`` (``achieved_nnz`` / ``achieved_avg_degree``) so
    downstream consumers — suite labels, roofline inputs, the corpus
    fitter — never have to assume the nominal request was met.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    keep = (rows >= 0) & (rows < n) & (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    # Dedup via linear index.
    lin = rows * n + cols
    lin = np.unique(lin)
    rows = (lin // n).astype(np.int32)
    cols = (lin % n).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, size=rows.shape[0]).astype(np.float64)
    meta = dict(meta or {})
    meta["achieved_nnz"] = int(rows.shape[0])
    meta["achieved_avg_degree"] = rows.shape[0] / max(n, 1)
    return COOMatrix(n=n, rows=rows, cols=cols, vals=vals, pattern=pattern,
                     meta=meta)


def erdos_renyi(n: int, avg_degree: float, seed: int = 0) -> COOMatrix:
    """Uniform random sparsity: the paper's ``er_*`` matrices.

    Delivers *exactly* ``round(n * avg_degree)`` nonzeros (capped at the
    dense n^2): duplicate draws are resampled until the target is met,
    so suite labels like ``er_16_20`` and the roofline's nnz inputs mean
    what they say.  (The naive draw-then-dedup loses ~avg_degree/(2n) of
    its entries to birthday collisions — measurable at benchmark scales.)
    """
    rng = np.random.default_rng(seed)
    target = min(int(round(n * avg_degree)), n * n)
    lin = np.unique(rng.integers(0, n * n, size=target))
    while lin.size < target:
        extra = rng.integers(0, n * n, size=2 * (target - lin.size) + 16)
        lin = np.union1d(lin, extra)
    if lin.size > target:
        # Unbiased truncation: np.unique sorted the draws, so keeping a
        # prefix would skew the pattern toward low row indices.
        lin = np.sort(rng.choice(lin, size=target, replace=False))
    return _finalize(n, lin // n, lin % n, "random", rng,
                     {"avg_degree": avg_degree})


def banded(n: int, bandwidth: int = 1, fill: float = 1.0,
           seed: int = 0) -> COOMatrix:
    """Diagonal/banded sparsity.

    bandwidth=1, fill=1 reproduces ``ideal_diagonal`` (exactly one nonzero per
    row on the main diagonal).  Larger bandwidths emulate FEM/DFT-style bands;
    ``fill`` < 1 drops entries at random to mimic imperfect bands (rajat31).
    """
    rng = np.random.default_rng(seed)
    offsets = np.arange(-(bandwidth - 1), bandwidth)
    if bandwidth == 1:
        offsets = np.array([0])
    rows_list, cols_list = [], []
    for off in offsets:
        r = np.arange(max(0, -off), min(n, n - off))
        c = r + off
        if fill < 1.0:
            keep = rng.uniform(size=r.shape[0]) < fill
            r, c = r[keep], c[keep]
        rows_list.append(r)
        cols_list.append(c)
    rows = np.concatenate(rows_list)
    cols = np.concatenate(cols_list)
    return _finalize(n, rows, cols, "diagonal", rng,
                     {"bandwidth": bandwidth, "fill": fill})


def blocked(n: int, t: int, num_blocks: int, nnz_per_block: float,
            seed: int = 0, diagonal_bias: float = 0.5) -> COOMatrix:
    """Block-structured sparsity: ``num_blocks`` t x t blocks, each with an
    average of ``nnz_per_block`` (the paper's D) nonzeros placed uniformly
    inside the block.

    ``diagonal_bias`` fraction of the blocks hug the diagonal (road-network
    style locality); the remainder are uniform.
    """
    rng = np.random.default_rng(seed)
    nb = n // t
    if nb == 0:
        raise ValueError("block size exceeds matrix size")
    num_blocks = min(num_blocks, nb * nb)
    n_diag = int(num_blocks * diagonal_bias)
    # Diagonal-ish blocks: near the main block diagonal.
    bi = rng.integers(0, nb, size=n_diag)
    bj = np.clip(bi + rng.integers(-1, 2, size=n_diag), 0, nb - 1)
    # Uniform blocks for the rest.
    bi2 = rng.integers(0, nb, size=num_blocks - n_diag)
    bj2 = rng.integers(0, nb, size=num_blocks - n_diag)
    block_i = np.concatenate([bi, bi2])
    block_j = np.concatenate([bj, bj2])
    # Dedup block coordinates.
    blin = np.unique(block_i.astype(np.int64) * nb + block_j)
    block_i = (blin // nb).astype(np.int64)
    block_j = (blin % nb).astype(np.int64)
    N = block_i.shape[0]
    per_block = rng.poisson(nnz_per_block, size=N).clip(1, t * t)
    total = int(per_block.sum())
    block_of_entry = np.repeat(np.arange(N), per_block)
    rr = rng.integers(0, t, size=total)
    cc = rng.integers(0, t, size=total)
    rows = block_i[block_of_entry] * t + rr
    cols = block_j[block_of_entry] * t + cc
    return _finalize(n, rows, cols, "blocked", rng,
                     {"t": t, "num_blocks": N, "D": float(nnz_per_block)})


def scale_free(n: int, avg_degree: float, alpha: float = 2.2,
               seed: int = 0, k_min: int = 1,
               hub_fraction: float = 0.001) -> COOMatrix:
    """Power-law (scale-free) sparsity matching the paper's hub model.

    Row (out-)degrees follow a truncated power law p(k) ~ k^-alpha.
    Columns realize the appendix's hub structure explicitly: the top
    ``hub_fraction`` of nodes receive nnz * f^((alpha-2)/(alpha-1)) of the
    edges (Eq. 5); remaining edges land uniformly.  This makes the B-row
    reuse the paper's Eq. 6 assumes actually measurable.
    """
    rng = np.random.default_rng(seed)
    # Row degrees: inverse-CDF power law, truncated and rescaled.
    u = rng.uniform(size=n)
    kmax = max(n // 4, k_min + 1)
    k = k_min * u ** (-1.0 / (alpha - 1.0))
    k = np.minimum(k, kmax)
    k = np.maximum(k * (avg_degree * n / k.sum()), 0).astype(np.int64)
    total = int(k.sum())
    rows = np.repeat(np.arange(n), k)
    # Columns: hub mass per the appendix derivation.
    from repro_torch.core.sparsity_models import hub_edge_fraction
    n_hub = max(1, int(n * hub_fraction))
    hub_mass = hub_edge_fraction(alpha, hub_fraction)
    is_hub_edge = rng.uniform(size=total) < hub_mass
    # Hub popularity is itself heavy-tailed (zipf over the hub set).
    hub_ranks = rng.zipf(1.5, size=total) % n_hub
    hub_cols = hub_ranks * (n // n_hub)          # spread hubs over ids
    uniform_cols = rng.integers(0, n, size=total)
    cols = np.where(is_hub_edge, hub_cols, uniform_cols)
    return _finalize(n, rows, cols, "scale_free", rng,
                     {"alpha": alpha, "avg_degree": avg_degree,
                      "hub_fraction": hub_fraction})


def fit_generator(report, *, n: int | None = None,
                  seed: int = 0) -> COOMatrix:
    """Synthesize a matrix fitted to a real matrix's measured statistics.

    The corpus layer's bridge back to the generators: given the
    :class:`repro_torch.core.classify.StructureReport` of a real (e.g.
    vendored or SuiteSparse) matrix, return a synthetic ``COOMatrix`` of
    the same regime whose generator parameters are read off the report —

      diagonal    bandwidth/fill from the measured band fraction and
                  average degree
      blocked     probe block size t, block count N, and block density D
                  straight from the report's block statistics
      scale_free  Hill-estimated alpha (clamped to the paper's modeled
                  range) at the measured average degree
      random      Erdos-Renyi at the measured average degree

    Args:
        report: a ``StructureReport`` from ``classify(real_matrix)``.
        n: optional size override — scale the fitted structure up or down
            (block counts scale proportionally; densities are preserved).
        seed: generator seed.

    Returns:
        A synthetic ``COOMatrix`` with ``meta["fitted_from"]`` recording
        the source statistics the parameters were read from.
    """
    stats = report.stats
    src_n = int(stats["n"])
    n = int(n or src_n)
    avg_degree = stats["nnz"] / max(src_n, 1)
    if report.regime == "diagonal":
        # avg_degree nonzeros per row spread over a (2*bw - 1)-wide band.
        bw = max(1, int(round((avg_degree + 1) / 2)))
        width = 1 if bw == 1 else 2 * bw - 1
        fill = float(np.clip(avg_degree / width, 0.05, 1.0))
        m = banded(n, bw, fill=fill, seed=seed)
    elif report.regime == "blocked":
        t = int(stats.get("block_t", 64))
        t = min(t, n)
        num_blocks = max(1, int(round(stats.get("block_N", 1) * n / src_n)))
        m = blocked(n, t=t, num_blocks=num_blocks,
                    nnz_per_block=max(stats.get("block_D", 1.0), 1.0),
                    seed=seed)
    elif report.regime == "scale_free":
        alpha = report.params.get("alpha", stats.get("alpha_hill", 2.2))
        alpha = float(np.clip(alpha, 2.05, 2.95))
        hub_fraction = report.params.get("hub_fraction", 0.001)
        m = scale_free(n, max(avg_degree, 1.0), alpha=alpha, seed=seed,
                       hub_fraction=hub_fraction)
    else:
        m = erdos_renyi(n, max(avg_degree, 1.0), seed=seed)
    fitted_from = {"regime": report.regime, "n": src_n,
                   "nnz": int(stats["nnz"]),
                   "band_fraction": stats.get("band_fraction"),
                   "alpha_hill": stats.get("alpha_hill"),
                   "block_D": stats.get("block_D"),
                   "block_z_emp": stats.get("block_z_emp")}
    return dataclasses.replace(m, meta={**m.meta,
                                        "fitted_from": fitted_from})


#: The reduced-scale reproduction suite standing in for the paper's Table III.
#: Names follow the paper's convention; sizes are scaled to container memory
#: while staying far larger than host caches (the paper's selection criterion).
def paper_suite(scale: int = 16):
    """Return the dict of generator thunks for the benchmark suite.

    ``scale`` is log2(n).  At the default 2**16 = 65,536 rows the working sets
    (B, C at d=64: 64 MB) exceed this host's LLC, preserving the paper's
    out-of-cache regime.
    """
    n = 2 ** scale
    return {
        # Random (paper: er_22_{1,10,20})
        f"er_{scale}_1": lambda: erdos_renyi(n, 1, seed=1),
        f"er_{scale}_10": lambda: erdos_renyi(n, 10, seed=2),
        f"er_{scale}_20": lambda: erdos_renyi(n, 20, seed=3),
        # Diagonal (paper: ideal_diagonal_22, rajat31)
        f"ideal_diagonal_{scale}": lambda: banded(n, 1, seed=4),
        f"band_{scale}_5": lambda: banded(n, 5, fill=0.8, seed=5),
        # Blocked (paper: road_usa, asia_osm, ...: mesh-local structure)
        f"blocked_{scale}_d64": lambda: blocked(
            n, t=64, num_blocks=max(1, n // 32), nnz_per_block=40, seed=6),
        # FEM-style dense small blocks (stiffness matrices): the regime
        # where dense-block storage (CSB/BCSR) genuinely pays off.
        f"fem_{scale}_t32": lambda: blocked(
            n, t=32, num_blocks=max(1, n // 16), nnz_per_block=320, seed=7),
        # Scale-free (paper: com-Orkut, com-LiveJournal, uk-2002)
        f"powerlaw_{scale}_22": lambda: scale_free(n, 16, alpha=2.2, seed=8),
        f"powerlaw_{scale}_28": lambda: scale_free(n, 16, alpha=2.8, seed=9),
        # High skew (alpha -> 2): the heaviest hubs the generator makes —
        # the regime the binned and row-split kernels target.
        f"powerlaw_{scale}_205": lambda: scale_free(
            n, 16, alpha=2.05, seed=10),
    }


def block_diagonal(n: int, t: int = 64, seed: int = 0) -> COOMatrix:
    """Dense t x t blocks on the diagonal: the MoE expert-dispatch shape.

    ``repro.models.moe`` routes tokens into per-expert capacity buckets,
    which makes the expert FFN exactly this operator (the best case of the
    blocked regime: z = t, MXU utilization 1).  Requires ``t`` to divide
    ``n``.
    """
    if n % t != 0:
        raise ValueError(f"n must be a multiple of t={t}, got {n}")
    nb = n // t
    rng = np.random.default_rng(seed)
    base = np.repeat(np.arange(nb, dtype=np.int64) * t, t * t)
    rr = np.tile(np.repeat(np.arange(t), t), nb)
    cc = np.tile(np.tile(np.arange(t), t), nb)
    rows = (base + rr).astype(np.int32)
    cols = (base + cc).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, size=rows.shape[0]).astype(np.float64)
    return COOMatrix(n=n, rows=rows, cols=cols, vals=vals,
                     pattern="blocked",
                     meta={"t": t, "num_blocks": nb, "D": float(t * t)})


def serving_suite(n: int):
    """The four paper structures at serving scale (generator thunks).

    The single registry shared by the streamed-dispatch surfaces —
    ``repro_torch.launch.serve --spmm-stream`` and ``chip_smoke.py`` —
    so the serving demo and the CI-gated suite measure the same
    operators.
    """
    return {
        "moe-block": lambda: block_diagonal(n, 64, seed=0),
        "banded": lambda: banded(n, 5, fill=0.9, seed=5),
        "scale-free": lambda: scale_free(n, 16, alpha=2.2, seed=8),
        "uniform": lambda: erdos_renyi(n, 10, seed=2),
    }
