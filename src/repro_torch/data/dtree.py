"""SpChar-style learned dispatch fallback: a dependency-free decision tree.

The analytic roofline ranks formats from first principles; SpChar
(Sgherzi et al., 2023, arXiv 2304.06944) shows that a small decision
tree over cheap structural features predicts the winning implementation
where analytic models are within noise of each other.  This module is
that fallback, deliberately minimal:

  * pure NumPy CART (Gini impurity, axis-aligned splits) — no sklearn,
    nothing the container doesn't already have;
  * features are a fixed, named subset of ``StructureReport.stats`` plus
    the dense width ``d`` (:data:`FEATURES`,
    :func:`features_from_report`);
  * the fitted tree persists as JSON next to the calibration store
    (:class:`DispatchTreeStore`), stamped with the feature schema and
    the kernel-registry version so a stale tree is refused exactly like
    a stale calibration;
  * every prediction carries its full decision path
    (:meth:`DecisionTree.decision_path`) so the dispatcher can record
    provenance in ``DispatchPlan`` the way ``ceiling_source`` records
    ceiling provenance.

The tree is *fitted* by ``repro_torch.launch.harvest_dispatch`` from
measured (structure features, per-format GFLOP/s) pairs over the matrix
corpus, and *consulted* by ``repro_torch.sparse.dispatch.Dispatcher``
only when the analytic top-two candidates are within a configurable
margin — the analytic model stays authoritative everywhere it is
confident.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: The feature schema, in order.  All numeric; ``inf`` (hill alpha with
#: no detectable tail) is clamped to :data:`ALPHA_CAP` so splits stay
#: finite.  ``d`` is the dense operand width — the winning format is a
#: function of the (matrix, d) pair, not the matrix alone.
FEATURES: Tuple[str, ...] = (
    "log2_n", "log2_nnz", "avg_degree", "band_fraction", "alpha_hill",
    "degree_gini", "hub_dominance", "row_gini", "col_gini",
    "block_D", "block_z_emp", "block_fill", "d",
)

#: Finite stand-in for ``alpha_hill == inf`` ("no heavy tail").
ALPHA_CAP = 100.0


def features_from_report(report, d: int) -> np.ndarray:
    """Extract the :data:`FEATURES` vector from a ``StructureReport``.

    Args:
        report: ``repro_torch.core.classify.StructureReport``.
        d: dense operand width of the dispatch decision.

    Returns:
        ``float64 [len(FEATURES)]`` in schema order.
    """
    s = report.stats
    raw = {
        "log2_n": np.log2(max(s.get("n", 1), 1)),
        "log2_nnz": np.log2(max(s.get("nnz", 1), 1)),
        "avg_degree": s.get("avg_degree", 0.0),
        "band_fraction": s.get("band_fraction", 0.0),
        "alpha_hill": min(s.get("alpha_hill", ALPHA_CAP), ALPHA_CAP),
        "degree_gini": s.get("degree_gini", 0.0),
        "hub_dominance": s.get("hub_dominance", 1.0),
        "row_gini": s.get("row_gini", 0.0),
        "col_gini": s.get("col_gini", 0.0),
        "block_D": s.get("block_D", 0.0),
        "block_z_emp": s.get("block_z_emp", 0.0),
        "block_fill": s.get("block_fill", 0.0),
        "d": float(d),
    }
    return np.array([float(raw[f]) for f in FEATURES], dtype=np.float64)


def _gini(counts: np.ndarray) -> float:
    total = counts.sum()
    if total == 0:
        return 0.0
    p = counts / total
    return float(1.0 - (p * p).sum())


@dataclasses.dataclass
class _Node:
    """One tree node; leaves carry ``label``, internals a split."""

    feature: Optional[int] = None     # FEATURES index (None = leaf)
    threshold: float = 0.0            # go left when x[f] <= threshold
    left: int = -1                    # child node ids
    right: int = -1
    label: Optional[str] = None       # majority class at this node
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)


class DecisionTree:
    """CART classifier over :data:`FEATURES`, JSON-serializable.

    Build with :meth:`fit` (or :meth:`from_json`); query with
    :meth:`predict` / :meth:`decision_path`.  The class list, node
    table, and feature schema round-trip losslessly through
    :meth:`to_json`, and :meth:`fingerprint` hashes that payload so a
    dispatcher cache key can tell two fitted trees apart.
    """

    def __init__(self, *, max_depth: int = 4, min_leaf: int = 2):
        """Create an unfitted tree with the given growth limits.

        Args:
            max_depth: maximum split depth (root = 0).
            min_leaf: minimum samples on each side of a split.
        """
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.features: Tuple[str, ...] = FEATURES
        self.nodes: List[_Node] = []

    # ------------------------------------------------------------- #
    # Fitting
    # ------------------------------------------------------------- #

    def fit(self, x: np.ndarray, y: Sequence[str]) -> "DecisionTree":
        """Fit on ``x [m, len(FEATURES)]`` and labels ``y [m]``.

        Returns ``self`` for chaining.  Raises ``ValueError`` on an
        empty or shape-mismatched training set.
        """
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(list(y), dtype=object)
        if x.ndim != 2 or x.shape[0] == 0 or x.shape[0] != y.shape[0]:
            raise ValueError(f"need matched non-empty x [m, f] / y [m], "
                             f"got {x.shape} vs {y.shape}")
        if x.shape[1] != len(self.features):
            raise ValueError(f"x has {x.shape[1]} features, schema has "
                             f"{len(self.features)}")
        self.classes_ = sorted(set(y))
        self.nodes = []
        self._grow(x, y, depth=0)
        return self

    def _counts(self, y: np.ndarray) -> Dict[str, int]:
        return {c: int((y == c).sum()) for c in self.classes_
                if (y == c).sum()}

    def _grow(self, x: np.ndarray, y: np.ndarray, depth: int) -> int:
        node_id = len(self.nodes)
        counts = self._counts(y)
        label = max(counts, key=counts.get)
        node = _Node(label=label, counts=counts)
        self.nodes.append(node)
        if depth >= self.max_depth or len(counts) <= 1 \
                or y.shape[0] < 2 * self.min_leaf:
            return node_id
        best = self._best_split(x, y)
        if best is None:
            return node_id
        f, thr = best
        mask = x[:, f] <= thr
        node.feature, node.threshold = f, thr
        node.left = self._grow(x[mask], y[mask], depth + 1)
        node.right = self._grow(x[~mask], y[~mask], depth + 1)
        return node_id

    def _best_split(self, x: np.ndarray,
                    y: np.ndarray) -> Optional[Tuple[int, float]]:
        class_ids = np.array([self.classes_.index(c) for c in y])
        parent_counts = np.bincount(class_ids, minlength=len(self.classes_))
        parent_gini = _gini(parent_counts)
        m = y.shape[0]
        best_gain, best = 1e-12, None
        for f in range(x.shape[1]):
            vals = np.unique(x[:, f])
            if vals.size < 2:
                continue
            for thr in (vals[:-1] + vals[1:]) / 2.0:
                mask = x[:, f] <= thr
                nl = int(mask.sum())
                if nl < self.min_leaf or m - nl < self.min_leaf:
                    continue
                gl = _gini(np.bincount(class_ids[mask],
                                       minlength=len(self.classes_)))
                gr = _gini(np.bincount(class_ids[~mask],
                                       minlength=len(self.classes_)))
                gain = parent_gini - (nl * gl + (m - nl) * gr) / m
                if gain > best_gain:
                    best_gain, best = gain, (f, float(thr))
        return best

    # ------------------------------------------------------------- #
    # Prediction
    # ------------------------------------------------------------- #

    def _walk(self, x: np.ndarray) -> List[int]:
        if not self.nodes:
            raise ValueError("tree is not fitted")
        path, node_id = [0], 0
        while self.nodes[node_id].feature is not None:
            node = self.nodes[node_id]
            node_id = node.left if x[node.feature] <= node.threshold \
                else node.right
            path.append(node_id)
        return path

    def predict(self, x: np.ndarray) -> str:
        """The label at the leaf ``x`` lands in."""
        return self.nodes[self._walk(np.asarray(x))[-1]].label

    def decision_path(self, x: np.ndarray) -> Tuple[str, ...]:
        """Human-readable split trail for ``x``, leaf included.

        Each element is ``"feature<=thr"`` / ``"feature>thr"`` for the
        branch taken, ending with ``"leaf:label(n=...)"`` — the
        provenance string the dispatcher stores in ``DispatchPlan``.
        """
        x = np.asarray(x)
        path = self._walk(x)
        out = []
        for node_id in path[:-1]:
            node = self.nodes[node_id]
            name = self.features[node.feature]
            taken = "<=" if x[node.feature] <= node.threshold else ">"
            out.append(f"{name}{taken}{node.threshold:.3g}")
        leaf = self.nodes[path[-1]]
        out.append(f"leaf:{leaf.label}(n={sum(leaf.counts.values())})")
        return tuple(out)

    # ------------------------------------------------------------- #
    # Serialization
    # ------------------------------------------------------------- #

    def to_json(self) -> dict:
        """The JSON payload (feature schema + node table + limits)."""
        return {
            "features": list(self.features),
            "max_depth": self.max_depth,
            "min_leaf": self.min_leaf,
            "classes": list(getattr(self, "classes_", [])),
            "nodes": [dataclasses.asdict(n) for n in self.nodes],
        }

    @classmethod
    def from_json(cls, payload: dict) -> "DecisionTree":
        """Rebuild a fitted tree from :meth:`to_json` output."""
        tree = cls(max_depth=int(payload.get("max_depth", 4)),
                   min_leaf=int(payload.get("min_leaf", 2)))
        tree.features = tuple(payload["features"])
        tree.classes_ = list(payload.get("classes", []))
        tree.nodes = [_Node(**n) for n in payload["nodes"]]
        return tree

    def fingerprint(self) -> str:
        """Stable short hash of the fitted tree (dispatch cache key part)."""
        blob = json.dumps(self.to_json(), sort_keys=True).encode()
        return hashlib.sha1(blob).hexdigest()[:12]


class DispatchTreeStore:
    """Persistence for the fitted dispatch tree, beside the calibrations.

    Files live in the same root as
    ``repro_torch.core.calibrate.CalibrationStore`` (``$REPRO_CALIBRATION_DIR``
    or ``~/.cache/repro/calibrations``) as
    ``dispatch_tree-<backend>.json`` — the tree, like a calibration,
    describes measured kernel behavior and is keyed by backend.  ``load``
    refuses payloads whose feature schema no longer matches
    :data:`FEATURES` or whose kernel-registry version predates the
    active one (formats the tree learned about may have changed).
    """

    def __init__(self, root: Optional[os.PathLike] = None):
        """Open (without touching the filesystem) the store at ``root``."""
        if root is None:
            root = os.environ.get("REPRO_CALIBRATION_DIR") or (
                pathlib.Path.home() / ".cache" / "repro" / "calibrations")
        self.root = pathlib.Path(root)

    def path_for(self, backend: str = "torch") -> pathlib.Path:
        """The JSON path holding ``backend``'s fitted tree."""
        return self.root / f"dispatch_tree-{backend}.json"

    def save(self, tree: DecisionTree, backend: str = "torch",
             meta: Optional[dict] = None) -> pathlib.Path:
        """Write the fitted tree (creating the root) and return the path."""
        from repro_torch.kernels import registry
        self.root.mkdir(parents=True, exist_ok=True)
        payload = {"tree": tree.to_json(), "backend": backend,
                   "registry_version": registry.REGISTRY_VERSION,
                   "meta": dict(meta or {})}
        path = self.path_for(backend)
        path.write_text(json.dumps(payload, indent=2), encoding="utf-8")
        return path

    def load(self, backend: str = "torch") -> Optional[DecisionTree]:
        """Read the tree for ``backend``; ``None`` when absent, stale, or
        fitted for another backend (a payload without one included)."""
        path = self.path_for(backend)
        if not path.is_file():
            return None
        try:
            payload = json.loads(path.read_text(encoding="utf-8"))
            tree = DecisionTree.from_json(payload["tree"])
        except (OSError, KeyError, TypeError, json.JSONDecodeError):
            return None
        if tuple(tree.features) != FEATURES:
            return None                  # schema drift: refuse silently
        if payload.get("backend") != backend:
            return None
        from repro_torch.kernels import registry
        if int(payload.get("registry_version", 0)) \
                < registry.REGISTRY_VERSION:
            return None                  # learned about retired kernels
        return tree
