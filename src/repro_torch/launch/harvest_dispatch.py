"""Harvest the corpus into a fitted dispatch tree, then audit it.

Closes the SpChar loop (arXiv 2304.06944) over the matrix corpus, on the
device the port serves from:

  1. **Sweep** — for every corpus matrix (vendored samples by default,
     or ``--corpus-root`` / ``$REPRO_CORPUS_DIR``) and every dense width
     in ``--d``, time each policy-eligible format through the
     dispatcher's executor and record ``(StructureReport features,
     per-format measured GFLOP/s)`` rows.
  2. **Fit** — train the pure-NumPy decision tree
     (``repro_torch.data.dtree.DecisionTree``) on (features ->
     measured-best format) and persist it beside the calibration store
     as ``dispatch_tree-<backend>.json`` (plus a copy in ``--out-dir``).
  3. **Audit** — replan every (matrix, d) pair analytic-only vs
     tree-assisted, write an agreement CSV (``matrix,
     impl=tree_vs_analytic, d, agreement, never_worse``), and check the
     claim: the tree-assisted choice's *measured* GFLOP/s is never below
     ``--claim-factor`` (default 0.95) of the analytic-only choice's.
     ``--enforce`` turns a claim failure into a non-zero exit.

Each timing is the best of ``--repeats`` host-clock timings of one call
after a warm one, each ending in ``torch.cuda.synchronize`` on the card
(``repro_torch.core.calibrate._best_of``).  Run from the repo root:

    PYTHONPATH=src python -m repro_torch.launch.harvest_dispatch \\
        [--device cpu] [--backend torch|cuda] [--enforce]

``--backend`` defaults to the dispatcher's choice for the device: the
CUDA kernels (``cuda``) on the card, the plain PyTorch versions
(``torch``) on the CPU.
"""
from __future__ import annotations

import argparse
import csv
import json
import pathlib
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.calibrate import _best_of
from repro_torch.core.device import resolve_device
from repro_torch.data.dtree import DispatchTreeStore

HARVEST_CSV = "harvest_dispatch.csv"
AGREEMENT_CSV = "dispatch_agreement.csv"
TREE_JSON = "dispatch_tree.json"


def sweep(entries, widths: List[int], repeats: int, backend: str,
          device: torch.device):
    """Measure every (matrix, d, eligible format) cell.

    Returns ``(rows, samples)``: CSV-ready measurement rows and the
    training samples ``{"features": vec, "label": best_format,
    "matrix": name, "d": d, "measured": {format: GFLOP/s}}``.
    """
    from repro_torch.core.classify import classify
    from repro_torch.data.dtree import features_from_report
    from repro_torch.sparse.dispatch import FORMATS, Dispatcher

    disp = Dispatcher(backend=backend, device=device, tree=False)
    rows, samples = [], []
    for entry in entries:
        m = entry.load()
        report = classify(m)
        rng = np.random.default_rng(0)
        for d in widths:
            b = torch.from_numpy(rng.standard_normal((m.n, d))
                                 .astype(np.float32)).to(device)
            flops = 2.0 * m.nnz * d
            measured: Dict[str, float] = {}
            for f in FORMATS:
                try:
                    plan = disp.plan(m, d, strategy=f)
                except ValueError:
                    continue            # policy-ineligible: no sample
                run = disp.executor(m, plan)
                secs = _best_of(lambda: run(b), repeats, device)
                gflops = flops / secs / 1e9
                measured[f] = gflops
                rows.append({"matrix": entry.name, "group": entry.group,
                             "impl": f, "d": d, "n": m.n, "nnz": m.nnz,
                             "gflops": f"{gflops:.4f}"})
            best = max(measured, key=measured.get)
            samples.append({
                "features": features_from_report(report, d),
                "label": best, "matrix": entry.name, "d": d,
                "measured": measured,
            })
            print(f"  {entry.name:28s} d={d:4d} best={best:8s} "
                  f"({measured[best]:.2f} GF/s, "
                  f"{len(measured)}/{len(FORMATS)} eligible)")
    return rows, samples


def audit(entries, samples, tree, margin: float, backend: str,
          claim_factor: float, device: torch.device):
    """Tree-assisted vs analytic-only dispatch over the harvested pairs.

    Returns ``(rows, agreement_rate, claim_ok)``; a pair passes the
    claim when the tree-assisted choice's measured GFLOP/s is at least
    ``claim_factor`` times the analytic-only choice's.
    """
    from repro_torch.sparse.dispatch import Dispatcher

    analytic = Dispatcher(backend=backend, device=device, tree=False)
    assisted = Dispatcher(backend=backend, device=device, tree=tree,
                          tree_margin=margin)
    by_name = {e.name: e for e in entries}
    rows, agree, claim_ok = [], 0, True
    for s in samples:
        m = by_name[s["matrix"]].load()
        d = s["d"]
        a = analytic.plan(m, d).chosen
        t_plan = assisted.plan(m, d)
        t = t_plan.chosen
        same = int(a == t)
        agree += same
        # The never-worse claim compares *measured* throughput of the
        # two choices (both were timed in the sweep; a policy-eligible
        # plan choice is always a measured format).
        never_worse = int(
            s["measured"].get(t, 0.0)
            >= claim_factor * s["measured"].get(a, 0.0))
        claim_ok &= bool(never_worse)
        rows.append({"matrix": s["matrix"], "impl": "tree_vs_analytic",
                     "d": d, "agreement": same,
                     "never_worse": never_worse,
                     "analytic": a, "tree": t,
                     "decision_source": t_plan.decision_source})
    rate = agree / max(len(samples), 1)
    return rows, rate, claim_ok


def _write_csv(path: pathlib.Path, rows: List[dict]) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="", encoding="utf-8") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)


def parser() -> argparse.ArgumentParser:
    """The harvest's command line."""
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.harvest_dispatch",
        description="Sweep the corpus, fit the dispatch tree, audit it.")
    ap.add_argument("--corpus-root", default=None,
                    help="corpus directory (default: $REPRO_CORPUS_DIR "
                         "or the vendored samples)")
    ap.add_argument("--out-dir", default="chiprun_out/harvest",
                    help="where the CSVs + fitted-tree JSON copy go")
    ap.add_argument("--d", type=int, nargs="+", default=[32, 128],
                    help="dense operand widths to sweep")
    ap.add_argument("--repeats", type=int, default=3,
                    help="timing repeats per cell (best-of)")
    ap.add_argument("--backend", default=None, choices=["torch", "cuda"],
                    help="kernels to time (default: cuda on a CUDA "
                         "device, torch otherwise)")
    ap.add_argument("--device", default="cuda",
                    help="device to time on (default: cuda; cpu runs the "
                         "plain PyTorch versions)")
    ap.add_argument("--max-depth", type=int, default=4)
    ap.add_argument("--min-leaf", type=int, default=2)
    ap.add_argument("--margin", type=float, default=0.10,
                    help="tree_margin used for the agreement audit")
    ap.add_argument("--claim-factor", type=float, default=0.95,
                    help="tree-assisted measured GFLOP/s must be >= this "
                         "fraction of analytic-only's")
    ap.add_argument("--no-store", action="store_true",
                    help="skip persisting the tree to the calibration "
                         "root (the --out-dir copy still happens)")
    ap.add_argument("--enforce", action="store_true",
                    help="exit 1 when the never-worse claim fails")
    return ap


def harvest(args, *, store: Optional[DispatchTreeStore] = None) -> dict:
    """Sweep, fit, persist and audit, as the command line asks.

    Args:
        args: parsed :func:`parser` arguments.
        store: persist the tree here instead of the default
            :class:`~repro_torch.data.dtree.DispatchTreeStore`.

    Returns:
        The run's record: ``backend``, ``rows`` (the sweep),
        ``samples``, ``tree``, ``tree_path`` (None with ``--no-store``),
        ``audit`` (rows), ``agreement`` (rate) and ``claim_ok``.

    Raises:
        ValueError: when the corpus is empty.
    """
    from repro_torch.data import corpus
    from repro_torch.data.dtree import DecisionTree

    device = resolve_device(args.device)
    backend = args.backend or ("cuda" if device.type == "cuda"
                               else "torch")
    entries = corpus.corpus_entries(args.corpus_root)
    if not entries:
        raise ValueError("harvest: corpus is empty")
    print(f"harvest: {len(entries)} matrices x d={args.d} "
          f"({backend} backend on {device})")

    rows, samples = sweep(entries, args.d, args.repeats, backend, device)
    out = pathlib.Path(args.out_dir)
    _write_csv(out / HARVEST_CSV, rows)

    x = np.stack([s["features"] for s in samples])
    y = [s["label"] for s in samples]
    tree = DecisionTree(max_depth=args.max_depth,
                        min_leaf=args.min_leaf).fit(x, y)
    meta = {"rows": len(samples), "widths": args.d,
            "matrices": sorted({s["matrix"] for s in samples})}
    (out / TREE_JSON).write_text(json.dumps(
        {"tree": tree.to_json(), "backend": backend, "meta": meta},
        indent=2), encoding="utf-8")
    path = None
    if not args.no_store:
        path = (store or DispatchTreeStore()).save(tree, backend, meta=meta)
        print(f"harvest: tree persisted to {path}")

    arows, rate, claim_ok = audit(entries, samples, tree, args.margin,
                                  backend, args.claim_factor, device)
    _write_csv(out / AGREEMENT_CSV, arows)
    print(f"harvest: fitted depth<={args.max_depth} tree "
          f"({tree.fingerprint()}) on {len(samples)} samples")
    print(f"harvest: tree/analytic agreement {rate:.0%}; never-worse "
          f"claim ({args.claim_factor}x measured) "
          f"{'PASS' if claim_ok else 'FAIL'}")
    for r in arows:
        if not r["never_worse"]:
            print(f"  CLAIM FAIL {r['matrix']} d={r['d']}: "
                  f"tree={r['tree']} analytic={r['analytic']}")
    return {"backend": backend, "rows": rows, "samples": samples,
            "tree": tree, "tree_path": path, "audit": arows,
            "agreement": rate, "claim_ok": claim_ok}


def main(argv=None) -> int:
    """Sweep, fit, persist, audit; return the process exit code."""
    from repro_torch.data import corpus
    args = parser().parse_args(argv)
    if not corpus.corpus_entries(args.corpus_root):
        print("harvest: corpus is empty", file=sys.stderr)
        return 1
    rec = harvest(args)
    return 1 if args.enforce and not rec["claim_ok"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
