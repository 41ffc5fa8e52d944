"""Read the comparison's number for the lower precision control, many
seeds in one process, on the card (the benchmark's own runs never run it).

    python3 bench/control.py --cells scalefree.stream-d64 fem.solve-d4 \
        --seeds 101 102 103 --seconds 2 [--out FILE]

The control is the program with its own bf16-value path switched on
(``bf16i32``, the nearest precision below the configurations' float32).
Each (cell, seed) runs the cell's whole path (generation, plan, warm-up,
a window of ``--seconds`` at the cell's own load, the check) with the
plan's storage precision forced to it. One JSON line per reading goes to
standard output and to ``--out``.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from run import ROOT, cache_dirs, forbidden_modules, run_cell  # noqa: E402

#: The plan's storage precision in the control.
CONTROL_PRECISION = "bf16i32"


def main(argv=None) -> int:
    """Run every (cell, seed) and print one reading per line."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--cells", nargs="+", required=True)
    p.add_argument("--seeds", nargs="+", type=int, required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    for key, path in cache_dirs(ROOT).items():
        path.mkdir(parents=True, exist_ok=True)
        os.environ[key] = str(path)
    import torch
    from bench import spec
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    out = open(args.out, "a") if args.out else None
    try:
        for name in args.cells:
            cell = spec.load_cell(ROOT, name)
            for seed in args.seeds:
                t = time.perf_counter()
                res = run_cell(ROOT, cell, seed=seed, seconds=args.seconds,
                               trace=False, device=torch.device("cuda"),
                               t0=t, precision=CONTROL_PRECISION,
                               log=lambda s: None)
                line = json.dumps({
                    "cell": name, "seed": seed, "precision": CONTROL_PRECISION,
                    "correct": res["correct"],
                    "max_rel_err": res["checks"]["max_rel_err"]["value"],
                    "attempted": res["attempted"],
                    "seconds": time.perf_counter() - t})
                print(line, flush=True)
                if out:
                    out.write(line + "\n")
                    out.flush()
    finally:
        if out:
            out.close()
    loaded = forbidden_modules()
    if loaded:
        print(f"control: the run loaded {', '.join(loaded)}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
