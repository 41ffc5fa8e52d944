"""Time the serving engine against another version of it on the same arrivals.

    PYTHONPATH=src python -m repro_torch.launch.bench_engine \
        [--spmm-n N ...] [--variant NAME=DIR ...]

Serves ``moe-block`` from ``serving_suite`` through ``serve_spmm_engine``
at each n (default 4096, the reference CLI's shape, where batches
coalesce, and 2**20, where every batch is one or two requests): d = 64 /
32, 4 streams, 2000 requests/s per stream, queue 256, policy ``wait``, 64
requests per stream at n <= 4096 and 4 above.  Every ``--variant`` names
a checkout ``DIR`` whose ``src/repro_torch/sparse/engine.py`` holds
another ``ServingEngine``; it serves the same arrivals in turns with this
package's own (own, variant, variant, own), so two engines are compared
on one card in one run.  Each turn is a process of its own and serves
every n twice: first with the host's pinned-memory cache empty
("cold"), then with the blocks the first run freed in it ("warm"), since
pinning a fresh buffer costs far more than reusing one.  Prints one line
per run (engine and sync p50 / p99 / goodput, batches, and the median
per-batch H2D / kernel / D2H from CUDA events with the host's staging
and result-buffer times) and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import importlib.util
import pathlib
import subprocess
import sys

import numpy as np
import torch

from repro_torch.launch import serve
from repro_torch.sparse import engine as own_engine
from repro_torch.sparse.dispatch import Dispatcher

#: The engine settings of the run (``serve --engine`` flags).
STREAMS, RATE, QUEUE, POLICY, D = 4, 2000, 256, "wait", 64


def load_engine(tag: str, root: pathlib.Path):
    """``DIR/src/repro_torch/sparse/engine.py`` as a module of its own."""
    path = root / "src" / "repro_torch" / "sparse" / "engine.py"
    spec = importlib.util.spec_from_file_location(
        f"repro_torch_engine_{tag}", path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return module


def run_once(tag: str, module, m, disp, dev) -> None:
    """One engine run of ``module``'s ``ServingEngine``; prints its line."""
    per_stream = 64 if m.n <= 4096 else 4
    args = serve.parser().parse_args(
        ["--engine", "--spmm-structure", "moe-block", "--spmm-n", str(m.n),
         "--spmm-d", str(D), "--engine-streams", str(STREAMS),
         "--engine-requests", str(STREAMS * per_stream),
         "--engine-rate", str(RATE), "--engine-queue", str(QUEUE),
         "--engine-policy", POLICY, "--device", str(dev)])
    rec = serve.serve_spmm_engine(args, dispatcher=disp, matrix=m,
                                  engine_cls=module.ServingEngine)
    st, log = rec["stats"], rec["engine"].transfer_log

    def med(key: str) -> float:
        return float(np.median([getattr(t, key) for t in log]))

    print(f"{tag} n={m.n}: engine p50 {st['p50_us']:.1f} us p99 "
          f"{st['p99_us']:.1f} us goodput {st['goodput_rps']:.1f} req/s; "
          f"sync p50 {rec['sync_p50_us']:.1f} us p99 "
          f"{rec['sync_p99_us']:.1f} us goodput "
          f"{rec['sync_goodput_rps']:.1f} req/s; {st['batches']} batches, "
          f"{st['coalesced']} coalesced; median h2d {med('h2d_ms'):.4f} "
          f"kernel {med('kernel_ms'):.4f} d2h {med('d2h_ms'):.4f} ms, "
          f"host staging {med('stage_host_ms'):.3f} ms, result buffer "
          f"{med('result_alloc_host_ms'):.3f} ms (sum "
          f"{sum(t.result_alloc_host_ms for t in log):.1f} ms)", flush=True)


def turn(spec: str, ns: list) -> None:
    """One turn (``NAME`` for this package's engine, ``NAME=DIR`` for a
    variant's): a cold and a warm run at each n."""
    tag, _, path = spec.partition("=")
    module = load_engine(tag, pathlib.Path(path)) if path else own_engine
    dev = torch.device("cuda")
    for n in ns:
        m = serve.build_stream_matrix("moe-block", n)
        disp = Dispatcher(device=dev, calibration=False, tree=False)
        run_once(f"{tag} cold", module, m, disp, dev)
        run_once(f"{tag} warm", module, m, disp, dev)
        del m, disp
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spmm-n", type=int, nargs="*",
                    default=[4096, 2 ** 20])
    ap.add_argument("--variant", nargs="*", default=[])
    ap.add_argument("--turn", help="run one turn in this process")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_engine: no CUDA device", file=sys.stderr)
        return 2
    if args.turn:
        turn(args.turn, args.spmm_n)
        return 0
    turns = ["own"]
    for spec in args.variant:
        turns += [spec, spec, "own"]
    for spec in turns:
        subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.bench_engine",
             "--turn", spec, "--spmm-n", *map(str, args.spmm_n)],
            check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
