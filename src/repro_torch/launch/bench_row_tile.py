"""Time the row-tile CUDA kernels (CSR, binned) at the serving shapes.

    PYTHONPATH=src python -m repro_torch.launch.bench_row_tile \
        [--n 1048576] [--d 64] [--piece-nnz 2048 1024 ...] \
        [--variant NAME=DIR ...]

Packs ``uniform`` and ``scale-free`` from ``serving_suite`` at n, f32i32,
on the card, as the server's plan packs them, and times ``csr_spmm`` on
both and ``binned_spmm`` on ``scale-free`` (CUDA events, one warm call,
median of 20).  Every ``--piece-nnz`` value re-derives the work list of
the same packed arrays (``csr_spmm.with_work_list``).  Every
``--variant`` names a checkout ``DIR`` whose ``src/repro_torch/csrc``
holds another version of the kernels; they are built and timed in turns
with this package's own (own, variant, variant, own), so two sources are
compared on one card in one run.  Prints one line per measurement and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys

import numpy as np
import torch

from repro_torch.core.device import median_ms
from repro_torch.kernels import build
from repro_torch.kernels.binned_spmm import binned_spmm
from repro_torch.kernels.csr_spmm import PIECE_NNZ, csr_spmm, with_work_list
from repro_torch.launch import serve
from repro_torch.sparse import stream
from repro_torch.sparse.dispatch import Dispatcher

#: CUDA-event timings per measurement (the median is reported).
RUNS = 20


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2 ** 20)
    ap.add_argument("--d", type=int, default=64)
    ap.add_argument("--piece-nnz", type=int, nargs="*", default=[])
    ap.add_argument("--variant", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_row_tile: no CUDA device", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    own = build.CSRC
    cases = []
    for structure in ("uniform", "scale-free"):
        m = serve.build_stream_matrix(structure, args.n)
        b = torch.from_numpy(np.random.default_rng(0).normal(
            size=(m.n, args.d)).astype(np.float32)).to(dev)
        for fmt, fn in (("csr", csr_spmm), ("binned", binned_spmm)):
            if fmt == "binned" and structure != "scale-free":
                continue
            # The packing the server's plan makes (Dispatcher on the card).
            layout = stream.plan(m, stream.BSpec(d=args.d, reuse=8),
                                 strategy=fmt, precision="f32i32",
                                 dispatcher=Dispatcher(device=dev)).layout
            cases.append((f"{fn.__name__} {structure}", fn, layout, b))

    def time_all(tag: str, pieces=(PIECE_NNZ,)) -> None:
        for name, fn, layout, b in cases:
            for piece_nnz in pieces:
                lay = layout if piece_nnz == PIECE_NNZ else \
                    with_work_list(layout, piece_nnz)
                ms = median_ms(lambda: fn(lay, b), RUNS)
                print(f"{tag} {name} piece_nnz={piece_nnz} pieces="
                      f"{lay.num_pieces}: {ms:.4f} ms", flush=True)

    time_all("own", (PIECE_NNZ, *args.piece_nnz))
    for spec in args.variant:
        tag, path = spec.split("=", 1)
        build.use_sources(pathlib.Path(path) / "src" / "repro_torch" / "csrc")
        time_all(tag)
        time_all(tag)
        build.use_sources(own)
        time_all("own")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
