"""Time the BCSR kernel (or the banded kernel) at the serving shapes.

    PYTHONPATH=src python -m repro_torch.launch.bench_bcsr \
        [--kernel bcsr|banded] [--variant NAME=DIR ...]

``bcsr``: packs ``moe-block`` from ``serving_suite`` at n = 2**20 as the
server's plan packs it (t = 64), at f32i32 and bf16i32, and times
``bcsr_spmm`` at d = 64 (CUDA events, one warm call, median of 20).
Where A's blocks hold as many values as B (d = t on ``moe-block``), it
also times one ``torch.add`` that reads A's values and B and writes C: a
plain stream of the bytes the kernel must move.  ``banded``:
``banded_spmm`` on ``banded`` at f32i32, the other SpMM kernel built with
``csrc/hopper.cuh``.
Every ``--variant`` names a checkout ``DIR`` whose ``src/repro_torch/csrc``
holds another version of the kernels with the same launchers; they are
built and timed in turns with this package's own (own, variant, variant,
own), so two sources are compared on one card in one run.  Prints one
line per measurement and the card's name and power limit.
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
from repro_torch.kernels.banded_spmm import banded_spmm
from repro_torch.kernels.bcsr_spmm import bcsr_spmm
from repro_torch.launch import serve
from repro_torch.sparse import stream
from repro_torch.sparse.dispatch import Dispatcher

#: CUDA-event timings per measurement (the median is reported).
RUNS = 20
#: The serving shape: n rows and columns, d columns of B.
N, D = 2 ** 20, 64

#: kernel -> (serving structure, format, wrapper, precisions).
KERNELS = {"bcsr": ("moe-block", "bcsr", bcsr_spmm, ("f32i32", "bf16i32")),
           "banded": ("banded", "dia", banded_spmm, ("f32i32",))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="bcsr")
    ap.add_argument("--variant", nargs="*", default=[])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_bcsr: no CUDA device", file=sys.stderr)
        return 2

    dev = torch.device("cuda")
    own = build.CSRC
    structure, fmt, fn, tokens = KERNELS[args.kernel]
    m = serve.build_stream_matrix(structure, N)
    cases = []
    for token in tokens:
        layout = stream.plan(m, stream.BSpec(d=D, reuse=8),
                             strategy=fmt, precision=token,
                             dispatcher=Dispatcher(device=dev)).layout
        dtype = torch.bfloat16 if token.startswith("bf16") else torch.float32
        b = torch.from_numpy(np.random.default_rng(0).normal(
            size=(m.n, D)).astype(np.float32)).to(dev, dtype)
        cases.append((f"{fn.__name__} {structure} {token}", layout, b))

    def time_all(tag: str) -> None:
        for name, layout, b in cases:
            ms = median_ms(lambda: fn(layout, b), RUNS)
            print(f"{tag} {name} d={D}: {ms:.4f} ms", flush=True)

    time_all("own")
    for spec in args.variant:
        tag, path = spec.split("=", 1)
        build.use_sources(pathlib.Path(path) / "src" / "repro_torch" / "csrc")
        time_all(tag)
        time_all(tag)
        build.use_sources(own)
        time_all("own")
    for name, layout, b in cases:
        values = getattr(layout, "blocks", None)
        if values is not None and values.numel() == b.numel():
            c = torch.empty_like(b)
            ms = median_ms(lambda: torch.add(values.view(b.shape), b, out=c),
                           RUNS)
            print(f"torch.add over the same bytes ({name}): {ms:.4f} ms",
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
