"""Time the row-split kernel and the fp32 grouped matmul at the main
path's shapes, through their public wrappers only.

    PYTHONPATH=src python -m repro_torch.launch.bench_fold [--tag NAME]

Packs ``scale-free`` from ``serving_suite`` at n = 2**20 for the
row-split kernel at f32i32 and d = 64 (the layout the server's plan
packs), and routes qwen3-moe-235b-a22b's expert FFN (4096 tokens, top-8
of 128 experts, 4096 -> 1536, bm = 128) at fp32 for the grouped matmul;
times each wrapper (CUDA events, one warm call, median of 20) and prints
one line per kernel with ``--tag``, then the card's name and power limit.

The script uses nothing but calls every version of the port has had, so
another checkout's package can be timed with it on the same card:

    PYTHONPATH=OTHER/src python src/repro_torch/launch/bench_fold.py \
        --tag parent
"""
from __future__ import annotations

import argparse
import subprocess
import sys
import types

import numpy as np
import torch

#: CUDA-event timings per measurement (the median is reported).
RUNS = 20
#: The serving shape: n rows and columns, d columns of B.
N, D = 2 ** 20, 64
#: qwen3-moe-235b-a22b's expert FFN, as chip_smoke.py runs it.
MOE = {"tokens": 4096, "experts": 128, "top_k": 8, "d_model": 4096,
       "d_ff": 1536, "bm": 128}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tag", default="own")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_fold: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.core.device import median_ms
    from repro_torch.kernels.grouped_matmul import grouped_matmul
    from repro_torch.kernels.rowsplit_spmm import rowsplit_spmm
    from repro_torch.launch import moe_block, serve
    from repro_torch.sparse import stream
    from repro_torch.sparse.dispatch import Dispatcher

    dev = torch.device("cuda")
    m = serve.build_stream_matrix("scale-free", N)
    layout = stream.plan(m, stream.BSpec(d=D, reuse=8),
                         strategy="rowsplit", precision="f32i32",
                         dispatcher=Dispatcher(device=dev)).layout
    b = torch.from_numpy(np.random.default_rng(0).normal(
        size=(m.n, D)).astype(np.float32)).to(dev)
    ms = median_ms(lambda: rowsplit_spmm(layout, b), RUNS)
    print(f"{args.tag} rowsplit_spmm scale-free n={m.n} d={D} "
          f"f32i32: {ms:.4f} ms", flush=True)
    del layout, b

    moe_args = types.SimpleNamespace(
        tokens=MOE["tokens"], d_model=MOE["d_model"],
        experts=MOE["experts"], d_ff=MOE["d_ff"], dtype="float32", seed=0)
    x, w, router = moe_block.make_inputs(moe_args, dev)
    routed = moe_block.route_and_block(x, router, num_experts=MOE["experts"],
                                       k=MOE["top_k"], bm=MOE["bm"])
    ms = median_ms(lambda: grouped_matmul(routed.x, w, routed.group_ids,
                                          bm=MOE["bm"]), RUNS)
    print(f"{args.tag} grouped_matmul float32 T={routed.x.shape[0]}: "
          f"{ms:.4f} ms", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{args.tag} card: {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
