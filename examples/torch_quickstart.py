"""Quickstart on the PyTorch/CUDA port: the paper's core loop.

One matrix per sparsity regime; the structure-aware dispatcher
classifies each, evaluates every candidate format's sparsity-aware
roofline on the device, picks the (format, kernel) pair and runs it, and
the prediction is printed beside the measured throughput (the port of
``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py             # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --n 4096
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.core import banded, blocked, erdos_renyi, scale_free
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.sparse.dispatch import Dispatcher


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=2 ** 14)
    ap.add_argument("--d", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, d = args.n, args.d
    matrices = {
        "er (random)": erdos_renyi(n, 10, seed=0),
        "ideal_diagonal": banded(n, 1, seed=1),
        "fem blocks": blocked(n, t=32, num_blocks=n // 16,
                              nnz_per_block=320, seed=2),
        "powerlaw": scale_free(n, 16, alpha=2.2, seed=3),
    }
    disp = Dispatcher(device=dev)
    b = torch.from_numpy(np.random.default_rng(0).normal(size=(n, d))
                         .astype(np.float32)).to(dev)
    print(f"{'matrix':16s} {'regime':11s} {'chosen':8s} {'AI':>6s} "
          f"{'pred GF/s':>9s} {'meas GF/s':>9s}")
    for name, m in matrices.items():
        plan = disp.plan(m, d)                  # inspectable decision
        disp.spmm(m, b)                         # convert, pack, first call
        synchronize(dev)
        t0 = time.perf_counter()
        disp.spmm(m, b, strategy="auto")
        synchronize(dev)
        gf = 2 * m.nnz * d / (time.perf_counter() - t0) / 1e9
        best = plan.candidate(plan.chosen)
        print(f"{name:16s} {plan.regime:11s} {plan.chosen:8s} "
              f"{best.ai:6.3f} {best.predicted_gflops:9.2f} {gf:9.2f}")
    # The full audit trail of one decision.
    print()
    print(disp.plan(matrices["powerlaw"], d).summary())


if __name__ == "__main__":
    main()
