"""Batched serving on the PyTorch/CUDA port: greedy decode with KV and
recurrent caches on three architecture families (attention, hybrid,
SSM), then the block-sparse serving path, the MoE expert-dispatch SpMM
served through a persistent ``sparse.plan`` (plan once, execute every
decode step); the port of ``examples/serve_lm.py``.

    PYTHONPATH=src python examples/torch_serve_lm.py               # the card
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import sparse
from repro_torch.configs import get_config
from repro_torch.core.device import resolve_device, synchronize
from repro_torch.launch.serve import build_stream_matrix, generate
from repro_torch.models.model import init_params

B, PROMPT, GEN = 4, 16, 12
N_SLOTS, D_MODEL = 1024, 64


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    for arch in ("gemma3-12b", "recurrentgemma-9b", "falcon-mamba-7b"):
        cfg = get_config(arch).reduced()
        model = init_params(cfg, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
        prompts = np.random.default_rng(0).integers(
            2, cfg.vocab_size - 1, size=(B, PROMPT)).astype(np.int32)
        t0 = time.perf_counter()
        out = generate(model, prompts, GEN)
        print(f"{arch:20s} [{cfg.family:6s}] generated {GEN}x{B} tokens in "
              f"{time.perf_counter() - t0:5.1f}s -> {out.tokens[0][:6]}")

    # The MoE expert-dispatch matrix (dense expert blocks on the
    # diagonal), held for the whole session: plan classifies, predicts and
    # converts once with the decode length as the reuse horizon; each step
    # replays the bound kernel on that step's activations.
    m = build_stream_matrix("moe-block", N_SLOTS)
    plan = sparse.plan(m, sparse.BSpec(d=D_MODEL, reuse=GEN), device=dev)
    acts = torch.from_numpy(np.random.default_rng(0).normal(
        size=(GEN, N_SLOTS, D_MODEL)).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    plan.execute_many(acts)
    synchronize(dev)
    stats = plan.stats()
    print(f"{'moe-block-spmm':20s} [stream] served {GEN} steps of "
          f"[{N_SLOTS},{D_MODEL}] in {time.perf_counter() - t0:5.1f}s via "
          f"{plan.chosen} ({stats['regime']} regime, executed="
          f"{stats['executed']}/{stats['planned_reuse']} planned)")


if __name__ == "__main__":
    main()
