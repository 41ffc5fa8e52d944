"""Training launcher (the reference's ``repro.launch.train`` without a
mesh):

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --reduced --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --layers 4 --batch 4 --seq-len 512 --steps 8 --warmup 2

The flags are the reference's (``--seq-len`` and ``--batch`` override
the shape's, as there) plus two: ``--device``, and ``--layers``, which
cuts the depth and keeps the widths (full-width olmoe-1b-7b's training
state, 16 B per parameter, fits one 80 GB card only at 4 of 16 layers).
``--shape`` trains at that shape, as the reference does; without it the
shape is ``train_4k``, or :data:`SMOKE_SHAPE` (4 x 32) under
``--reduced``, since ``train_4k``'s million tokens a step exhaust a host
even at the reduced widths.  The trainer resumes from the newest
committed checkpoint in ``--ckpt-dir``.  On the card every MoE layer's
expert FFN launches the grouped-matmul kernel in the forward, its
recompute and its input gradient; the launches are printed beside the
planned count (``LM.grouped_launches_per_step(train=True)`` per
micro-batch) and must equal it, or this raises ``RuntimeError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import tempfile

import numpy as np

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core.device import MULTI_CARD, resolve_device
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import launch_counts
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig

#: The shape ``--reduced`` trains at without ``--shape`` (the reference's
#: tests' small shape): ``train_4k``'s million tokens a step would not fit
#: a host.
SMOKE_SHAPE = ShapeConfig("smoke", 32, 4, "train")


def parser() -> argparse.ArgumentParser:
    """The trainer's command line (the reference's, plus ``--device`` and
    ``--layers``)."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train",
                                 description="Train an arch on the GPU.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None,
                    help="the shape to train at (default: train_4k, or the "
                         "4 x 32 smoke shape under --reduced)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers")
    ap.add_argument("--seq-len", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--mesh", default="",
                    help="a device mesh (not ported: raises)")
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
    return ap


def make_trainer(args) -> Trainer:
    """The :class:`Trainer` the arguments describe (not yet run)."""
    if args.mesh:
        raise NotImplementedError(f"--mesh comes with {MULTI_CARD}")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    if args.shape:
        shape = SHAPES[args.shape]
    else:
        shape = SMOKE_SHAPE if args.reduced else SHAPES["train_4k"]
    if args.seq_len or args.batch:
        shape = ShapeConfig("custom", args.seq_len or shape.seq_len,
                            args.batch or shape.global_batch, "train")
    tcfg = TrainerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                         grad_accum=args.grad_accum,
                         schedule_kwargs={"warmup_steps": args.warmup,
                                          "total_steps": args.steps})
    return Trainer(cfg, shape, tcfg, opt_cfg=adamw.AdamWConfig(lr=args.lr),
                   data_cfg=DataConfig(seed=0),
                   device=resolve_device(args.device))


def train(args, trainer: Trainer = None) -> dict:
    """Run ``args.steps`` (from the newest checkpoint) and check the
    grouped-matmul launches against the plan on the card.

    Returns:
        A record: ``trainer``, ``metrics``, ``launches`` and ``planned``.
    """
    trainer = trainer or make_trainer(args)
    start = trainer.init_or_restore()
    cfg, dev = trainer.cfg, trainer.device
    n_params = sum(p.numel() for p in trainer.model.parameters())
    print(f"device={dev} arch={cfg.name} layers={cfg.num_layers} "
          f"params={n_params / 1e6:.1f}M start_step={start}")
    before = launch_counts()["grouped_matmul"]
    metrics = trainer.run(args.steps)
    launches = launch_counts()["grouped_matmul"] - before
    steps = len(trainer.history)
    planned = trainer.model.grouped_launches_per_step(train=True) * \
        trainer.tcfg.grad_accum * steps if dev.type == "cuda" else 0
    for h in trainer.history:
        print(f"step {h['step']}: loss {h['loss']:.4f}, "
              f"{h['dt'] * 1e3:.1f} ms")
    if steps:
        median_ms = np.median([h["dt"] for h in trainer.history]) * 1e3
        print(f"{steps} steps, median {median_ms:.1f} ms; grouped_matmul "
              f"launches {launches} (planned {planned})")
    print("final metrics:", metrics)
    if trainer.straggler_events:
        print(f"stragglers observed: {len(trainer.straggler_events)}")
    if launches != planned:
        raise RuntimeError(f"{cfg.name}: grouped_matmul launched {launches} "
                           f"times, planned {planned}")
    return {"trainer": trainer, "metrics": metrics, "launches": launches,
            "planned": planned}


def main(argv=None):
    """Train an arch from the command line (see the module docstring)."""
    logging.basicConfig(level=logging.INFO)
    train(parser().parse_args(argv))


if __name__ == "__main__":
    main()
