"""Training launcher (the reference's ``repro.launch.train``):

    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --reduced --device cpu --steps 4
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --layers 4 --batch 4 --seq-len 512 --steps 8 --warmup 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch olmoe-1b-7b \\
        --reduced --mesh 2,2 --device cpu --steps 2

The flags are the reference's (``--seq-len`` and ``--batch`` override
the shape's, as there) plus two: ``--device``, and ``--layers``, which
cuts the depth and keeps the widths (full-width olmoe-1b-7b's training
state, 16 B per parameter, fits one 80 GB card only at 4 of 16 layers).
``--shape`` trains at that shape, as the reference does; without it the
shape is ``train_4k``, or :data:`SMOKE_SHAPE` (4 x 32) under
``--reduced``, since ``train_4k``'s million tokens a step exhaust a host
even at the reduced widths.  The trainer resumes from the newest
committed checkpoint in ``--ckpt-dir``.  ``--mesh data,model`` spawns a
world of ``data * model`` ranks on this host (``launch.spawn.run_world``),
each running the partitioned step (``Trainer(mesh=)``) on its
``launch.mesh.ProcessMesh``: gloo for ``--device cpu``, NCCL with one
card per rank where there are as many cards as ranks, else gloo with the
ranks sharing ``cuda:0`` (collectives staged through the host; NCCL
refuses two ranks on one card); only rank 0 prints.  A world that fails
to start raises: nothing falls back to one process.  On the card every
MoE layer's
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
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.core.device import resolve_device
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
                    help="'data,model': train over a spawned world of "
                         "data * model ranks")
    ap.add_argument("--device", default=None,
                    help="where to train (default: the card; 'cpu' runs the "
                         "plain versions on the CPU)")
    return ap


def parse_mesh(text: str) -> tuple:
    """``--mesh``'s ``"data,model"`` as ``(data, model)``.

    Raises:
        ValueError: another form.
    """
    parts = tuple(int(x) for x in text.split(","))
    if len(parts) != 2 or min(parts) < 1:
        raise ValueError(f"--mesh takes 'data,model', not {text!r}")
    return parts


def config_of(args):
    """The arch config the arguments describe (``--reduced``,
    ``--layers``)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    return cfg


def make_trainer(args, mesh=None) -> Trainer:
    """The :class:`Trainer` the arguments describe (not yet run); with
    ``--mesh``, this rank's on ``mesh`` (its ``ProcessMesh``).

    Raises:
        ValueError: ``--mesh`` without this rank's mesh (``train`` spawns
            the world).
    """
    cfg = config_of(args)
    if args.mesh and mesh is None:
        raise ValueError("--mesh trains in a spawned world: call "
                         "train(args), which makes each rank's mesh")
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
    device = mesh.device if mesh is not None else resolve_device(args.device)
    return Trainer(cfg, shape, tcfg, mesh=mesh,
                   opt_cfg=adamw.AdamWConfig(lr=args.lr),
                   data_cfg=DataConfig(seed=0), device=device)


def train(args, trainer: Trainer = None) -> dict:
    """Run ``args.steps`` (from the newest checkpoint) and check the
    grouped-matmul launches against the plan on the card.  With ``--mesh``
    and no ``trainer``, spawn the world (:func:`train_world`).

    Returns:
        A record: ``trainer``, ``metrics``, ``launches`` and ``planned``
        (over a spawned world, rank 0's, with its ``history`` in place of
        the trainer).
    """
    if args.mesh and trainer is None:
        return train_world(args)
    trainer = trainer or make_trainer(args)
    loud = trainer.mesh is None or trainer.mesh.rank == 0
    say = print if loud else (lambda *a, **k: None)
    start = trainer.init_or_restore()
    cfg, dev = trainer.cfg, trainer.device
    n_params = sum(p.numel() for p in trainer.model.parameters())
    where = "" if trainer.mesh is None else \
        f" mesh={trainer.mesh.shape} backend={trainer.mesh.backend}"
    say(f"device={dev}{where} arch={cfg.name} layers={cfg.num_layers} "
        f"params={n_params / 1e6:.1f}M{' (rank 0 block)' if where else ''} "
        f"start_step={start}")
    before = launch_counts()["grouped_matmul"]
    metrics = trainer.run(args.steps)
    launches = launch_counts()["grouped_matmul"] - before
    steps = len(trainer.history)
    planned = trainer.model.grouped_launches_per_step(train=True) * \
        trainer.tcfg.grad_accum * steps if dev.type == "cuda" else 0
    for h in trainer.history:
        say(f"step {h['step']}: loss {h['loss']:.4f}, "
            f"{h['dt'] * 1e3:.1f} ms")
    if steps:
        median_ms = np.median([h["dt"] for h in trainer.history]) * 1e3
        say(f"{steps} steps, median {median_ms:.1f} ms; grouped_matmul "
            f"launches {launches} (planned {planned})")
    say("final metrics:", metrics)
    if trainer.straggler_events:
        say(f"stragglers observed: {len(trainer.straggler_events)}")
    if launches != planned:
        raise RuntimeError(f"{cfg.name}: grouped_matmul launched {launches} "
                           f"times, planned {planned}")
    return {"trainer": trainer, "metrics": metrics, "launches": launches,
            "planned": planned}


def train_world(args) -> dict:
    """``--mesh``: spawn ``data * model`` ranks on this host, each training
    its blocks (:func:`mesh_rank`), and return rank 0's record.

    Raises:
        RuntimeError: a rank failed (its traceback), or no card.
    """
    from repro_torch.launch import train as this
    from repro_torch.launch.spawn import run_world
    shape = parse_mesh(args.mesh)
    dev = resolve_device(args.device)
    world = shape[0] * shape[1]
    distinct = dev.type == "cuda" and torch.cuda.device_count() >= world
    # CPU ranks share the host's cores: a thread per core in each would
    # oversubscribe them.
    threads = max(1, (os.cpu_count() or 1) // world) \
        if dev.type == "cpu" else None
    results = run_world(this.mesh_rank, world, args, shape, distinct,
                        threads=threads)
    return results[0]


def mesh_rank(rank: int, world: int, args, shape: tuple,
              distinct: bool) -> dict:
    """One rank of ``--mesh``: its ``ProcessMesh`` (gloo on the CPU, NCCL
    on ``cuda:rank`` with a card per rank, else gloo on ``cuda:0``) and
    its trainer; returns its record with the history in place of the
    trainer."""
    from repro_torch.launch.mesh import make_process_mesh
    cpu = torch.device(args.device or "cuda").type == "cpu"
    dev = torch.device("cpu") if cpu else \
        torch.device("cuda", rank if distinct else 0)
    backend = None if cpu or distinct else "gloo"
    mesh = make_process_mesh(shape, ("data", "model"), device=dev,
                             backend=backend)
    rec = train(args, make_trainer(args, mesh))
    trainer = rec.pop("trainer")
    rec.update(rank=rank, history=trainer.history,
               backend=mesh.backend,
               straggler_events=trainer.straggler_events)
    return rec


def main(argv=None):
    """Train an arch from the command line (see the module docstring)."""
    logging.basicConfig(level=logging.INFO)
    train(parser().parse_args(argv))


if __name__ == "__main__":
    main()
