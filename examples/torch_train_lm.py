"""End-to-end training on the PyTorch/CUDA port: a small LM for a few
hundred steps through the whole substrate (data pipeline -> train step ->
checkpoints -> straggler watchdog), then a new trainer resumes from the
checkpoint to prove restart; the port of ``examples/train_lm.py``.

    PYTHONPATH=src python examples/torch_train_lm.py --steps 200   # the card
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --steps 20 \\
        --mesh 2,2

``--mesh data,model`` trains the partitioned step (FSDP over ``data``,
tensor and sequence parallel over ``model``) in a world of ``data *
model`` ranks spawned on this host (``launch.spawn.run_world``): gloo on
the CPU; on the card NCCL with a card per rank, else gloo with the ranks
sharing ``cuda:0``.  The default config is a ~2M-parameter llama-style
model.
"""
import argparse
import dataclasses
import os
import tempfile

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer, TrainerConfig


def config(arch: str):
    return dataclasses.replace(
        get_config(arch).reduced(), num_layers=4, d_model=128, num_heads=4,
        head_dim=32, d_ff=512, vocab_size=2048)


def trainer(args, mesh=None) -> Trainer:
    shape = ShapeConfig("example", seq_len=128, global_batch=8,
                        kind="train")
    tcfg = TrainerConfig(
        ckpt_dir=args.ckpt_dir, ckpt_every=50,
        schedule_kwargs={"warmup_steps": 20, "total_steps": args.steps})
    return Trainer(config(args.arch), shape, tcfg, mesh=mesh,
                   opt_cfg=adamw.AdamWConfig(lr=1e-3),
                   data_cfg=DataConfig(seed=0),
                   device=None if mesh is not None else args.device)


def run(args, mesh=None) -> list:
    """Train to half the steps, stop (preemption), resume to the end with a
    new trainer; returns the losses (every rank's are the global ones)."""
    loud = mesh is None or mesh.rank == 0
    first = trainer(args, mesh)
    first.init_or_restore()
    first.run(args.steps, stop_after=args.steps // 2)
    losses = [h["loss"] for h in first.history]
    resumed = trainer(args, mesh)
    resumed.init_or_restore()
    if loud:
        n = sum(p.numel() for p in first.model.parameters())
        print(f"{'rank 0 block of ' if mesh else ''}{n / 1e6:.2f}M params; "
              f"pre-restart: step {first.history[-1]['step']} loss "
              f"{losses[-1]:.3f}; resumed at step {resumed.start_step}")
    resumed.run(args.steps)
    return losses + [h["loss"] for h in resumed.history]


def mesh_rank(rank: int, world: int, args, shape: tuple) -> list:
    """One rank of ``--mesh``: its process mesh and its trainers."""
    from repro_torch.launch.mesh import make_process_mesh
    cpu = torch.device(args.device or "cuda").type == "cpu"
    distinct = not cpu and torch.cuda.device_count() >= world
    dev = torch.device("cpu") if cpu else \
        torch.device("cuda", rank if distinct else 0)
    mesh = make_process_mesh(shape, ("data", "model"), device=dev,
                             backend=None if cpu or distinct else "gloo")
    return run(args, mesh)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--mesh", default="", help="'data,model'")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    args.ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_train_")
    if args.mesh:
        from repro_torch.launch.spawn import run_world
        from repro_torch.launch.train import parse_mesh
        import torch_train_lm as this
        shape = parse_mesh(args.mesh)
        world = shape[0] * shape[1]
        threads = max(1, (os.cpu_count() or 1) // world)
        losses = run_world(this.mesh_rank, world, args, shape,
                           threads=threads)[0]
    else:
        losses = run(args)
    k = max(len(losses) // 10, 1)
    first, last = sum(losses[:k]) / k, sum(losses[-k:]) / k
    print(f"loss: first10%={first:.3f} last10%={last:.3f}")
    assert last < first, "loss did not drop"
    print("OK: trained, checkpointed, restarted, loss decreased")
    return losses


if __name__ == "__main__":
    main()
