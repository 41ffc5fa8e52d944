"""The ranks of the port's partitioned-step tests
(``tests/test_torch_gspmd_*.py``).

Each function here runs in every rank of a world of four gloo CPU ranks
that ``repro_torch.launch.spawn.run_world`` spawns; it builds one
``ProcessMesh`` per case inside that world, runs the port's partitioned
step on the reference's weights and batches (numpy, fp32), and returns
numpy results: each rank's blocks, its metrics, and the router's top-k
margins.  The module imports torch and the port only, never jax or the
reference, so that a rank starts quickly.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import interop
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tree import unflatten
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import make_process_mesh
from repro_torch.models import model as port_model
from repro_torch.models import moe as port_moe
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS

LR = 3e-4
SCHEDULE = {"warmup_steps": 2, "total_steps": 10}


def case_config(case: dict):
    """The port's reduced config of a case, with its overrides."""
    return dataclasses.replace(get_config(case["arch"]).reduced(),
                               **case.get("overrides", {}))


def flat(tree: dict, prefix: str = "") -> dict:
    """``{"a/b/c": array}`` of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


class Margins:
    """The smallest top-k margin of the port's router calls, each over the
    row's largest |logit| (the test holds it above the packages'
    agreement, so no near-tie can flip an expert), and the slots the
    rank's experts dropped at their capacity."""

    def __init__(self):
        self.worst = float("inf")
        self.dropped = 0
        self.orig = port_moe.router, port_moe.bucket_local

    def __enter__(self):
        router, bucket = self.orig

        def recording(x, kernel, k):
            z = (x.float() @ kernel.float()).detach()
            top = torch.sort(z, dim=-1, descending=True).values
            margin = (top[:, k - 1] - top[:, k]) / \
                z.abs().amax(dim=-1).clamp(min=1e-30)
            self.worst = min(self.worst, float(margin.min()))
            return router(x, kernel, k)

        def counting(x, weights, ids, e0, e_loc, cap, rows=None):
            _, local, pos = port_moe.slot_ranks(ids, e0, e_loc)
            self.dropped += int((local & (pos >= cap)).sum())
            return bucket(x, weights, ids, e0, e_loc, cap, rows)
        port_moe.router, port_moe.bucket_local = recording, counting
        return self

    def __exit__(self, *exc):
        port_moe.router, port_moe.bucket_local = self.orig


def _mesh(case: dict):
    """The case's mesh; the models made after it fuse their projections
    where the case says so."""
    port_model.set_fused_projections(bool(case.get("fused")))
    return make_process_mesh(tuple(case["shape"]), tuple(case["axes"]),
                             device="cpu")


def _blocks(cfg, named: dict) -> dict:
    """Port blocks by name -> the reference's layout, flat, copied (an
    fp32 CPU tensor's ``numpy()`` shares its memory, which the next step
    updates in place)."""
    return {k: np.array(v) for k, v in
            flat(interop.tree_to_numpy(cfg, named)).items()}


def train_case(case: dict, weights: dict, batches: list) -> dict:
    """``len(batches)`` partitioned train steps (steps 1, 2, ...) of a case
    on its mesh: each step's metrics, this rank's parameter, ``mu`` /
    ``nu`` and gradient blocks in the reference's layout, the specs by
    port name, and the router's worst margin."""
    port_model.COMPUTE_DTYPE = torch.float32
    mesh = _mesh(case)
    cfg = case_config(case)
    shape = ShapeConfig("t", case["seq"], case["batch"], "train")
    ga = case.get("grad_accum", 1)
    model = interop.params_from_numpy(cfg, unflatten(weights), masters=True,
                                      mesh=mesh)
    opt_cfg = adamw.AdamWConfig(lr=LR)
    step, specs = TS.make_train_step(cfg, shape, mesh, opt_cfg=opt_cfg,
                                     grad_accum=ga,
                                     chunked_loss=bool(case.get("chunked")),
                                     schedule_kwargs=SCHEDULE)
    opt = adamw.init_state(dict(model.named_parameters()), opt_cfg)
    grads = []
    apply = adamw.apply_updates

    def recording(params, g, state, cfg_, lr_scale=1.0, **kw):
        grads.append(_blocks(cfg, g))
        return apply(params, g, state, cfg_, lr_scale, **kw)
    adamw.apply_updates = recording
    out = {"coords": dict(mesh.coords), "metrics": [], "params": [],
           "mu": [], "nu": [], "specs": specs["params"]}
    try:
        with Margins() as margins:
            for s, batch in enumerate(batches):
                local = SH.batch_shard(
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    cfg, mesh, shape, ga)
                m = step(model, opt, local, s + 1)
                out["metrics"].append({k: float(v) for k, v in m.items()})
                out["params"].append(_blocks(
                    cfg, dict(model.named_parameters())))
                out["mu"].append(_blocks(cfg, opt["mu"]))
                out["nu"].append(_blocks(cfg, opt["nu"]))
    finally:
        adamw.apply_updates = apply
    out["grads"] = grads
    out["margin"], out["dropped"] = margins.worst, margins.dropped
    return out


def prefill_case(case: dict, weights: dict, tokens: np.ndarray) -> dict:
    """The partitioned prefill of a case: this rank's block of the logits
    and its spec."""
    port_model.COMPUTE_DTYPE = torch.float32
    mesh = _mesh(case)
    cfg = case_config(case)
    shape = ShapeConfig("p", case["seq"], case["batch"], "prefill")
    model = interop.params_from_numpy(cfg, unflatten(weights), mesh=mesh)
    fn, specs = TS.make_prefill_step(cfg, shape, mesh)
    local = SH.batch_shard({"tokens": torch.from_numpy(tokens)}, cfg, mesh,
                           shape)
    with Margins() as margins:
        logits = fn(model, local)
    return {"coords": dict(mesh.coords), "logits": logits.numpy(),
            "spec": specs["logits"], "margin": margins.worst}


def train_rank(rank: int, world: int, cases: list, weights: dict,
               batches: dict) -> dict:
    """Every train case of a test module, in this rank."""
    return {c["name"]: train_case(c, weights[c["name"]], batches[c["name"]])
            for c in cases}


def prefill_rank(rank: int, world: int, cases: list, weights: dict,
                 tokens: dict) -> dict:
    """Every prefill case of a test module, in this rank."""
    return {c["name"]: prefill_case(c, weights[c["name"]],
                                    tokens[c["name"]]) for c in cases}


# --------------------------------------------------------------------- #
# Units: the vocab-parallel loss and the sharded norm on (2, 2).
# --------------------------------------------------------------------- #

#: Planted faults of the units: the loss's ``psum`` over ``"model"`` left
#: out, and a replicated leaf's sum of squares summed over ``"data"``
#: (counted twice).
UNIT_FAULTS = ("no psum", "replicated counted twice")


def _xent(mesh, logits, labels, vocab, fault=None) -> dict:
    from repro_torch.core import comm
    di, mi = mesh.axis_index("data"), mesh.axis_index("model")
    b = logits.shape[0] // mesh.shape["data"]
    v = logits.shape[-1] // mesh.shape["model"]
    local = torch.from_numpy(logits[di * b:(di + 1) * b, :,
                                    mi * v:(mi + 1) * v]).requires_grad_()
    lab = torch.from_numpy(labels[di * b:(di + 1) * b])
    real = comm.psum
    if fault == "no psum":
        comm.psum = lambda x, axis, *, mesh=None: x
    try:
        losses = TS._token_losses(local, lab, vocab, mesh, mi * v)
    finally:
        comm.psum = real
    # This rank's share of the mean: its rows' losses over the global
    # count and the "model" ranks that hold the same rows.
    (losses.sum() / (labels.size * mesh.shape["model"])).backward()
    return {"losses": losses.detach().numpy(), "grad": local.grad.numpy()}


def _norm(mesh, grads: dict, specs: dict, fault=None) -> float:
    blocks = {k: SH.local_block(torch.from_numpy(v), specs[k], mesh)
              for k, v in grads.items()}
    used = dict(specs)
    if fault == "replicated counted twice":
        used["bias"] = ("data",)
    return float(adamw.global_norm(blocks, used, mesh))


def units_rank(rank: int, world: int, logits: np.ndarray,
               labels: np.ndarray, vocab: int, grads: dict,
               specs: dict) -> dict:
    mesh = make_process_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"coords": dict(mesh.coords), "xent": _xent(mesh, logits, labels,
                                                      vocab),
           "norm": _norm(mesh, grads, specs)}
    out["faults"] = {"no psum": _xent(mesh, logits, labels, vocab,
                                      "no psum"),
                     "replicated counted twice": _norm(
                         mesh, grads, specs, "replicated counted twice")}
    return out


# --------------------------------------------------------------------- #
# The trainer over (2, 2): preempted and resumed against uninterrupted.
# --------------------------------------------------------------------- #

def trainer_rank(rank: int, world: int, root: str, steps: int,
                 stop: int) -> dict:
    """Reduced olmoe-1b-7b's ``Trainer(mesh=)`` on ``(2, 2)``: ``steps``
    steps uninterrupted (in ``root/whole``), and preempted after ``stop``
    steps then resumed to ``steps`` by a new trainer (``root/resumed``).
    Returns both runs' histories and final blocks (numpy, by port
    name)."""
    import os
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig
    mesh = make_process_mesh((2, 2), ("data", "model"), device="cpu")
    cfg = get_config("olmoe-1b-7b").reduced()
    shape = ShapeConfig("t", 32, 4, "train")

    def trainer(d):
        return Trainer(cfg, shape, TrainerConfig(
            ckpt_dir=os.path.join(root, d), ckpt_every=100,
            schedule_kwargs={"warmup_steps": 1, "total_steps": steps}),
            mesh=mesh)

    def blocks(t):
        named = {n: p.detach().clone().numpy()
                 for n, p in t.model.named_parameters()}
        return named, {k: v.clone().numpy() for k, v in t.opt_state["mu"]
                       .items()}

    whole = trainer("whole")
    whole.run(steps)
    first = trainer("resumed")
    first.run(steps, stop_after=stop)
    resumed = trainer("resumed")
    start = resumed.init_or_restore()
    resumed.run(steps)
    return {"coords": dict(mesh.coords), "specs": whole.specs["params"],
            "whole": blocks(whole), "resumed": blocks(resumed),
            "start": start,
            "history": {"whole": [h["loss"] for h in whole.history],
                        "first": [h["loss"] for h in first.history],
                        "resumed": [h["loss"] for h in resumed.history]}}
