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


def prefill_case(case: dict, weights: dict, batch: dict) -> dict:
    """The partitioned prefill of a case on its batch (tokens and the
    modality keys): this rank's block of the logits and its spec."""
    port_model.COMPUTE_DTYPE = torch.float32
    mesh = _mesh(case)
    cfg = case_config(case)
    shape = ShapeConfig("p", case["seq"], case["batch"], "prefill")
    model = interop.params_from_numpy(cfg, unflatten(weights), mesh=mesh)
    fn, specs = TS.make_prefill_step(cfg, shape, mesh)
    local = SH.batch_shard({k: torch.from_numpy(v) for k, v in batch.items()},
                           cfg, mesh, shape)
    with Margins() as margins:
        logits = fn(model, local)
    return {"coords": dict(mesh.coords), "logits": logits.numpy(),
            "spec": specs["logits"], "margin": margins.worst}


def prime_case(case: dict, weights: dict, inputs: dict) -> dict:
    """whisper's cross cache over a case's mesh: the encoder over the mesh
    (``LM.encode`` with the serve step's context) on this rank's frames,
    then ``LM.prime_cross_cache`` into the rank's blocks of an empty
    cache.  Returns the encoder's output, each layer's ``cross_k`` /
    ``cross_v`` blocks and their specs."""
    port_model.COMPUTE_DTYPE = torch.float32
    mesh = _mesh(case)
    cfg = case_config(case)
    shape = ShapeConfig("d", case["cache_len"], case["batch"], "decode")
    model = interop.params_from_numpy(cfg, unflatten(weights), mesh=mesh)
    _, specs = TS.make_serve_step(cfg, shape, mesh)
    local = SH.batch_shard({"frames": torch.from_numpy(inputs["frames"])},
                           cfg, mesh, shape)
    with torch.no_grad():
        enc = model.encode(local["frames"],
                           ctx=TS.make_ctx(cfg, mesh, shape))
        cache = model.init_cache(case["batch"], case["cache_len"], mesh=mesh,
                                 specs=specs["cache"])
        model.prime_cross_cache(cache, enc, specs["cache"])
    return {"coords": dict(mesh.coords), "enc_out": enc.numpy(),
            "cache": [{k: layer[k].numpy() for k in ("cross_k", "cross_v")}
                      for layer in cache],
            "specs": [layer["cross_k"] for layer in specs["cache"]]}


def serve_case(case: dict, weights: dict, inputs: dict) -> dict:
    """The serve step over a case's mesh: every step's block of the
    logits, the final cache blocks (the reference's layout, this rank's
    blocks) and the whole final cache (``interop.cache_to_numpy``), the
    parameter blocks, the specs and the router's worst margin; or the
    ``ValueError`` a step raised."""
    port_model.COMPUTE_DTYPE = torch.float32
    mesh = _mesh(case)
    cfg = case_config(case)
    shape = ShapeConfig("d", case["cache_len"], case["batch"], "decode")
    model = interop.params_from_numpy(cfg, unflatten(weights), mesh=mesh)
    fn, specs = TS.make_serve_step(cfg, shape, mesh)
    if cfg.family == "encdec":
        whole = model.cache_shapes(case["batch"], case["cache_len"])
        tree = {"p0": {"kv": {n: np.zeros((cfg.num_layers,) + whole[0][n][0],
                                          np.float32) for n in ("k", "v")},
                       "cross_k": inputs["cross_k"],
                       "cross_v": inputs["cross_v"]}}
        cache = interop.cache_from_numpy(cfg, tree, mesh=mesh,
                                         specs=specs["cache"])
    else:
        cache = model.init_cache(case["batch"], case["cache_len"], mesh=mesh,
                                 specs=specs["cache"])
    out = {"coords": dict(mesh.coords), "specs": specs, "logits": []}
    with Margins() as margins:
        try:
            for t, tokens in enumerate(inputs["tokens"]):
                local = SH.batch_shard(
                    {"tokens": torch.from_numpy(tokens)[:, None]}, cfg, mesh,
                    shape)["tokens"][:, 0]
                out["logits"].append(fn(model, cache, local, t).numpy())
        except ValueError as e:
            return {"coords": dict(mesh.coords), "error": str(e)}
    out["margin"] = margins.worst
    out["cache"] = flat(interop.cache_tree(cfg, cache))
    out["whole_cache"] = flat(interop.cache_to_numpy(model, cache,
                                                     specs["cache"]))
    out["params"] = _blocks(cfg, dict(model.named_parameters()))
    return out


def serve_rank(rank: int, world: int, cases: list, weights: dict,
               inputs: dict) -> dict:
    """Every serve case of a test module, in this rank."""
    return {c["name"]: serve_case(c, weights[c["name"]], inputs[c["name"]])
            for c in cases}


#: The rank's function of each case kind of a train or prefill module.
CASE_KINDS = {"train": train_case, "prefill": prefill_case,
              "prime": prime_case}


def train_rank(rank: int, world: int, cases: list, weights: dict,
               batches: dict) -> dict:
    """Every case of a test module (train, prefill or cross cache), in
    this rank."""
    return {c["name"]: CASE_KINDS[c["kind"]](c, weights[c["name"]],
                                             batches[c["name"]])
            for c in cases}


def prefill_rank(rank: int, world: int, cases: list, weights: dict,
                 batches: dict) -> dict:
    """Every prefill case of a test module, in this rank."""
    return {c["name"]: prefill_case(c, weights[c["name"]],
                                    batches[c["name"]]) for c in cases}


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


#: The last valid slot of the combine units' 16-slot cache: over four
#: blocks of 4, two blocks are all valid, one has two valid slots and one
#: none.
COMBINE_POS = 9

#: The sequence axes the combine units split the cache over.
COMBINE_AXES = (("model",), ("data", "model"))


def combine_inputs():
    """q ``[2, 1, 4, 8]``, k and v ``[2, 16, 2, 8]`` (from a seed) and the
    ``[2, 16]`` mask of the slots ``<= COMBINE_POS``."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 8))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 16, 2, 8))
                         .astype(np.float32) * 3)
    v = torch.from_numpy(rng.standard_normal((2, 16, 2, 8))
                         .astype(np.float32))
    mask = (torch.arange(16) <= COMBINE_POS)[None].expand(2, 16)
    return q, k, v, mask


def _combine(mesh, axes, fault=None) -> np.ndarray:
    """This rank's block of the cache, its partial attention and the
    combine over ``axes``; ``fault`` "no rescale" sums ``l`` and ``acc``
    without ``e^{m - m*}``."""
    from repro_torch.core import comm
    from repro_torch.models import attention as A
    q, k, v, mask = combine_inputs()
    blk = k.shape[1] // SH.axes_size(mesh, axes)
    i = SH.axes_index(mesh, axes)
    mine = slice(i * blk, (i + 1) * blk)
    acc, m, l = A.decode_attention_partial(q, k[:, mine], v[:, mine],
                                           mask[:, mine])
    if fault == "no rescale":
        l = comm.psum(l, axes, mesh=mesh)
        return (comm.psum(acc, axes, mesh=mesh) / l[..., None]).numpy()
    return A.combine(acc, m, l, mesh, axes, q.dtype).numpy()


#: The serve units' decode: batch, cache length and steps (the last four
#: steps write the second block of the sequence over ``"model"``).
SERVE_UNIT = {"batch": 4, "cache_len": 16, "steps": 12}

#: Planted faults of the serve units: the new K/V written on every rank,
#: not only the owner of its slot (llama3.2-1b), and mamba's ``u`` and
#: ``z`` taken from the contiguous block of ``in_proj`` (falcon-mamba-7b).
SERVE_FAULTS = {"every rank writes": "llama3.2-1b",
                "contiguous u and z": "falcon-mamba-7b"}


def _serve_unit(mesh, arch: str, fault=None) -> dict:
    """The partitioned decode of reduced ``arch`` (fp32, weights from
    seed 0) against one process's on the same tokens: the worst error of
    the logits blocks over the largest |logit| and of the final recurrent
    state blocks over their largest, with ``fault`` planted."""
    from repro_torch.models import layers as port_layers
    from repro_torch.models import ssm as port_ssm
    port_model.COMPUTE_DTYPE = torch.float32
    cfg = get_config(arch).reduced()
    b, cl = SERVE_UNIT["batch"], SERVE_UNIT["cache_len"]
    shape = ShapeConfig("d", cl, b, "decode")

    def seeded():
        return port_model.init_params(
            cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    one, part = seeded(), seeded().shard(mesh)
    serve1, _ = TS.make_serve_step(cfg, shape)
    serve, specs = TS.make_serve_step(cfg, shape, mesh)
    c1, cp = one.init_cache(b, cl), part.init_cache(b, cl, mesh=mesh)
    real = SH.slot_owner, port_ssm.in_proj_channels
    if fault == "every rank writes":
        SH.slot_owner = lambda slot, s_c, axes, m: (
            SH.axes_index(m, SH.axes_of(axes)), real[0](slot, s_c, axes,
                                                        m)[1])
    if fault == "contiguous u and z":
        port_ssm.in_proj_channels = lambda p, x, ctx: torch.chunk(
            port_layers.local_dense(x, p.in_proj, ctx), 2, dim=-1)
    rng = np.random.default_rng(5)
    err = 0.0
    try:
        for t in range(SERVE_UNIT["steps"]):
            tokens = torch.from_numpy(rng.integers(2, cfg.vocab_size - 1,
                                                   size=b))
            want = serve1(one, c1, tokens, t)
            local = SH.batch_shard({"tokens": tokens[:, None]}, cfg, mesh,
                                   shape)["tokens"][:, 0]
            got = serve(part, cp, local, t)
            block = SH.local_block(want, specs["logits"], mesh)
            err = max(err, float((got - block).abs().max()
                                 / want.abs().max()))
    finally:
        SH.slot_owner, port_ssm.in_proj_channels = real
    state = 0.0
    for l1, lp, spec in zip(c1, cp, specs["cache"]):
        if "h" in l1:
            state = max(state, float(
                (SH.local_block(l1["h"], spec["h"], mesh) - lp["h"]).abs()
                .max() / l1["h"].abs().max()))
    return {"logits": err, "state": state}


def units_rank(rank: int, world: int, logits: np.ndarray,
               labels: np.ndarray, vocab: int, grads: dict,
               specs: dict) -> dict:
    mesh = make_process_mesh((2, 2), ("data", "model"), device="cpu")
    out = {"coords": dict(mesh.coords), "xent": _xent(mesh, logits, labels,
                                                      vocab),
           "norm": _norm(mesh, grads, specs),
           "combine": {axes: _combine(mesh, axes) for axes in COMBINE_AXES},
           "serve": {arch: _serve_unit(mesh, arch)
                     for arch in SERVE_FAULTS.values()}}
    out["faults"] = {"no psum": _xent(mesh, logits, labels, vocab,
                                      "no psum"),
                     "replicated counted twice": _norm(
                         mesh, grads, specs, "replicated counted twice"),
                     "no rescale": {axes: _combine(mesh, axes, "no rescale")
                                    for axes in COMBINE_AXES},
                     **{f: _serve_unit(mesh, arch, f)
                        for f, arch in SERVE_FAULTS.items()}}
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
