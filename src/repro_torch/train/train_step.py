"""The train step: forward (per-layer checkpointed), softmax cross-entropy
over the padded vocab, backward, AdamW (the reference's
``repro.train.train_step.make_train_step``), and the prefill and serve
steps (``make_prefill_step``, ``make_serve_step``).

Over a mesh (a ``launch.mesh.ProcessMesh``; the train, prefill and serve
steps of all ten archs) the steps are the per-rank programs that XLA's
partitioner derives from the reference's policy (``launch.sharding``):
every rank holds its block of each parameter (``LM.shard``) and of the
optimiser state, and its data shard of the batch
(``launch.sharding.batch_shard``); the layers change layouts at the
Megatron points (``models.layers``, ``models.model``) with
``core.comm``'s collectives, whose transposes give the backward.  The
loss is vocab-parallel: a ``pmax`` over ``"model"`` of the detached
maximum, a ``psum`` of the sums of exponentials and of the gold logit
(a masked gather), the padded columns masked by their global index, and
the mean over the global token count.  Each rank differentiates its share
of it (its tokens' losses over the global count, divided by the ranks
that hold the same tokens), so that the shares of every rank sum to the
loss.  The serve step decodes one token per row against the decode cache
split along its sequence (``launch.sharding.cache_pspecs``): each
attention layer's softmax is combined over the cache's blocks
(``models.attention.combine``), and a recurrent layer's state is split
by its channels.

Microbatch gradient accumulation (``grad_accum``) sums the fp32
micro-gradients and scales them, as the reference does.  The step updates
the model's parameters and the optimiser state in place and returns its
metrics.  On the card every MoE layer's expert FFN launches the
grouped-matmul kernel in the forward, in its recompute and for its input
gradient (``LM.grouped_launches_per_step(train=True)``).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.core import comm
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.models.sharding_ctx import (NO_SHARDING, ShardingCtx,
                                             step_dims)
from repro_torch.optim import adamw
from repro_torch.optim.schedule import cosine_with_warmup

#: Logit given to the padded vocab columns.
PAD_LOGIT = -1e30

#: The batch entries besides ``tokens`` and ``labels`` that the model
#: takes: whisper's encoder frames, qwen2-vl's patch embeddings and M-RoPE
#: positions (``data.pipeline``'s modality stubs).
MODALITY_KEYS = ("frames", "mm_embeds", "positions_3d")

#: ``step_fn(model, opt_state, batch, step) -> metrics``.
StepFn = Callable[..., Dict]


def _token_losses(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: Optional[int], mesh=None,
                  v0: int = 0) -> torch.Tensor:
    """``logsumexp - gold`` per token, fp32, the columns ``>= vocab``
    masked.  With ``mesh``, ``logits`` are this rank's block of the vocab
    (global columns ``[v0, v0 + V_local)``) and the reductions run over
    ``"model"``: a ``pmax`` of the detached maximum, a ``psum`` of the
    sums of exponentials and of the gold logit."""
    logits = logits.float()
    if mesh is None:
        if vocab is not None and vocab < logits.shape[-1]:
            pad = torch.arange(logits.shape[-1],
                               device=logits.device) >= vocab
            logits = torch.where(pad, PAD_LOGIT, logits)
        gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
        return torch.logsumexp(logits, dim=-1) - gold
    rows = logits.shape[-1]
    cols = v0 + torch.arange(rows, device=logits.device)
    if vocab is not None:
        logits = torch.where(cols >= vocab, PAD_LOGIT, logits)
    m = comm.pmax(logits.detach().amax(dim=-1), "model", mesh=mesh)
    sumexp = comm.psum(torch.exp(logits - m[..., None]).sum(dim=-1),
                       "model", mesh=mesh)
    local = labels.long() - v0
    inside = (local >= 0) & (local < rows)
    gold = torch.gather(logits, -1, local.clamp(0, rows - 1)[..., None])
    gold = comm.psum(torch.where(inside, gold[..., 0], 0.0), "model",
                     mesh=mesh)
    return torch.log(sumexp) + m - gold


def _mesh_loss(cfg: ModelConfig, logits: torch.Tensor,
               labels: torch.Tensor, ctx: ShardingCtx) -> torch.Tensor:
    """This rank's share of the mean loss in a partitioned step: the sum
    of its tokens' losses (vocab-parallel where ``logits`` are a block of
    the vocab) over the global token count and over the ranks that hold
    the same tokens."""
    mesh = ctx.process_mesh
    rows = logits.shape[-1]
    split = rows != cfg.padded_vocab
    losses = _token_losses(logits, labels, cfg.vocab_size,
                           mesh if split else None,
                           mesh.axis_index("model") * rows if split else 0)
    # The ranks that hold the same rows: the mesh over the data shards
    # the batch's rule splits it into.
    dp = SH.axes_of(ctx.rules["tokens_bse"][0])
    replicas = mesh.size // SH.axes_size(mesh, dp)
    return losses.sum() / (ctx.dims["b"] * ctx.dims["s"] * replicas)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token loss; the padded vocab columns (``>= vocab``) get
    :data:`PAD_LOGIT`."""
    return _token_losses(logits, labels, vocab).mean()


def make_ctx(cfg: ModelConfig, mesh, shape: ShapeConfig,
             grad_accum: int = 1) -> ShardingCtx:
    """The sharding context of a step: :data:`NO_SHARDING` without a
    mesh, else the policy's activation rules on ``mesh``
    (``launch.sharding.activation_rules``); on a ``ProcessMesh`` also the
    global dims of one micro-batch (``models.sharding_ctx.step_dims``),
    which make it a partitioned step's context."""
    if mesh is None:
        return NO_SHARDING
    dims = None
    if isinstance(mesh, ProcessMesh) and shape.kind == "decode":
        # One token per row; "c" is the cache's length.
        dims = {**step_dims(cfg, shape.global_batch, 1),
                "c": shape.seq_len}
    elif isinstance(mesh, ProcessMesh):
        dims = step_dims(cfg, shape.global_batch // grad_accum,
                         shape.seq_len)
    return ShardingCtx(SH.activation_rules(cfg, mesh, shape), mesh,
                       dims=dims)


def step_specs(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict:
    """The specs of a partitioned step (the reference's ``shardings``):
    ``params`` (``launch.sharding.param_pspecs`` by the port's names),
    ``opt`` (AdamW's state) and ``batch``."""
    from repro_torch.models.model import LM
    named = dict(LM(cfg, device="meta", masters=True).named_parameters())
    pspecs = SH.param_pspecs(cfg, named, mesh)
    return {"params": pspecs, "opt": SH.opt_state_pspecs(pspecs),
            "batch": SH.batch_pspecs(cfg, mesh, shape)}


def _check_mesh(cfg: ModelConfig, mesh, what: str) -> None:
    from repro_torch.models.model import check_mesh_supported
    check_mesh_supported(cfg)
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(f"{what} over a mesh runs on a launch.mesh."
                        f"ProcessMesh (one rank per process), not "
                        f"{type(mesh).__name__}")


def chunked_xent(model, hidden: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 512,
                 ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """Cross-entropy without materialising ``[B, S, V]`` fp32 logits: the
    sequence goes in chunks (the largest divisor of S up to ``chunk``),
    each chunk's unembed product and logsumexp checkpointed, so the peak
    logits memory is ``B * chunk * V``.  Each chunk's logits are
    constrained as ``"logits_bsv"``."""
    B, S, _ = hidden.shape
    ch = min(chunk, S)
    while S % ch:
        ch -= 1
    table = model.unembed_table()
    vocab = model.cfg.vocab_size

    def chunk_loss(h_c, lab_c, table):
        logits = ctx.constrain((h_c @ table.to(h_c.dtype).T).float(),
                               "logits_bsv")
        return _token_losses(logits, lab_c, vocab).sum()

    def chunk_loss_mesh(h_c, lab_c):
        return _mesh_loss(model.cfg, model.head_mesh(h_c, ctx), lab_c, ctx)

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // ch):
        part = slice(i * ch, (i + 1) * ch)
        if ctx.process_mesh is not None:
            total = total + checkpoint(chunk_loss_mesh, hidden[:, part],
                                       labels[:, part], use_reentrant=False)
        else:
            total = total + checkpoint(chunk_loss, hidden[:, part],
                                       labels[:, part], table,
                                       use_reentrant=False)
    return total if ctx.process_mesh is not None else total / (B * S)


def make_grads(cfg: ModelConfig, *, remat: bool = True,
               grad_accum: int = 1, chunked_loss: bool = False,
               ctx: ShardingCtx = NO_SHARDING):
    """``grads_fn(model, batch) -> (loss, {name: grad})``: the mean loss
    (0-d fp32, detached) and the gradient of every parameter of ``model``
    by name.  With ``grad_accum`` > 1 the batch splits into that many
    micro-batches along its first axis; their fp32 gradients and losses
    are summed and scaled by ``1 / grad_accum``.  ``ctx`` goes to the
    model and the chunked loss.

    In a partitioned step (``ctx`` of ``make_ctx`` on a ``ProcessMesh``)
    ``model`` holds this rank's blocks and ``batch`` its data shard
    (``launch.sharding.batch_shard`` with the same ``grad_accum``, so that
    its micro-batch ``i`` is its rows of the reference's micro-batch
    ``i``); the gradients are of the blocks, and the loss is the global
    mean on every rank.

    ``grads_fn`` raises ``ValueError`` for a batch with ``positions_3d``
    at ``grad_accum`` > 1: the micro-batches split every entry along its
    first axis, and M-RoPE's positions are ``[3, B, S]`` (the reference's
    step cannot split them either)."""
    mesh = ctx.process_mesh

    def loss_fn(model, batch):
        extras = {k: batch[k] for k in MODALITY_KEYS if k in batch}
        if chunked_loss:
            hidden = model(batch["tokens"], remat=remat,
                           return_pre_logits=True, ctx=ctx, **extras)
            return chunked_xent(model, hidden, batch["labels"], ctx=ctx)
        logits = model(batch["tokens"], remat=remat, ctx=ctx, **extras)
        if mesh is not None:
            return _mesh_loss(cfg, logits, batch["labels"].to(logits.device),
                              ctx)
        return softmax_xent(logits, batch["labels"], cfg.vocab_size)

    def metric(loss):
        loss = loss.detach()
        return loss if mesh is None else \
            comm.psum(loss, mesh.axis_names, mesh=mesh)

    def grads_fn(model, batch):
        params = dict(model.named_parameters())
        names = list(params)
        leaves = [params[n] for n in names]
        if grad_accum == 1:
            loss = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, leaves)
            return metric(loss), dict(zip(names, grads))
        if "positions_3d" in batch:
            raise ValueError(
                f"grad_accum {grad_accum} splits every batch entry along "
                f"its first axis, and positions_3d is [3, B, S]: a batch "
                f"with M-RoPE positions takes grad_accum 1")
        micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                              + tuple(v.shape[1:])) for k, v in batch.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=model.device)
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()}
        for i in range(grad_accum):
            loss = loss_fn(model, {k: v[i] for k, v in micro.items()})
            for n, g in zip(names, torch.autograd.grad(loss, leaves)):
                acc[n].add_(g.float())
            loss_acc = loss_acc + metric(loss)
        inv = 1.0 / grad_accum
        return loss_acc * inv, {n: g * inv for n, g in acc.items()}

    return grads_fn


def make_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    remat: bool = True, grad_accum: int = 1,
                    chunked_loss: bool = False,
                    schedule_kwargs: Optional[Dict] = None):
    """``step_fn(model, opt_state, batch, step) -> metrics``, or over a
    ``mesh`` ``(step_fn, specs)``.

    ``model`` is an ``LM`` with fp32 masters (``masters=True``), updated in
    place with ``opt_state``; ``batch`` holds ``tokens`` and ``labels``
    ``[B, S]`` on the model's device; ``step`` is the step number (int or
    tensor) the learning-rate schedule reads.  The metrics are ``loss``,
    ``lr_scale`` and ``grad_norm``; ``loss`` and ``grad_norm`` stay 0-d
    tensors on the device (reading one waits for the step).

    Over a ``launch.mesh.ProcessMesh`` each rank calls ``step_fn`` with
    its blocks: the model :meth:`~repro_torch.models.model.LM.shard`-ed on
    ``mesh``, the optimiser state of those blocks and its rows of the
    batch (``launch.sharding.batch_shard(batch, cfg, mesh, shape,
    grad_accum)``); the metrics are the global ones on every rank.
    ``specs`` (:func:`step_specs`) name the blocks of ``params``, ``opt``
    and ``batch``.

    Raises:
        TypeError: a mesh that is not a ``ProcessMesh``.
        ValueError: a step on a batch with ``positions_3d`` at
            ``grad_accum`` > 1 (:func:`make_grads`).
    """
    ctx = NO_SHARDING
    specs = None
    if mesh is not None:
        _check_mesh(cfg, mesh, "make_train_step")
        ctx = make_ctx(cfg, mesh, shape, grad_accum)
        specs = step_specs(cfg, shape, mesh)
    sched = functools.partial(cosine_with_warmup, **(schedule_kwargs or {}))
    grads_fn = make_grads(cfg, remat=remat, grad_accum=grad_accum,
                          chunked_loss=chunked_loss, ctx=ctx)

    norm_kw = {} if mesh is None else {"specs": specs["params"],
                                       "mesh": mesh}

    def step_fn(model, opt_state, batch, step):
        loss, grads = grads_fn(model, batch)
        lr_scale = sched(step)
        om = adamw.apply_updates(dict(model.named_parameters()), grads,
                                 opt_state, opt_cfg, lr_scale, **norm_kw)
        return {"loss": loss, "lr_scale": lr_scale, **om}

    return step_fn if mesh is None else (step_fn, specs)


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """Inference prefill: ``(fn, specs)`` with ``fn(model, batch, ctx=)
    -> logits``, a forward with no recompute and no gradients on the
    model's device (``batch`` holds ``tokens`` and the modality keys).

    Without a mesh ``specs`` is None and ``ctx`` defaults to
    :data:`NO_SHARDING` (the dry run's counter passes its own).  Over a
    ``ProcessMesh`` the model is this rank's shard and ``batch`` its data
    shard; ``fn`` returns this rank's block of the logits, ``[B / dp, S,
    V_padded / tp]``, and ``specs`` holds ``params``, ``batch`` and
    ``logits`` (the reference's ``P(dp, None, "model")``).

    Raises:
        TypeError: a mesh that is not a ``ProcessMesh``.
    """
    default, specs = NO_SHARDING, None
    if mesh is not None:
        _check_mesh(cfg, mesh, "make_prefill_step")
        default = make_ctx(cfg, mesh, shape)
        full = step_specs(cfg, shape, mesh)
        dp, _ = SH.dp_axes_for_batch(mesh, shape.global_batch)
        specs = {"params": full["params"], "batch": full["batch"],
                 "logits": (SH.canonical(dp), None, "model")}

    def prefill(model, batch, ctx: ShardingCtx = default):
        extras = {k: batch[k] for k in MODALITY_KEYS if k in batch}
        with torch.no_grad():
            return model(batch["tokens"], remat=False, ctx=ctx, **extras)

    return prefill, specs


def make_serve_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None):
    """One decode step against a ``shape.seq_len`` cache: ``(fn, specs)``
    with ``fn(model, cache, tokens, pos, ctx=) -> logits``, the cache
    updated in place; M-RoPE configs get ``positions_3d`` = ``pos`` on all
    three streams, as the reference broadcasts it.

    Without a mesh ``specs`` is None, ``ctx`` defaults to
    :data:`NO_SHARDING` and the logits are ``[B, V_padded]``.  Over a
    ``ProcessMesh`` (every arch; ``shape`` a decode shape of the global
    batch) the model is this rank's shard (``LM.shard``), ``cache`` its
    blocks (``LM.init_cache(..., mesh=)`` or
    ``interop.cache_from_numpy(..., mesh=)``), ``tokens`` its rows
    ``[B / dp]`` (``launch.sharding.batch_shard``) and ``pos`` the same on
    every rank; ``fn`` returns this rank's block of the logits, ``[B /
    dp, V_padded / tp]``, and ``specs`` holds ``params``, ``cache``
    (``launch.sharding.cache_pspecs``) and ``logits`` (the reference's
    ``P(dp, "model")``).

    Raises:
        TypeError: a mesh that is not a ``ProcessMesh``.
        ValueError: a mesh with a shape that is not a decode shape.
    """
    default, specs = NO_SHARDING, None
    if mesh is not None:
        _check_mesh(cfg, mesh, "make_serve_step")
        if shape.kind != "decode":
            raise ValueError(f"the serve step over a mesh takes a decode "
                             f"shape, not {shape.kind!r}")
        from repro_torch.models.model import LM
        default = make_ctx(cfg, mesh, shape)
        dp, _ = SH.dp_axes_for_batch(mesh, shape.global_batch)
        specs = {"params": step_specs(cfg, shape, mesh)["params"],
                 "cache": LM(cfg, device="meta").cache_specs(
                     shape.global_batch, shape.seq_len, mesh),
                 "logits": (SH.canonical(dp), "model")}

    def serve(model, cache, tokens, pos, ctx: ShardingCtx = default):
        kw = {}
        if cfg.mrope:
            kw["positions_3d"] = torch.full((3, tokens.shape[0], 1), int(pos),
                                            dtype=torch.int64,
                                            device=model.device)
        with torch.no_grad():
            return model.decode_step(cache, tokens, int(pos), ctx=ctx, **kw)

    return serve, specs
