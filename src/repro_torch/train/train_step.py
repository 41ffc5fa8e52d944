"""The train step: forward (per-layer checkpointed), softmax cross-entropy
over the padded vocab, backward, AdamW (the reference's
``repro.train.train_step.make_train_step`` without a mesh).

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
from repro_torch.core.device import MULTI_CARD
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
                  vocab: Optional[int]) -> torch.Tensor:
    """``logsumexp - gold`` per token, fp32, the columns ``>= vocab``
    masked."""
    logits = logits.float()
    if vocab is not None and vocab < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab
        logits = torch.where(pad, PAD_LOGIT, logits)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.logsumexp(logits, dim=-1) - gold


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token loss; the padded vocab columns (``>= vocab``) get
    :data:`PAD_LOGIT`."""
    return _token_losses(logits, labels, vocab).mean()


def chunked_xent(model, hidden: torch.Tensor, labels: torch.Tensor,
                 chunk: int = 512) -> torch.Tensor:
    """Cross-entropy without materialising ``[B, S, V]`` fp32 logits: the
    sequence goes in chunks (the largest divisor of S up to ``chunk``),
    each chunk's unembed product and logsumexp checkpointed, so the peak
    logits memory is ``B * chunk * V``."""
    B, S, _ = hidden.shape
    ch = min(chunk, S)
    while S % ch:
        ch -= 1
    table = model.unembed_table()
    vocab = model.cfg.vocab_size

    def chunk_loss(h_c, lab_c, table):
        logits = (h_c @ table.to(h_c.dtype).T).float()
        return _token_losses(logits, lab_c, vocab).sum()

    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(S // ch):
        part = slice(i * ch, (i + 1) * ch)
        total = total + checkpoint(chunk_loss, hidden[:, part],
                                   labels[:, part], table,
                                   use_reentrant=False)
    return total / (B * S)


def make_grads(cfg: ModelConfig, *, remat: bool = True,
               grad_accum: int = 1, chunked_loss: bool = False):
    """``grads_fn(model, batch) -> (loss, {name: grad})``: the mean loss
    (0-d fp32, detached) and the gradient of every parameter of ``model``
    by name.  With ``grad_accum`` > 1 the batch splits into that many
    micro-batches along its first axis; their fp32 gradients and losses
    are summed and scaled by ``1 / grad_accum``."""

    def loss_fn(model, batch):
        extras = {k: batch[k] for k in MODALITY_KEYS if k in batch}
        if chunked_loss:
            hidden = model(batch["tokens"], remat=remat,
                           return_pre_logits=True, **extras)
            return chunked_xent(model, hidden, batch["labels"])
        logits = model(batch["tokens"], remat=remat, **extras)
        return softmax_xent(logits, batch["labels"], cfg.vocab_size)

    def grads_fn(model, batch):
        params = dict(model.named_parameters())
        names = list(params)
        leaves = [params[n] for n in names]
        if grad_accum == 1:
            loss = loss_fn(model, batch)
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach(), dict(zip(names, grads))
        micro = {k: v.reshape((grad_accum, v.shape[0] // grad_accum)
                              + tuple(v.shape[1:])) for k, v in batch.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=model.device)
        acc = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for n, p in params.items()}
        for i in range(grad_accum):
            loss = loss_fn(model, {k: v[i] for k, v in micro.items()})
            for n, g in zip(names, torch.autograd.grad(loss, leaves)):
                acc[n].add_(g.float())
            loss_acc = loss_acc + loss.detach()
        inv = 1.0 / grad_accum
        return loss_acc * inv, {n: g * inv for n, g in acc.items()}

    return grads_fn


def make_train_step(cfg: ModelConfig, shape: ShapeConfig, mesh=None, *,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    remat: bool = True, grad_accum: int = 1,
                    chunked_loss: bool = False,
                    schedule_kwargs: Optional[Dict] = None) -> StepFn:
    """``step_fn(model, opt_state, batch, step) -> metrics``.

    ``model`` is an ``LM`` with fp32 masters (``masters=True``), updated in
    place with ``opt_state``; ``batch`` holds ``tokens`` and ``labels``
    ``[B, S]`` on the model's device; ``step`` is the step number (int or
    tensor) the learning-rate schedule reads.  The metrics are ``loss``,
    ``lr_scale`` and ``grad_norm``; ``loss`` and ``grad_norm`` stay 0-d
    tensors on the device (reading one waits for the step).

    Raises:
        NotImplementedError: for a ``mesh``.
    """
    if mesh is not None:
        raise NotImplementedError(f"make_train_step over a mesh comes with "
                                  f"{MULTI_CARD}")
    sched = functools.partial(cosine_with_warmup, **(schedule_kwargs or {}))
    grads_fn = make_grads(cfg, remat=remat, grad_accum=grad_accum,
                          chunked_loss=chunked_loss)

    def step_fn(model, opt_state, batch, step):
        loss, grads = grads_fn(model, batch)
        lr_scale = sched(step)
        om = adamw.apply_updates(dict(model.named_parameters()), grads,
                                 opt_state, opt_cfg, lr_scale)
        return {"loss": loss, "lr_scale": lr_scale, **om}

    return step_fn
