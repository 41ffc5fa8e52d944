"""``decode_step`` against ``forward``: the reference's own invariant
(stepping the cache token by token reproduces the forward's logits,
``tests/test_models.py``'s ``test_decode_matches_forward``) as a bounded
comparison of two runs of one model.

The two runs round differently: ``forward`` rounds each attention tile's
probabilities to the compute dtype (:func:`models.model.unshared_roundings`)
and its projections sum ``[B, S, d]`` rows where decode sums one row at a
time.  So the logits are held within :func:`models.model.rounding_tolerance`
of the model's roundings plus the unshared ones.  With random weights the
attention is a small part of the residual stream, and a fault inside it
(a ring slot written one off, a window ignored, M-RoPE streams swapped)
moves the logits by less than that bound; so every layer's attention
output (the input of ``wo``, self- and cross-attention) is held as well,
relative to its own rows, within the same two counts taken through that
layer only (``roundings(cfg, i + 1)``).  :func:`compare` reports the worst
ratio of |difference| to bound of each; a ratio above 1 fails.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from repro_torch.models import model as M


@contextlib.contextmanager
def _attention_outputs(lm: "M.LM"):
    """Record the input of every attention's ``wo`` while the block runs:
    ``{"<layer>.attn" or "<layer>.cross": [tensors in call order]}``."""
    seen: Dict[str, list] = {}
    hooks = []
    for i, block in enumerate(lm.layers):
        for kind in ("attn", "cross"):
            mod = getattr(block, kind, None)
            if mod is None:
                continue
            name = f"{i}.{kind}"
            seen[name] = []
            hooks.append(mod.wo.register_forward_pre_hook(
                lambda _m, args, name=name: seen[name].append(
                    args[0].detach())))
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def forward_trace(lm: "M.LM", tokens: torch.Tensor, **kw) -> dict:
    """``forward`` on ``tokens [B, S]`` (``kw``: ``frames``, ``mm_embeds``,
    ``positions_3d``): its logits and every attention output ``[B, S,
    H * D]``."""
    with torch.inference_mode(), _attention_outputs(lm) as seen:
        logits = lm(tokens, **kw)
    return {"logits": logits,
            "attn": {k: v[0] for k, v in seen.items()}}


def decode_trace(lm: "M.LM", tokens: torch.Tensor, steps: int, *,
                 cache_len: Optional[int] = None,
                 enc_out: Optional[torch.Tensor] = None,
                 positions_3d: Optional[torch.Tensor] = None) -> dict:
    """``steps`` teacher-forced ``decode_step`` calls on ``tokens[:, t]``
    against a fresh cache of ``cache_len`` (default ``steps``) slots,
    primed with ``enc_out`` where one is given.  qwen2-vl's M-RoPE
    positions at step ``t`` are column ``t`` of ``positions_3d [3, B, S]``
    (the forward's) where given, else ``t`` in all three streams, as the
    reference's serve step builds them.  Returns the logits ``[B, steps,
    V]`` and every attention output ``[B, steps, H * D]``."""
    b = tokens.shape[0]
    cache = lm.init_cache(b, cache_len or steps)
    with torch.inference_mode(), _attention_outputs(lm) as seen:
        if enc_out is not None:
            lm.prime_cross_cache(cache, enc_out)
        logits = []
        for t in range(steps):
            if positions_3d is not None:
                p3 = positions_3d[:, :, t:t + 1]
            elif lm.cfg.mrope:
                p3 = torch.full((3, b, 1), t, device=lm.device)
            else:
                p3 = None
            logits.append(lm.decode_step(cache, tokens[:, t], t,
                                         positions_3d=p3))
    return {"logits": torch.stack(logits, dim=1),
            "attn": {k: torch.cat(v, dim=1) for k, v in seen.items()}}


def _stages(cfg, layers: int) -> int:
    """Roundings before a value of decoder layer ``layers - 1`` (all
    layers: the logits), each run's and those the two do not share."""
    return M.roundings(cfg, layers) + M.unshared_roundings(cfg, layers)


def _ratio(got: torch.Tensor, ref: torch.Tensor, stages: int,
           dtype: torch.dtype) -> float:
    """Worst ``|got - ref|`` over :func:`models.model.rounding_tolerance`
    of ``stages`` roundings relative to each row's rms."""
    g, r = got.double(), ref.double()
    rms = r.pow(2).mean(dim=-1, keepdim=True).sqrt()
    bound = M.rounding_tolerance(stages, rms, r.numel(), dtype)
    return float(((g - r).abs() / bound).max())


def compare(lm: "M.LM", fwd: dict, dec: dict) -> dict:
    """Hold a :func:`decode_trace` against the first positions of a
    :func:`forward_trace` of the same tokens.

    Returns:
        ``logits``: the worst ratio of |difference| to the logit bound;
        ``attn``: the worst over every attention output, with ``layer``
        naming it; ``max_dlogit``; ``ok`` when both ratios are at most 1.
    """
    cfg, steps = lm.cfg, dec["logits"].shape[1]
    if not (bool(torch.isfinite(fwd["logits"]).all())
            and bool(torch.isfinite(dec["logits"]).all())):
        return {"logits": float("inf"), "attn": float("inf"),
                "layer": None, "max_dlogit": float("inf"), "ok": False}
    ref = fwd["logits"][:, :steps, :cfg.vocab_size]
    got = dec["logits"][..., :cfg.vocab_size]
    logits = _ratio(got, ref, _stages(cfg, cfg.num_layers), lm.dtype)
    attn = {name: _ratio(out, fwd["attn"][name][:, :steps],
                         _stages(cfg, int(name.split(".")[0]) + 1), lm.dtype)
            for name, out in dec["attn"].items()}
    layer = max(attn, key=attn.get)
    return {"logits": logits, "attn": attn[layer], "layer": layer,
            "max_dlogit": float((got - ref).abs().max()),
            "ok": logits <= 1 and attn[layer] <= 1}
