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
layer only (``roundings(cfg, i + 1)``).

A recurrent layer (mamba, RG-LRU) is held on its own: its mixer output
(the input of a mamba block's ``out_proj``, of an RG-LRU block's ``out``)
in decode against the layer's forward run on the same inputs, the ones
decode gave it, within the layer's own roundings
(``models.model.ROUNDINGS_BY_KIND``), each element relative to its own
magnitude, at least its row's rms.  A rounding perturbs a value
relative to that value, and a mamba mixer row is heavy-tailed (its
largest |value| is 33 and 61 times its rms at d 1024 and 4096, CPU): a
bound at the rms fails on rounding alone (one ulp flipped in 5 % of the
scan's output moved single elements by 0.37 of the rms at d 4096).  And
across layers a random-weight recurrent stack amplifies rounding, so
the cascade is held by the logits only: a dropped chunk carry, a wrong
conv cache or a missing decay moves the layer's own comparison.
:func:`compare` reports the worst ratio of |difference| to bound of
each; a ratio above 1 fails.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch

from repro_torch.models import model as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S


#: Attention outputs: (block attribute, the projection whose input is
#: recorded).
ATTENTION = (("attn", "wo"), ("cross", "wo"))
#: Recurrent mixers: block attribute -> (the norm whose output is the
#: mixer's input, the projection whose input is recorded, the layer kind).
MIXERS = {"mamba": ("ln", "out_proj", "ssm"), "rglru": ("ln1", "out", "rglru")}


def _mixer_forward(kind: str, mod, x: torch.Tensor) -> torch.Tensor:
    if kind == "mamba":
        return S.mamba_forward(mod, x)
    return R.rglru_forward(mod, x)


@contextlib.contextmanager
def _layer_outputs(lm: "M.LM", mixers: bool):
    """Record, while the model runs, the input of every attention's
    ``wo`` (``"<layer>.attn"``, ``"<layer>.cross"``) and, with
    ``mixers``, every recurrent mixer's output (``"<layer>.mamba"``,
    ``"<layer>.rglru"``: the input of its output projection) and input
    (``"<layer>.<mixer>.in"``: its norm's output), as ``{name: [tensors
    in call order]}``."""
    seen: Dict[str, list] = {}
    hooks = []

    def record(name, mod, output=False):
        seen[name] = []
        if output:
            hooks.append(mod.register_forward_hook(
                lambda _m, _a, out, name=name: seen[name].append(
                    out.detach())))
        else:
            hooks.append(mod.register_forward_pre_hook(
                lambda _m, args, name=name: seen[name].append(
                    args[0].detach())))
    for i, block in enumerate(lm.layers):
        for kind, proj in ATTENTION:
            mod = getattr(block, kind, None)
            if mod is not None:
                record(f"{i}.{kind}", getattr(mod, proj))
        for kind, (norm, proj, _) in MIXERS.items():
            mod = getattr(block, kind, None)
            if mod is not None and mixers:
                record(f"{i}.{kind}", getattr(mod, proj))
                record(f"{i}.{kind}.in", getattr(block, norm), output=True)
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def forward_trace(lm: "M.LM", tokens: torch.Tensor, **kw) -> dict:
    """``forward`` on ``tokens [B, S]`` (``kw``: ``frames``, ``mm_embeds``,
    ``positions_3d``): its logits and every attention output ``[B, S, H
    * D]``."""
    with torch.inference_mode(), _layer_outputs(lm, mixers=False) as seen:
        logits = lm(tokens, **kw)
    return {"logits": logits,
            "outputs": {k: v[0] for k, v in seen.items()}}


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
    V]``, every attention output ``[B, steps, H * D]`` and every recurrent
    mixer's output and input ``[B, steps, .]`` (:func:`_layer_outputs`)."""
    b = tokens.shape[0]
    cache = lm.init_cache(b, cache_len or steps)
    with torch.inference_mode(), _layer_outputs(lm, mixers=True) as seen:
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
            "outputs": {k: torch.cat(v, dim=1) for k, v in seen.items()}}


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


def _layer_forward(lm: "M.LM", name: str,
                   inputs: torch.Tensor) -> torch.Tensor:
    """Recurrent mixer ``name``'s forward on ``inputs [B, S, d]``: its
    output (the input of its output projection)."""
    i, kind = name.split(".")
    mod = getattr(lm.layers[int(i)], kind)
    seen = []
    hook = getattr(mod, MIXERS[kind][1]).register_forward_pre_hook(
        lambda _m, args: seen.append(args[0].detach()))
    try:
        with torch.inference_mode():
            _mixer_forward(kind, mod, inputs)
    finally:
        hook.remove()
    return seen[0]


def _elementwise_ratio(got: torch.Tensor, ref: torch.Tensor, stages: int,
                       dtype: torch.dtype) -> float:
    """Worst ``|got - ref|`` over :func:`models.model.rounding_tolerance`
    of ``stages`` roundings relative to each element's |value|, at least
    its row's rms."""
    g, r = got.double(), ref.double()
    rms = r.pow(2).mean(dim=-1, keepdim=True).sqrt()
    bound = M.rounding_tolerance(stages, torch.maximum(r.abs(), rms),
                                 r.numel(), dtype)
    return float(((g - r).abs() / bound).max())


def compare(lm: "M.LM", fwd: dict, dec: dict) -> dict:
    """Hold a :func:`decode_trace` against the first positions of a
    :func:`forward_trace` of the same tokens, and each recurrent mixer's
    decode against its forward on the inputs decode gave it (run here, so
    a fault planted in the forward must be in place while this runs).

    Returns:
        ``logits``: the worst ratio of |difference| to the logit bound;
        ``attn``: the worst over every attention output, with ``layer``
        naming it; ``mixer``: the worst over every recurrent mixer output
        (mamba, RG-LRU), with ``mixer_layer`` naming it (0.0 and None
        where the model has no such layer); ``max_dlogit``; ``ok`` when
        every ratio is at most 1.
    """
    cfg, steps = lm.cfg, dec["logits"].shape[1]
    if not (bool(torch.isfinite(fwd["logits"]).all())
            and bool(torch.isfinite(dec["logits"]).all())):
        return {"logits": float("inf"), "attn": float("inf"),
                "layer": None, "mixer": float("inf"), "mixer_layer": None,
                "max_dlogit": float("inf"), "ok": False}
    ref = fwd["logits"][:, :steps, :cfg.vocab_size]
    got = dec["logits"][..., :cfg.vocab_size]
    logits = _ratio(got, ref, _stages(cfg, cfg.num_layers), lm.dtype)
    ratios = {}
    for name, out in dec["outputs"].items():
        i, kind = name.split(".")[:2]
        if name.endswith(".in"):
            continue
        if kind in MIXERS:
            ratios[name] = _elementwise_ratio(
                out, _layer_forward(lm, name, dec["outputs"][name + ".in"]),
                M.ROUNDINGS_BY_KIND[MIXERS[kind][2]], lm.dtype)
        else:
            ratios[name] = _ratio(out, fwd["outputs"][name][:, :steps],
                                  _stages(cfg, int(i) + 1), lm.dtype)
    out = {"logits": logits,
           "max_dlogit": float((got - ref).abs().max())}
    for key, layer_key, kinds in (
            ("attn", "layer", [k for k, _ in ATTENTION]),
            ("mixer", "mixer_layer", list(MIXERS))):
        of_kind = {k: v for k, v in ratios.items()
                   if k.split(".")[1] in kinds}
        worst = max(of_kind, key=of_kind.get, default=None)
        out[key] = of_kind[worst] if worst else 0.0
        out[layer_key] = worst
    out["ok"] = logits <= 1 and out["attn"] <= 1 and out["mixer"] <= 1
    return out
