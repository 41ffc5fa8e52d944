"""Sharding policy: parameter specs, activation rules, batch and cache specs.

The counterpart of the reference's ``repro.launch.sharding``, for the
dry run (``launch.dryrun``): the port executes on one card, so nothing
here places a tensor.  A *spec* is a tuple with one entry per dim: a mesh
axis name, a tuple of names, or ``None`` (not split).  A mesh is anything
with ``axis_names`` and a ``shape`` mapping (``launch.mesh.AbstractMesh``).

Scheme (the reference's):
  * weights: Megatron tensor parallelism over ``"model"`` (column-parallel
    into a layer, row-parallel out of it) and FSDP over ``"data"`` on the
    other dim; replicated across ``"pod"`` (hybrid ZeRO: cross-pod traffic
    is gradients only).
  * activations: batch over ``("pod", "data")``; attention heads over
    ``"model"`` when the head count divides it, else the query sequence
    (context parallel); FFN hidden and vocab logits over ``"model"``; the
    residual stream sequence-parallel over ``"model"`` between layers.
  * decode caches: batch over the data axes that divide it, the sequence
    over ``"model"`` and the leftover data axes.

The rules key on the port's parameter names (``LM.named_parameters``, dots
read as slashes).  The port's layers are not stacked, so a spec has no
leading group dim; its ``w_gate_up`` (the reference's ``w_gate`` and
``w_up`` side by side on the last dim) takes their spec, and its router
is a bare ``[d, E]`` tensor.  For every leaf this gives the reference's
spec less the group dim.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Tuple, Union

from repro_torch.configs.base import ModelConfig, ShapeConfig

#: One dim's entry of a spec.
Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]

#: The axes batch (data parallelism) may take, in order.
DATA_AXES = ("pod", "data")

_COL = ("wqkv", "wq", "wk", "wv", "wi_fused", "wi_gate", "wi_up", "wi",
        "in_proj", "wx", "wy", "dt_proj", "lm_head", "mm_proj")
_ROW = ("wo", "out", "out_proj", "x_proj")

_PARAM_RULES = [
    (re.compile(r"embed/table$"), lambda d: ("model", None)),
    (re.compile(r"(%s)/kernel$" % "|".join(_COL)), lambda d: (d, "model")),
    (re.compile(r"(%s)/kernel$" % "|".join(_ROW)), lambda d: ("model", d)),
    (re.compile(r"(%s)/bias$" % "|".join(_COL)), lambda d: ("model",)),
    (re.compile(r"(%s)/bias$" % "|".join(_ROW)), lambda d: ()),
    (re.compile(r"moe/router$"), lambda d: ()),
    (re.compile(r"conv_w$"), lambda d: (None, "model")),
    (re.compile(r"conv_b$"), lambda d: ("model",)),
    (re.compile(r"A_log$"), lambda d: ("model", None)),
    (re.compile(r"(D|lam)$"), lambda d: ("model",)),
    (re.compile(r"w_[ri]$"), lambda d: ("model", None, None)),
    (re.compile(r"w_gate_up$"), lambda d: ("model", d, None)),
    (re.compile(r"w_down$"), lambda d: ("model", None, d)),
]


def axes_of(entry: Axes) -> Tuple[str, ...]:
    """The mesh axes one spec entry names."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec splits some dim over, in order."""
    return tuple(a for entry in spec for a in axes_of(entry))


def axes_size(mesh, axes) -> int:
    """Product of the mesh sizes of ``axes``."""
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def validate_spec(spec: Spec, shape, mesh) -> Spec:
    """Drop the split of any dim the mesh axes do not evenly divide.

    Keeps the policy total (whisper's odd 51865 vocab falls back to a
    replicated vocab dim).  Dims past the spec are ``None``."""
    out: List[Axes] = []
    for i, axes in enumerate(tuple(spec)):
        if axes is None or i >= len(shape):
            out.append(None if i >= len(shape) else axes)
            continue
        out.append(axes if shape[i] % axes_size(mesh, axes_of(axes)) == 0
                   else None)
    while len(out) < len(shape):
        out.append(None)
    return tuple(out)


def param_spec(name: str, shape, mesh) -> Spec:
    """The spec of one parameter, by its port name."""
    path = name.replace(".", "/")
    for rx, rule in _PARAM_RULES:
        if rx.search(path):
            spec = rule("data")
            spec = spec + (None,) * (len(shape) - len(spec))
            return validate_spec(spec, shape, mesh)
    return (None,) * len(shape)


def param_pspecs(cfg: ModelConfig, params: Mapping, mesh) -> Dict[str, Spec]:
    """``{name: spec}`` for a mapping of parameter names to tensors (or
    anything with ``shape``), as ``dict(model.named_parameters())``."""
    del cfg
    return {name: param_spec(name, tuple(p.shape), mesh)
            for name, p in params.items()}


# ---------------------------------------------------------------------------
# Batch / activation rules.
# ---------------------------------------------------------------------------

def dp_axes_for_batch(mesh, batch: int) -> Tuple[Tuple[str, ...],
                                                 Tuple[str, ...]]:
    """Greedy: batch takes the ``("pod", "data")`` axes whose product
    divides it; the leftover axes are free for sequence sharding."""
    taken, leftover = [], []
    prod = 1
    for ax in DATA_AXES:
        if ax not in mesh.axis_names:
            continue
        size = mesh.shape[ax]
        if batch % (prod * size) == 0:
            taken.append(ax)
            prod *= size
        else:
            leftover.append(ax)
    return tuple(taken), tuple(leftover)


def canonical(axes: Tuple[str, ...]) -> Axes:
    """A spec entry for ``axes``: ``None`` for none, the name for one
    (as ``jax.sharding.PartitionSpec`` writes a one-axis tuple), else the
    tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)



def activation_rules(cfg: ModelConfig, mesh, shape: ShapeConfig
                     ) -> Dict[str, Spec]:
    """Rules for :class:`~repro_torch.models.sharding_ctx.ShardingCtx`,
    keyed by semantic activation kind."""
    tp = mesh.shape["model"]
    if shape.kind == "decode":
        dp, rest = dp_axes_for_batch(mesh, shape.global_batch)
        seq_axes = canonical(tuple(rest) + ("model",))
        return {
            "tokens_bse": (canonical(dp), None, None),
            "kv_cache": (canonical(dp), seq_axes, None, None),
        }
    dp = canonical(dp_axes_for_batch(mesh, shape.global_batch)[0])
    heads_ok = cfg.num_heads and cfg.num_heads % tp == 0
    kv_ok = cfg.num_kv_heads and cfg.num_kv_heads % tp == 0
    rules = {
        # Megatron sequence parallelism: the residual stream between
        # layers is sequence-split over "model" (all-gathered at a
        # layer's entry, reduce-scattered at its exit).
        "tokens_bse": (dp, "model", None),
        "ffn_bsf": (dp, None, "model"),
        "logits_bsv": (dp, None, "model"),
        "ssm_bsdn": (dp, None, "model"),
        "moe_gecd": (dp, "model", None, None),
    }
    if heads_ok:
        rules["heads_bshd"] = (dp, None, "model", None)
    else:
        # context-parallel fallback: split the query sequence instead
        rules["heads_bshd"] = (dp, "model", None, None)
    if kv_ok:
        rules["kv_bskd"] = (dp, None, "model", None)
    return rules


def batch_pspecs(cfg: ModelConfig, mesh, shape: ShapeConfig
                 ) -> Dict[str, Spec]:
    """Specs of one batch's tensors (tokens, labels, modalities)."""
    dp = canonical(dp_axes_for_batch(mesh, shape.global_batch)[0])
    specs = {"tokens": (dp, None)}
    if shape.kind == "train":
        specs["labels"] = (dp, None)
    if cfg.family == "encdec":
        specs["frames"] = (dp, None, None)
    if cfg.family == "vlm":
        specs["mm_embeds"] = (dp, None, None)
        specs["positions_3d"] = (None, dp, None)
    return specs


def cache_pspecs(cfg: ModelConfig, mesh, shape: ShapeConfig,
                 cache: List[Mapping]) -> List[Dict[str, Spec]]:
    """Specs of the port's decode cache (``LM.init_cache``: one dict per
    layer).

    KV leaves ``[B, S, H, D]`` (a global layer's cache, a local layer's
    ring, whisper's cross K/V): batch over the dividing data axes, the
    sequence over the rest and ``"model"``.  A recurrent layer's ``conv``
    ``[B, K - 1, C]`` and ``h`` (``[B, d_in, N]`` or ``[B, rw]``): batch
    over the data axes, the channels over ``"model"``.
    """
    del cfg
    dp, rest = dp_axes_for_batch(mesh, shape.global_batch)
    dp = canonical(dp)
    seq_axes = canonical(tuple(rest) + ("model",))

    def spec_for(name: str, leaf) -> Spec:
        if name in ("k", "v", "cross_k", "cross_v"):
            return (dp, seq_axes, None, None)
        if name == "conv":
            return (dp, None, "model")
        if name == "h":
            return (dp, "model", None) if leaf.dim() == 3 \
                else (dp, "model")
        return (None,) * leaf.dim()

    return [{name: validate_spec(spec_for(name, leaf), tuple(leaf.shape),
                                 mesh)
             for name, leaf in layer.items()} for layer in cache]


def opt_state_pspecs(param_specs: Dict[str, Spec]) -> Dict:
    """AdamW state: ``mu`` / ``nu`` take the parameter's spec; ``count``
    is replicated."""
    return {"mu": dict(param_specs), "nu": dict(param_specs), "count": ()}


def data_axes_of(spec: Spec) -> Tuple[str, ...]:
    """The data-parallel axes (FSDP) a parameter spec splits over."""
    return tuple(a for a in spec_axes(spec) if a in DATA_AXES)


def model_axes_of(spec: Spec) -> Tuple[str, ...]:
    """The axes a parameter stays split over once its FSDP shards are
    gathered for use: every axis but the data axes."""
    return tuple(a for a in spec_axes(spec) if a not in DATA_AXES)
