"""Sharding policy: parameter specs, activation rules, batch and cache specs.

The counterpart of the reference's ``repro.launch.sharding``, for the
dry run (``launch.dryrun``) and for the partitioned steps on a
``launch.mesh.ProcessMesh``: :func:`block_slices` / :func:`local_block`
cut a rank's block of a whole leaf as ``jax.sharding.NamedSharding`` cuts
it, :func:`batch_shard` keeps a rank's rows of a global batch, and
:func:`cache_blocks` / :func:`slot_owner` give a rank its blocks of a
decode cache and say which block holds a slot.  A
*spec* is a tuple with one entry per dim: a mesh axis name, a tuple of
names, or ``None`` (not split).  A mesh is anything with ``axis_names``
and a ``shape`` mapping (``launch.mesh.AbstractMesh``); cutting a block
also reads a process mesh's ``coords``.

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

import numpy as np

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


def axes_index(mesh, axes) -> int:
    """This rank's position along ``axes`` taken together, the major axis
    first (the block :func:`block_slices` gives it on a dim split over
    them)."""
    index = 0
    for a in axes:
        index = index * mesh.shape[a] + mesh.coords[a]
    return index


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


def seq_axes_for_batch(mesh, batch: int) -> Tuple[str, ...]:
    """The axes a decode cache's sequence is split over at ``batch`` rows:
    the data axes the batch leaves free, then ``"model"``."""
    return tuple(dp_axes_for_batch(mesh, batch)[1]) + ("model",)


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
        dp = canonical(dp_axes_for_batch(mesh, shape.global_batch)[0])
        seq_axes = canonical(seq_axes_for_batch(mesh, shape.global_batch))
        return {
            "tokens_bse": (dp, None, None),
            "kv_cache": (dp, seq_axes, None, None),
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
    dp = canonical(dp_axes_for_batch(mesh, shape.global_batch)[0])
    seq_axes = canonical(seq_axes_for_batch(mesh, shape.global_batch))

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


def cache_blocks(cache: List[Mapping], specs: List[Mapping], mesh
                 ) -> List[Dict]:
    """This rank's block of each leaf of a whole per-layer decode cache
    (``LM.init_cache``'s layout; ``specs`` as :func:`cache_pspecs` gives
    them): :func:`local_block` of every leaf, copied."""
    return [{name: local_block(leaf, spec[name], mesh).clone()
             for name, leaf in layer.items()}
            for layer, spec in zip(cache, specs)]


def slot_owner(slot: int, s_c: int, seq_axes, mesh) -> Tuple[int, int]:
    """Where global slot ``slot`` of a ``s_c``-slot cache lies when its
    sequence is cut into equal blocks over ``seq_axes`` (the major axis
    first, as :func:`block_slices` cuts it): ``(block, index)``, the
    block's position along the axes and the slot's index inside it.
    ``seq_axes`` is a spec entry (a name, a tuple of names or None: one
    block)."""
    parts = axes_size(mesh, axes_of(seq_axes))
    if s_c % parts:
        raise ValueError(f"a {s_c}-slot cache does not split into {parts} "
                         f"blocks over {seq_axes}")
    if not 0 <= slot < s_c:
        raise ValueError(f"slot {slot} is outside a {s_c}-slot cache")
    step = s_c // parts
    return slot // step, slot % step


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


# ---------------------------------------------------------------------------
# A rank's blocks.
# ---------------------------------------------------------------------------

def block_slices(spec: Spec, shape: Tuple[int, ...], mesh
                 ) -> Tuple[slice, ...]:
    """This rank's block of a leaf of ``shape`` split by ``spec`` on
    ``mesh``: a dim whose entry names axes ``(a, b, ...)`` is cut into
    ``size(a) * size(b) * ...`` equal blocks, ``a`` the major one, as
    ``jax.sharding.NamedSharding`` cuts it; the rank takes the block of its
    coordinates (``mesh.coords``).  Dims past the spec are whole.

    Raises:
        ValueError: a spec longer than the leaf, or a dim its axes do not
            evenly divide.
    """
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the leaf's "
                         f"{len(shape)} dims")
    out = []
    for dim, size in enumerate(shape):
        axes = axes_of(spec[dim]) if dim < len(spec) else ()
        parts, index = axes_size(mesh, axes), axes_index(mesh, axes)
        if size % parts:
            raise ValueError(f"dim {dim} of {shape} does not split into "
                             f"{parts} blocks over {axes}")
        step = size // parts
        out.append(slice(index * step, (index + 1) * step))
    return tuple(out)


def local_shape(spec: Spec, shape: Tuple[int, ...], mesh
                ) -> Tuple[int, ...]:
    """The shape of a rank's block of a leaf of ``shape`` (every rank's
    is the same)."""
    return tuple(s.stop - s.start for s in block_slices(spec, shape, mesh))


def local_block(x, spec: Spec, mesh):
    """This rank's block of the whole leaf ``x`` (a tensor or an array):
    a view of it, :func:`block_slices` ``(spec, x.shape, mesh)``."""
    return x[block_slices(spec, tuple(x.shape), mesh)]


def assemble(x, spec: Spec, mesh):
    """The whole leaf of which ``x`` is this rank's block (the inverse of
    :func:`local_block`): gathered over each axis its spec splits it on,
    the minor axis of a dim first, with ``core.comm.all_gather`` (every
    rank of the mesh must call it, in the same order, with its own
    block).  Gradients do not flow through it."""
    import torch
    from repro_torch.core import comm
    with torch.no_grad():
        for dim, entry in enumerate(spec):
            for a in reversed(axes_of(entry)):
                if mesh.shape[a] > 1:
                    x = comm.all_gather(x, a, dim=dim, tiled=True,
                                        mesh=mesh)
    return x


def batch_rows(global_batch: int, dp_size: int, dp_index: int,
               grad_accum: int = 1) -> np.ndarray:
    """The global rows data shard ``dp_index`` of ``dp_size`` keeps, in the
    order of its micro-batches: micro-batch ``i`` of ``grad_accum`` is
    global rows ``[i * B / a, (i + 1) * B / a)``, of which the shard keeps
    block ``dp_index`` of ``dp_size``, i.e. rows ``i * B / a + dp_index *
    B / (a * dp)`` and the next ``B / (a * dp) - 1``.  So the shard's
    micro-batch ``i`` is its rows ``[i * B / (a * dp), (i + 1) * B / (a *
    dp))``, as the reference's step splits each micro-batch over the data
    axes (not the ``i``-th slice of contiguous rows: the MoE's capacity is
    local, and the other split would drop other tokens).

    Raises:
        ValueError: ``grad_accum * dp_size`` does not divide the batch.
    """
    a = grad_accum
    if global_batch % (a * dp_size):
        raise ValueError(f"a batch of {global_batch} rows does not split "
                         f"into {a} micro-batches over {dp_size} data "
                         f"shards")
    per = global_batch // (a * dp_size)
    return np.concatenate([
        np.arange(per) + i * (global_batch // a) + dp_index * per
        for i in range(a)])


def batch_shard(batch: Mapping, cfg: ModelConfig, mesh, shape: ShapeConfig,
                grad_accum: int = 1) -> Dict:
    """This rank's part of a global batch (numpy arrays or tensors, as
    :func:`batch_pspecs` names them): along each entry's batch dim, the
    rows of :func:`batch_rows` for the rank's index on the batch's data
    axes (``dp_axes_for_batch``); whole on the axes that do not split it.
    """
    dp, _ = dp_axes_for_batch(mesh, shape.global_batch)
    rows = batch_rows(shape.global_batch, axes_size(mesh, dp),
                      axes_index(mesh, dp), grad_accum)
    specs = batch_pspecs(cfg, mesh, shape)
    out = {}
    for key, value in batch.items():
        spec = specs.get(key, (canonical(dp),))
        dim = next((i for i, e in enumerate(spec) if e is not None), None)
        if dim is None:
            out[key] = value
            continue
        if not isinstance(value, np.ndarray):
            import torch
            index = torch.as_tensor(rows, device=value.device)
        else:
            index = rows
        out[key] = value[(slice(None),) * dim + (index,)]
    return out


def replicated_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """The mesh axes (of size > 1) a leaf split by ``spec`` is replicated
    over: its gradient is the sum of the ranks' along them."""
    named = set(spec_axes(spec))
    return tuple(a for a in mesh.axis_names
                 if a not in named and mesh.shape[a] > 1)

