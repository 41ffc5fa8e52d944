"""Per-device collective traffic of one step, derived from the sharding
policy.

The counterpart of the reference's ``repro.core.hlo_analysis``
``parse_collective_bytes`` / ``count_collectives``, which read the
collectives that XLA's SPMD partitioner put into a compiled step.  The port
has no partitioner: this module derives, from the parameter specs
(``launch.sharding``), the step's kind and the shapes its ``ctx.constrain``
points saw (``core.step_cost.StepCount.constraints``), the collectives
that the policy implies, as ring volumes: a ring all-gather or
reduce-scatter of an ``S``-byte buffer over ``n`` devices moves ``(n - 1)
/ n * S`` bytes per device, an all-reduce twice that.

What is counted, per micro-batch of a train step (forward, recompute and
backward) or per prefill or decode step:

* **FSDP**: every weight split over data axes is all-gathered over them
  in the compute dtype at each use (forward, recompute, backward);
* **gradients**: reduce-scattered (fp32) over the data axes that split
  their weight, all-reduced over the batch axes that do not (``"pod"``
  for every weight, ``"data"`` for the replicated ones);
* **sequence parallelism**: at each sublayer's entry the residual stream
  is all-gathered over ``"model"`` and at its exit reduce-scattered
  (their roles swap in the backward pass); an MoE layer's exchange of its
  token buffer over ``"model"`` is its FFN sublayer's pair (the reference
  gathers the tokens into its ``shard_map`` and ``psum_scatter``s the
  combined output); in decode, each sublayer's row-parallel output is
  all-reduced over ``"model"`` instead;
* **the vocab-sharded embedding and loss**: the table lookup's partial
  rows reduce-scattered (all-reduced in decode), the head's input
  all-gathered, the loss's max, sum and gold logit all-reduced;
* **decode's sequence-sharded KV cache**: each attention layer's partial
  softmax (max, sum and output, fp32) all-reduced over the cache's
  sequence axes, after q is all-gathered over ``"model"``.

Not counted: the context-parallel fallback for head counts that
``"model"`` does not divide, the resharding of K/V heads it does not
divide, and the optimizer's scalar norm.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Mapping, Tuple

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import sharding as SH

KINDS = ("all-gather", "reduce-scatter", "all-reduce", "all-to-all")

#: Sublayers (one gathered entry, one scattered exit) per decoder layer.
SUBLAYERS = {"global": 2, "local": 2, "ssm": 1, "rglru": 2}


class CollectiveLog:
    """Collectives by kind: per-device bytes, launches and labelled rows."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.bytes: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, float] = defaultdict(float)
        self.rows: Dict[str, float] = defaultdict(float)

    def add(self, kind: str, axes, size: float, times: float,
            what: str) -> None:
        """``times`` launches of ``kind`` over ``axes`` on an ``size``-byte
        buffer (the gathered / reduced whole, per device group)."""
        n = SH.axes_size(self.mesh, axes)
        if n <= 1 or times <= 0 or size <= 0:
            return
        vol = (n - 1) / n * size * (2 if kind == "all-reduce" else 1)
        self.bytes[kind] += vol * times
        self.counts[kind] += times
        self.rows[f"{kind} over {'x'.join(axes)}: {what}"] += vol * times

    def summary(self) -> Tuple[Dict[str, float], Dict[str, float]]:
        """``(bytes by kind + "total", launches by kind)``."""
        out = {k: float(self.bytes.get(k, 0.0)) for k in KINDS}
        out["total"] = float(sum(out.values()))
        return out, {k: float(self.counts.get(k, 0.0)) for k in KINDS}

    def top_contributors(self, k: int = 12) -> List[Tuple[float, str]]:
        """The ``k`` largest collective rows, largest first."""
        rows = sorted(((v, key) for key, v in self.rows.items()),
                      key=lambda r: -r[0])
        return rows[:k]


def _residual(constraints: Mapping, kind: str):
    """The first constraint of ``kind`` seen: ``(shape, dtype, axes)``."""
    for (k, shape, dtype, axes) in constraints:
        if k == kind:
            return shape, dtype, axes
    return None


def _itemsize(dtype: str) -> int:
    return {"float32": 4, "bfloat16": 2, "float16": 2}.get(dtype, 4)


def _prod(dims) -> int:
    n = 1
    for d in dims:
        n *= d
    return n


def step_collectives(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                     params: Mapping[str, Tuple[tuple, int]],
                     specs: Mapping[str, SH.Spec],
                     constraints: Mapping, kinds: List[str],
                     compute_itemsize: int, grad_accum: int = 1,
                     remat: bool = True) -> CollectiveLog:
    """The collectives of one step of ``cfg`` at ``shape`` on ``mesh``.

    Args:
        params: ``{name: (shape, itemsize)}`` of every parameter.
        specs: the parameters' specs (``launch.sharding.param_pspecs``).
        constraints: the counted step's ``ctx.constrain`` points (for the
            loop-aware count, those of its one-group run).
        kinds: the decoder layers' kinds (``models.model.layer_kinds``).
        compute_itemsize: bytes of an element of the compute dtype.
        grad_accum: micro-batches of a train step.
        remat: whether a train step recomputes each layer's forward.
    """
    log = CollectiveLog(mesh)
    train = shape.kind == "train"
    decode = shape.kind == "decode"
    micro = grad_accum if train else 1
    uses = (3 if remat else 2) if train else 1
    dp, _ = SH.dp_axes_for_batch(mesh, shape.global_batch)
    tp_axes = ("model",)

    # FSDP gathers and gradient reductions.
    for name, (dims, _) in params.items():
        spec = specs[name]
        data = SH.data_axes_of(spec)
        model_split = SH.axes_size(mesh, SH.model_axes_of(spec))
        numel = _prod(dims) / model_split
        log.add("all-gather", data, numel * compute_itemsize,
                uses * micro, "FSDP weight gather")
        if not train:
            continue
        log.add("reduce-scatter", tuple(a for a in data if a in dp),
                numel * 4, micro, "gradient")
        rest = tuple(a for a in dp if a not in data)
        log.add("all-reduce", rest,
                numel * 4 / SH.axes_size(mesh, data), micro, "gradient")

    res = _residual(constraints, "tokens_bse")
    if res is None:
        return log
    dims, dtype, axes = res
    b, s, d = dims
    b_loc = b / SH.axes_size(mesh, [a for a in axes if a in SH.DATA_AXES])
    row = compute_itemsize * d
    sub = sum(SUBLAYERS[k] for k in kinds)
    if cfg.family == "encdec":
        sub += len(kinds)                      # cross-attention
    table_split = "model" in SH.spec_axes(specs.get("embed.table", ()))

    if decode:
        tok = b_loc * row
        log.add("all-reduce", tp_axes, tok, sub, "row-parallel output")
        if table_split:
            log.add("all-reduce", tp_axes, tok, 1, "vocab-split embedding")
        cache = _residual(constraints, "kv_cache")
        if cache is not None:
            seq = tuple(a for a in cache[2] if a not in dp)
            heads = cfg.num_heads * b_loc
            attn = sum(k in ("global", "local") for k in kinds)
            log.add("all-gather", tp_axes,
                    heads * cfg.head_dim * compute_itemsize, attn,
                    "decode q heads")
            log.add("all-reduce", seq, heads * (cfg.head_dim + 2) * 4,
                    attn, "decode KV-sequence softmax combine")
        return log

    if "model" not in axes:
        return log
    tok = b_loc * s * row
    passes = uses                              # fwd (+ recompute) + bwd
    for kind_name, n in (("all-gather", passes), ("reduce-scatter",
                                                  passes)):
        log.add(kind_name, tp_axes, tok, n * micro * sub,
                "sequence-parallel residual"
                + (" / MoE token exchange" if cfg.num_experts else ""))
    if table_split:
        log.add("reduce-scatter", tp_axes, tok, micro,
                "vocab-split embedding")
        if train:
            log.add("all-gather", tp_axes, tok, micro,
                    "embedding gradient rows")
    log.add("all-gather", tp_axes, tok, micro, "head input")
    if train:
        log.add("reduce-scatter", tp_axes, tok, micro, "head input grad")
        logits = _residual(constraints, "logits_bsv")
        if logits is not None and "model" in logits[2]:
            log.add("all-reduce", tp_axes, b_loc * s * 4, 3 * micro,
                    "vocab-split loss (max, sum, gold)")
    return log
