"""Activation-sharding context threaded through the model zoo.

The counterpart of the reference's ``repro.models.sharding_ctx``.  Models
never name mesh axes; they call ``ctx.constrain(x, kind)`` with a semantic
activation kind, and the launch layer's rules (``launch.sharding.
activation_rules``) say how that kind is split.
:meth:`ShardingCtx.constrain` always returns ``x`` itself: the port has no
partitioner that could move it.

* With an abstract mesh (the dry run) the rules are only reported: an
  ``observer`` attached to the context hears ``(x, kind)`` at every call,
  and the dry run's counter (``core.step_cost``) reads the rule of each
  kind from there.
* With a ``launch.mesh.ProcessMesh`` and the step's global ``dims``
  (:func:`step_dims`), the context describes a partitioned step (the
  train, prefill and serve steps of ``train.train_step`` over a mesh):
  the layers change layouts themselves, at the Megatron points of
  ``models.layers`` and ``models.model``, and ``constrain`` checks that
  ``x``'s local shape is the global shape split by the rule of its kind,
  so a layout error fails where it happens.  :meth:`ShardingCtx.parts`
  tells the layers how many blocks the rule cuts a dim into.

The default context has no rules, no mesh and no observer.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

#: ``observer(x, kind)``, called at each ``constrain``.
Observer = Callable[[torch.Tensor, str], None]


class ShardingCtx:
    """Maps semantic activation kinds to sharding rules."""

    #: Semantic kinds used by the model zoo.
    KINDS = (
        "tokens_bse",    # residual stream [batch, seq, d_model]
        "heads_bshd",    # attention activations [batch, seq, heads, hd]
        "kv_bskd",       # key/value activations [batch, seq, kv_heads, hd]
        "kv_cache",      # decode KV cache [batch, seq, kv_heads, hd]
        "logits_bsv",    # LM head output [batch, seq, vocab]
        "ffn_bsf",       # MLP hidden [batch, seq, d_ff]
        "moe_gecd",      # dispatched expert buffer [groups, experts, cap, d]
        "moe_gecf",      # expert FFN hidden [groups, experts, cap, ff]
        "ssm_bsdn",      # SSM inner state activations [batch, seq, d_in(, N)]
    )

    def __init__(self, rules: Optional[Dict[str, tuple]] = None,
                 mesh: Optional[object] = None,
                 observer: Optional[Observer] = None,
                 dims: Optional[Dict[str, int]] = None):
        self.rules = rules or {}
        self.mesh = mesh
        self.observer = observer
        self.dims = dims

    @property
    def process_mesh(self):
        """The ``ProcessMesh`` of a partitioned step (one with ``dims``),
        else None."""
        from repro_torch.launch.mesh import ProcessMesh
        if self.dims is not None and isinstance(self.mesh, ProcessMesh):
            return self.mesh
        return None

    def parts(self, kind: str, dim: int,
              full: Optional[tuple] = None) -> int:
        """How many blocks the rule of ``kind`` cuts dim ``dim`` into: 1
        without a rule, or where its axes do not divide the dim's global
        size (the reference's constraint drops such a split).  The global
        size is ``full[dim]``, or the step's (:data:`CHECKED`)."""
        from repro_torch.launch.sharding import axes_of, axes_size
        spec = self.rules.get(kind)
        if spec is None or dim >= len(spec) or spec[dim] is None:
            return 1
        n = axes_size(self.mesh, axes_of(spec[dim]))
        size = full[dim] if full is not None else \
            self.dims[CHECKED[kind][dim]]
        return n if size % n == 0 else 1

    def constrain(self, x: torch.Tensor, kind: str,
                  full: Optional[tuple] = None) -> torch.Tensor:
        """``x`` itself, after telling the observer (if any) its kind and,
        in a partitioned step, checking its local shape against its global
        shape: ``full``, or for the kinds of :data:`CHECKED` the step's
        dims (a decode cache's global length is the layer's own: a local
        layer's ring, whisper's cross K/V, so its layer passes ``full``).

        Raises:
            RuntimeError: in a partitioned step, ``x``'s shape is not its
                global shape split by the rule of ``kind``.
        """
        if self.observer is not None:
            self.observer(x, kind)
        if full is None and kind in CHECKED and \
                x.ndim == len(CHECKED[kind]) and self.dims is not None:
            full = tuple(self.dims[c] for c in CHECKED[kind])
        if self.process_mesh is not None and kind in self.rules and \
                full is not None:
            full = tuple(full)
            want = tuple(n // self.parts(kind, i, full)
                         for i, n in enumerate(full))
            if tuple(x.shape) != want:
                raise RuntimeError(
                    f"{kind}: this rank holds {tuple(x.shape)}, the rule "
                    f"{self.rules[kind]} splits the global {full} into "
                    f"{want}")
        return x


#: The kinds a partitioned step checks, and the :func:`step_dims` letter
#: of each of their dims.
CHECKED = {"tokens_bse": "bse", "heads_bshd": "bshd", "kv_bskd": "bskd",
           "logits_bsv": "bsv", "ffn_bsf": "bsf"}


def step_dims(cfg, batch: int, seq: int) -> Dict[str, int]:
    """The global sizes of the dims the kinds name, for a step of ``cfg``
    on ``batch`` rows of ``seq`` tokens (``b``, ``s``, ``e``, ``h``,
    ``k``, ``d``, ``f``, ``v``)."""
    return {"b": batch, "s": seq, "e": cfg.d_model, "h": cfg.num_heads,
            "k": cfg.num_kv_heads, "d": cfg.head_dim,
            "f": cfg.d_ff or cfg.moe_d_ff, "v": cfg.padded_vocab}


NO_SHARDING = ShardingCtx()
