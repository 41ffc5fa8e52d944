"""Activation-sharding context threaded through the model zoo.

The counterpart of the reference's ``repro.models.sharding_ctx``.  Models
never name mesh axes; they call ``ctx.constrain(x, kind)`` with a semantic
activation kind, and the launch layer's rules (``launch.sharding.
activation_rules``) say how that kind is split.  The port executes on one
card, so :meth:`ShardingCtx.constrain` always returns ``x`` itself.  An
``observer`` attached to the context hears ``(x, kind)`` at every call:
the dry run's counter (``core.step_cost``) reads the rule of each kind
from there.  The default context has no rules and no observer.
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
                 observer: Optional[Observer] = None):
        self.rules = rules or {}
        self.mesh = mesh
        self.observer = observer

    def constrain(self, x: torch.Tensor, kind: str) -> torch.Tensor:
        """``x`` itself, after telling the observer (if any) its kind."""
        if self.observer is not None:
            self.observer(x, kind)
        return x


NO_SHARDING = ShardingCtx()
