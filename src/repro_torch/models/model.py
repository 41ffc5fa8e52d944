"""Model assembly: the decoder-only LM of the ``dense`` and ``moe`` families.

The counterpart of the reference's ``repro.models.model`` for configs
whose ``layer_pattern`` is ``("global",)``: llama3.2-1b, gemma-2b,
qwen2-72b, olmoe-1b-7b and qwen3-moe-235b-a22b.  The reference stacks
its layers on a leading axis and scans them; here :class:`LM` holds one
:class:`Block` per layer in a ``ModuleList``.  The public entry points
keep the reference's semantics:

* :func:`init_params` builds an :class:`LM` on a device from a
  ``torch.Generator`` (random weights, as the reference draws them);
* :meth:`LM.forward` gives fp32 logits ``[B, S, V_padded]`` for a token
  batch (chunked causal attention);
* :meth:`LM.init_cache` / :meth:`LM.decode_step` run one token per
  sequence against a KV cache, writing slot ``min(pos, S_c - 1)`` and
  attending to slots ``<= pos``.

Weights are held in the dtype each use casts them to in the reference:
matrices, expert weights, biases and the embedding table in
:data:`COMPUTE_DTYPE`, norm scales and the router in fp32.  Other
families and layer kinds raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.moe import LAUNCHES_PER_LAYER, GroupedMatmul, MoE

COMPUTE_DTYPE = torch.bfloat16

#: What brings each family or layer kind the port does not run yet
#: (``ROADMAP.md`` Queue A, item 7).
NOT_PORTED = ("the local, vlm, ssm, hybrid and encdec families "
              "(ROADMAP.md Queue A item 7)")


#: Roundings to the compute dtype per layer on the path from the embedding
#: to the logits: attention (ln1, the q/k/v projections, RoPE, q's
#: 1/sqrt(D) scale, the attention output, wo, the residual add) and the
#: MoE FFN (ln2, gate/up, the activation, its product with up, down, the
#: combine's product and sum, the residual add).  A dense FFN has two
#: roundings fewer, so this counts a dense layer high.
ROUNDINGS_PER_LAYER = 15


def rounding_tolerance(stages: int, scale: torch.Tensor, compared: int,
                       dtype: torch.dtype = torch.bfloat16,
                       alpha: float = 1e-6) -> torch.Tensor:
    """Allowed ``|a - b|`` between two computations that round the same
    quantities to ``dtype`` at the same ``stages`` places.

    Each rounding perturbs its value by a relative ``delta`` with
    ``|delta| <= u``, the unit roundoff (``eps(dtype) / 2``).  Two runs
    whose fp32 sums differ in their last bits may round a value to
    neighbouring values, so their difference is a sum of at most ``2 *
    stages`` such terms.  Taking the terms as independent and zero-mean
    and their gain to the result as at most 1 relative to ``scale`` (the
    probabilistic rounding analysis of Higham and Mary, 2019), Hoeffding's
    inequality bounds the difference by ``lam * u * sqrt(2 * stages) *
    scale`` with probability at least ``1 - alpha`` over ``compared``
    values when ``lam = sqrt(2 ln(2 compared / alpha))``.
    """
    lam = math.sqrt(2.0 * math.log(2.0 * compared / alpha))
    u = float(torch.finfo(dtype).eps) / 2
    return lam * u * math.sqrt(2.0 * stages) * scale


def logit_tolerance(cfg: ModelConfig, logits_rms: torch.Tensor,
                    compared: int, dtype: torch.dtype = torch.bfloat16,
                    alpha: float = 1e-6) -> torch.Tensor:
    """:func:`rounding_tolerance` of two runs of ``cfg``'s logits: ``S =
    ROUNDINGS_PER_LAYER * num_layers + 2`` roundings (the final norm and
    the logits add two), relative to each row's rms (``logits_rms``,
    broadcast against the logits)."""
    return rounding_tolerance(ROUNDINGS_PER_LAYER * cfg.num_layers + 2,
                              logits_rms, compared, dtype, alpha)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``cfg``."""
    if cfg.family not in ("dense", "moe") or \
            tuple(cfg.layer_pattern) != ("global",) or cfg.mrope:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with layer pattern "
            f"{cfg.layer_pattern} is not ported; it comes with "
            f"{NOT_PORTED}")


def scale_embed(cfg: ModelConfig) -> bool:
    """Gemma-family models scale embeddings by sqrt(d_model); in the
    assigned pool that is exactly the geglu archs."""
    return cfg.mlp_variant == "geglu"


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv`` (with ``qkv_bias``) and ``wo``."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        self.cfg = cfg
        self.wq = L.Dense(d, cfg.num_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wk = L.Dense(d, cfg.num_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wv = L.Dense(d, cfg.num_kv_heads * hd, bias=cfg.qkv_bias, **kw)
        self.wo = L.Dense(cfg.num_heads * hd, d, **kw)

    def qkv(self, x: torch.Tensor, positions: torch.Tensor):
        """Projections of ``x [B, S, d]`` with RoPE on q and k."""
        cfg = self.cfg
        b, s, _ = x.shape
        q = self.wq(x).reshape(b, s, cfg.num_heads, cfg.head_dim)
        k = self.wk(x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = self.wv(x).reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
        return (L.apply_rope(q, positions, cfg.rope_theta),
                L.apply_rope(k, positions, cfg.rope_theta), v)

    def forward(self, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        q, k, v = self.qkv(x, positions)
        out = A.chunked_attention(q, k, v, causal=True)
        return self.wo(out.reshape(b, s, -1))

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int) -> torch.Tensor:
        """x: ``[B, 1, d]``; writes slot ``min(pos, S_c - 1)`` of the
        cache in place and attends to slots ``<= pos``."""
        b = x.shape[0]
        positions = torch.full((b, 1), pos, dtype=torch.int64,
                               device=x.device)
        q, k_new, v_new = self.qkv(x, positions)
        s_c = cache["k"].shape[1]
        slot = min(pos, s_c - 1)
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        mask = (torch.arange(s_c, device=x.device) <= pos)[None, :] \
            .expand(b, s_c)
        out = A.decode_attention(q, cache["k"], cache["v"], mask)
        return self.wo(out.reshape(b, 1, -1))


class Block(nn.Module):
    """Pre-norm attention, then the dense or MoE FFN, each residual."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        d = cfg.d_model
        norm_kw = dict(device=kw["device"])
        self.ln1 = L.RMSNorm(d, cfg.norm_eps, **norm_kw)
        self.attn = Attention(cfg, **kw)
        self.ln2 = L.RMSNorm(d, cfg.norm_eps, **norm_kw)
        if cfg.num_experts:
            self.moe = MoE(d, cfg.moe_d_ff, cfg.num_experts,
                           cfg.num_experts_per_token,
                           cfg.moe_capacity_factor, **kw)
        else:
            self.mlp = L.MLP(d, cfg.d_ff, cfg.mlp_variant, **kw)

    def ffn(self, x: torch.Tensor, gmm: GroupedMatmul) -> torch.Tensor:
        h = self.ln2(x)
        if hasattr(self, "moe"):
            return x + self.moe(h, gmm)
        return x + self.mlp(h)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                gmm: GroupedMatmul = grouped_matmul) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), positions)
        return self.ffn(x, gmm)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int, gmm: GroupedMatmul) -> torch.Tensor:
        x = x + self.attn.decode(self.ln1(x), cache, pos)
        return self.ffn(x, gmm)


class LM(nn.Module):
    """The decoder-only LM: embedding, ``num_layers`` :class:`Block`\\ s,
    final norm and the tied table or a separate ``lm_head``.

    Args:
        cfg: a ``dense`` or ``moe`` config with ``layer_pattern ==
            ("global",)``.
        device: where the weights are made (None: the card).  ``"meta"``
            makes no storage, for weights loaded afterwards
            (``repro_torch.interop.params_from_numpy``).
        generator: the ``torch.Generator`` (on ``device``) the weights
            are drawn from.
        dtype: the compute dtype (default :data:`COMPUTE_DTYPE`, read
            when the model is made).

    Raises:
        NotImplementedError: for another family or layer kind.
    """

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype or COMPUTE_DTYPE
        kw = dict(dtype=self.dtype, device=dev, generator=generator)
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.layers = nn.ModuleList(Block(cfg, **kw)
                                    for _ in range(cfg.num_layers))
        self.final_norm = L.RMSNorm(cfg.d_model, cfg.norm_eps, device=dev)
        self.lm_head = None if cfg.tie_embeddings else \
            L.Dense(cfg.d_model, cfg.padded_vocab, **kw)

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed(self.embed.table, tokens.to(self.device),
                       scale=scale_embed(self.cfg))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        x = self.final_norm(x)
        if self.lm_head is None:
            return L.unembed(self.embed.table, x).float()
        return self.lm_head(x).float()

    def forward(self, tokens: torch.Tensor,
                gmm: GroupedMatmul = grouped_matmul) -> torch.Tensor:
        """tokens ``[B, S]`` -> fp32 logits ``[B, S, V_padded]``."""
        x = self._embed(tokens)
        b, s = tokens.shape
        positions = torch.arange(s, device=self.device)[None].expand(b, s)
        for block in self.layers:
            x = block(x, positions, gmm)
        return self._logits(x)

    def init_cache(self, batch: int,
                   cache_len: int) -> List[Dict[str, torch.Tensor]]:
        """One ``{"k", "v"}`` pair of ``[B, cache_len, Hkv, D]`` zeros in the
        compute dtype per layer."""
        cfg = self.cfg
        shape = (batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
        return [{"k": torch.zeros(shape, dtype=self.dtype,
                                  device=self.device),
                 "v": torch.zeros(shape, dtype=self.dtype,
                                  device=self.device)}
                for _ in range(cfg.num_layers)]

    def decode_step(self, cache: List[Dict[str, torch.Tensor]],
                    tokens: torch.Tensor, pos: int,
                    gmm: GroupedMatmul = grouped_matmul) -> torch.Tensor:
        """One decode step: tokens ``[B]`` at position ``pos`` (the same for
        the whole batch) -> fp32 logits ``[B, V_padded]``; the cache is
        updated in place."""
        x = self._embed(tokens[:, None])
        for block, layer_cache in zip(self.layers, cache):
            x = block.decode(x, layer_cache, pos, gmm)
        return self._logits(x)[:, 0]

    def grouped_launches_per_step(self) -> int:
        """Grouped-matmul launches one ``decode_step`` or ``forward`` makes
        on the card: two per MoE layer."""
        return LAUNCHES_PER_LAYER * self.cfg.num_layers \
            if self.cfg.num_experts else 0


def init_params(cfg: ModelConfig, *, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                dtype: Optional[torch.dtype] = None) -> LM:
    """A randomly initialised :class:`LM` (see its arguments)."""
    return LM(cfg, device=device, generator=generator, dtype=dtype)
