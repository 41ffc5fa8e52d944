"""Model assembly: the LM of all ten archs, the ``dense``, ``moe``,
``vlm``, ``encdec``, ``ssm`` and ``hybrid`` families, with global and
sliding-window (``local``) attention layers, mamba (``ssm``) layers and
RG-LRU (``rglru``) layers.

The counterpart of the reference's ``repro.models.model`` for llama3.2-1b,
gemma-2b, qwen2-72b, olmoe-1b-7b, qwen3-moe-235b-a22b, gemma3-12b (five
``local`` layers to one ``global``), qwen2-vl-7b (M-RoPE and projected
patch embeddings), whisper-base (an encoder, and cross-attention in
every decoder layer), falcon-mamba-7b (mamba layers only) and
recurrentgemma-9b (two RG-LRU layers to one local).  The reference stacks
each kind of layer of ``cfg.layer_pattern`` on a leading axis and scans
the groups; here :class:`LM` holds one block per layer in a
``ModuleList``, layer ``i`` of kind ``layer_pattern[i % period]``
(:class:`Block` for attention, :class:`MambaBlock`, :class:`RGLRUBlock`).
The public entry points keep the reference's semantics:

* :func:`init_params` builds an :class:`LM` on a device from a
  ``torch.Generator`` (random weights, as the reference draws them);
* :meth:`LM.forward` gives fp32 logits ``[B, S, V_padded]`` for a token
  batch, with whisper's ``frames``, qwen2-vl's ``mm_embeds`` and
  ``positions_3d``; a global layer runs chunked causal attention, a local
  layer sliding-window attention once ``S`` exceeds its window; each layer
  is checkpointed (``torch.utils.checkpoint``) where gradients are
  recorded, as the reference's per-layer ``jax.checkpoint``;
* :meth:`LM.encode` and :meth:`LM.prime_cross_cache` run whisper's
  encoder and fill the decoder's cross-attention K/V;
* :meth:`LM.init_cache` / :meth:`LM.decode_step` run one token per
  sequence against a KV cache: a global layer writes slot ``min(pos, S_c
  - 1)`` of ``cache_len`` slots and attends to slots ``<= pos``; a local
  layer's cache is a ring of ``min(cache_len, window)`` slots written at
  ``pos % S_c``; an ``ssm`` or ``rglru`` layer's cache is its last ``K -
  1`` raw conv inputs and its fp32 state (``models.ssm``,
  ``models.rglru``).

For serving, weights are held in the dtype each use casts them to in the
reference: matrices, expert weights, biases and the embedding table in
:data:`COMPUTE_DTYPE`, norm scales and the router in fp32.  For training
(``masters=True``) every weight is a trainable fp32 master, cast to the
compute dtype at each use, as the reference's parameters are.  A family
or layer kind the port does not know raises ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import DeviceLike, resolve_device
from repro_torch.kernels.grouped_matmul import grouped_matmul
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.moe import LAUNCHES_PER_LAYER, GroupedMatmul, MoE
from repro_torch.models.sharding_ctx import NO_SHARDING, ShardingCtx

COMPUTE_DTYPE = torch.bfloat16

#: Fuse each decoder layer's q/k/v projections into one ``wqkv`` and a
#: gated MLP's gate/up into one ``wi_fused``: the same products, fewer
#: launches (and, on a mesh, one backward all-reduce where there were
#: three or two).  Read when an ``LM`` is made; off by default, as in the
#: reference.  whisper's encoder and cross-attention stay unfused.
FUSE_PROJECTIONS = False


def set_fused_projections(flag: bool) -> None:
    """Set :data:`FUSE_PROJECTIONS` for the models made after the call."""
    global FUSE_PROJECTIONS
    FUSE_PROJECTIONS = flag

#: The families and layer kinds the port runs.
FAMILIES = ("dense", "moe", "vlm", "encdec", "ssm", "hybrid")
LAYER_KINDS = ("global", "local", "ssm", "rglru")
ATTENTION_KINDS = ("global", "local")


#: Roundings to the compute dtype per layer on the path from the embedding
#: to the logits: attention (ln1, the q/k/v projections, RoPE, q's
#: 1/sqrt(D) scale, the attention output, wo, the residual add) and the
#: MoE FFN (ln2, gate/up, the activation, its product with up, down, the
#: combine's product and sum, the residual add).  A dense FFN has two
#: roundings fewer, so this counts a dense layer high.
ROUNDINGS_PER_LAYER = 15

#: Roundings of an ``ssm`` layer (conv kernel K = 4, both archs' value):
#: ln, in_proj, the unrolled conv (K products and K sums, the bias's
#: included), silu, x_proj, dt_proj, the scan's output cast (dt, the
#: discretisation and the scan are fp32), its sum with u * D and that
#: product, silu(z) and the product with it, out_proj, the residual add:
#: 12 + 2 * 4 = 20.
SSM_ROUNDINGS_PER_LAYER = 20

#: Roundings of an ``rglru`` layer (K = 4): ln1, wx, the unrolled conv (8,
#: as in an ``ssm`` layer), the gate blocks (r and i side by side; the
#: gates and the scan are fp32), the scan's output cast, wy, its gelu,
#: the product with that branch, out, the residual add; then the dense
#: FFN: ln2, gate/up, the activation, its product with up, down, the
#: residual add: 17 + 6 = 23.
RGLRU_ROUNDINGS_PER_LAYER = 23

#: Roundings per decoder layer by kind.
ROUNDINGS_BY_KIND = {"global": ROUNDINGS_PER_LAYER,
                     "local": ROUNDINGS_PER_LAYER,
                     "ssm": SSM_ROUNDINGS_PER_LAYER,
                     "rglru": RGLRU_ROUNDINGS_PER_LAYER}

#: Roundings of a decoder layer's cross-attention (``encdec``): ln_cross,
#: q, the attention output, wo, the residual add.
CROSS_ROUNDINGS = 5

#: Roundings of an encoder layer, which feed every cross K/V: ln1, the
#: q/k/v projections, q's scale, the probabilities, the attention output,
#: wo, the residual add, ln2, wi, the gelu, wo, the residual add.
ENCODER_ROUNDINGS_PER_LAYER = 12

#: Roundings around the encoder and the decoder's embedding (``encdec``):
#: the frames' sinusoidal positions, the encoder's final norm, the cross
#: K/V projections of its output, and the decoder's sinusoidal positions.
ENCODER_EXTRA_ROUNDINGS = 4

#: Roundings of qwen2-vl's front: ``mm_proj`` of the patch embeddings.
MM_PROJ_ROUNDINGS = 1


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


def roundings(cfg: ModelConfig, layers: Optional[int] = None) -> int:
    """Roundings to the compute dtype on the path from the inputs to
    ``cfg``'s logits, per family:

    * every decoder layer, global or local: :data:`ROUNDINGS_PER_LAYER`
      (M-RoPE rounds where RoPE does); ``ssm``:
      :data:`SSM_ROUNDINGS_PER_LAYER`; ``rglru``:
      :data:`RGLRU_ROUNDINGS_PER_LAYER`; the final norm and the logits:
      2;
    * ``encdec``: :data:`CROSS_ROUNDINGS` per decoder layer,
      :data:`ENCODER_ROUNDINGS_PER_LAYER` per encoder layer and
      :data:`ENCODER_EXTRA_ROUNDINGS` (whisper-base: 6 * 15 + 2 + 6 * 5 + 6
      * 12 + 4 = 198);
    * ``vlm``: :data:`MM_PROJ_ROUNDINGS` (qwen2-vl-7b: 28 * 15 + 2 + 1 =
      423).

    gemma3-12b has 48 * 15 + 2 = 722, falcon-mamba-7b 64 * 20 + 2 = 1282,
    recurrentgemma-9b 26 * 23 + 12 * 15 + 2 = 780.  With ``layers``, the
    count through the first ``layers`` decoder layers only (at least those
    before any value that layer ``layers - 1`` computes).
    """
    layers = cfg.num_layers if layers is None else layers
    n = sum(ROUNDINGS_BY_KIND[k] for k in layer_kinds(cfg)[:layers]) + 2
    if cfg.family == "encdec":
        n += CROSS_ROUNDINGS * layers + ENCODER_EXTRA_ROUNDINGS + \
            ENCODER_ROUNDINGS_PER_LAYER * cfg.encoder_layers
    if cfg.family == "vlm":
        n += MM_PROJ_ROUNDINGS
    return n


def unshared_roundings(cfg: ModelConfig,
                       layers: Optional[int] = None) -> int:
    """Roundings ``forward`` does that ``decode_step`` does not, in all
    decoder layers or the first ``layers``: each of its attention tiles
    rounds the probabilities that multiply V to the compute dtype, where
    decode keeps them fp32 (one per self-attention layer, and one per
    cross-attention layer).  The encoder runs the same code in both, and
    so do the ``ssm`` and ``rglru`` layers up to the fp32 scan's order of
    association."""
    layers = cfg.num_layers if layers is None else layers
    attn = sum(k in ATTENTION_KINDS for k in layer_kinds(cfg)[:layers])
    return attn * (2 if cfg.family == "encdec" else 1)


def logit_tolerance(cfg: ModelConfig, logits_rms: torch.Tensor,
                    compared: int, dtype: torch.dtype = torch.bfloat16,
                    alpha: float = 1e-6) -> torch.Tensor:
    """:func:`rounding_tolerance` of two runs of ``cfg``'s logits over
    :func:`roundings` ``(cfg)`` stages, relative to each row's rms
    (``logits_rms``, broadcast against the logits).  Decode against
    forward adds :func:`unshared_roundings` (``models.decode_check``)."""
    return rounding_tolerance(roundings(cfg), logits_rms, compared, dtype,
                              alpha)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` unless the port runs ``cfg``: its
    family is one of :data:`FAMILIES` and its layers of
    :data:`LAYER_KINDS`."""
    if cfg.family not in FAMILIES or \
            not set(cfg.layer_pattern) <= set(LAYER_KINDS):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} with layer pattern "
            f"{cfg.layer_pattern} is not one the port knows (families "
            f"{FAMILIES}, layer kinds {LAYER_KINDS})")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """The kind of each decoder layer: ``layer_pattern[i % period]``."""
    pattern = cfg.layer_pattern
    return [pattern[i % len(pattern)] for i in range(cfg.num_layers)]


def cache_slot(kind: str, pos: int, s_c: int) -> int:
    """The cache slot a decode step at ``pos`` writes: ``pos % S_c`` in a
    local layer's ring, ``min(pos, S_c - 1)`` in a global layer's cache."""
    return pos % s_c if kind == "local" else min(pos, s_c - 1)


def cache_mask(kind: str, pos: int, s_c: int,
               device: torch.device) -> torch.Tensor:
    """``[S_c]`` bool, the slots a decode step at ``pos`` attends to: every
    slot of a ring that has filled (``pos >= S_c``), else the slots
    ``<= pos``."""
    slots = torch.arange(s_c, device=device)
    if kind == "local" and pos >= s_c:
        return torch.ones_like(slots, dtype=torch.bool)
    return slots <= pos


def make_norm(cfg: ModelConfig, d: int, *, device: torch.device,
              trainable: bool = False) -> nn.Module:
    """The family's norm: LayerNorm (eps 1e-5) for ``encdec``, RMSNorm
    (``cfg.norm_eps``) otherwise, as the reference's ``_norm_fn``."""
    if cfg.family == "encdec":
        return L.LayerNorm(d, device=device, trainable=trainable)
    return L.RMSNorm(d, cfg.norm_eps, device=device, trainable=trainable)


def scale_embed(cfg: ModelConfig) -> bool:
    """Gemma-family models scale embeddings by sqrt(d_model); in the
    assigned pool that is exactly the geglu archs."""
    return cfg.mlp_variant == "geglu"


class Attention(nn.Module):
    """``wq``, ``wk``, ``wv`` (with ``qkv_bias``) and ``wo``, for one
    ``kind`` of attention: ``"global"`` (causal), ``"local"`` (a sliding
    window of ``cfg.window_size``), ``"encoder"`` (bidirectional) or
    ``"cross"`` (the decoder's queries on the encoder's output).  With
    ``fused`` (global and local only), one ``wqkv`` ``[d, (H + 2 Hkv) D]``
    holds q's, k's and v's columns side by side."""

    def __init__(self, cfg: ModelConfig, kind: str = "global",
                 fused: bool = False, **kw):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        self.cfg, self.kind = cfg, kind
        if fused:
            self.wqkv = L.Dense(d, (cfg.num_heads + 2 * cfg.num_kv_heads)
                                * hd, bias=cfg.qkv_bias, **kw)
        else:
            self.wq = L.Dense(d, cfg.num_heads * hd, bias=cfg.qkv_bias,
                              **kw)
            self.wk = L.Dense(d, cfg.num_kv_heads * hd, bias=cfg.qkv_bias,
                              **kw)
            self.wv = L.Dense(d, cfg.num_kv_heads * hd, bias=cfg.qkv_bias,
                              **kw)
        self.wo = L.Dense(cfg.num_heads * hd, d, **kw)

    def _heads(self, y: torch.Tensor, heads: int) -> torch.Tensor:
        return y.reshape(y.shape[0], y.shape[1], heads, self.cfg.head_dim)

    def kv(self, x: torch.Tensor):
        """K and V projections of ``x [B, S, d]``, without RoPE."""
        return (self._heads(self.wk(x), self.cfg.num_kv_heads),
                self._heads(self.wv(x), self.cfg.num_kv_heads))

    def qkv(self, x: torch.Tensor, positions: torch.Tensor,
            ctx: ShardingCtx = NO_SHARDING):
        """Projections of ``x [B, S, d]``, with RoPE on q and k (M-RoPE
        where the positions are ``[3, B, S]``; none for ``encdec``),
        constrained as ``"heads_bshd"`` / ``"kv_bskd"``."""
        cfg = self.cfg
        if hasattr(self, "wqkv"):
            nq = cfg.num_heads * cfg.head_dim
            nkv = cfg.num_kv_heads * cfg.head_dim
            fused = self.wqkv(x)
            q = self._heads(fused[..., :nq], cfg.num_heads)
            k = self._heads(fused[..., nq:nq + nkv], cfg.num_kv_heads)
            v = self._heads(fused[..., nq + nkv:], cfg.num_kv_heads)
        else:
            q = self._heads(self.wq(x), cfg.num_heads)
            k, v = self.kv(x)
        if cfg.family != "encdec":
            rope = L.apply_mrope if cfg.mrope and positions.dim() == 3 \
                else L.apply_rope
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        return (ctx.constrain(q, "heads_bshd"), ctx.constrain(k, "kv_bskd"),
                ctx.constrain(v, "kv_bskd"))

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor],
                ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        b, s, _ = x.shape
        q, k, v = self.qkv(x, positions, ctx)
        if self.kind == "local" and s > self.cfg.window_size:
            out = A.local_attention(q, k, v, window=self.cfg.window_size)
        else:
            out = A.chunked_attention(q, k, v,
                                      causal=self.kind != "encoder")
        out = ctx.constrain(out, "heads_bshd")
        return self.wo(out.reshape(b, s, -1))

    def cross(self, x: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """The decoder's queries ``x [B, S, d]`` on the encoder's output
        (bidirectional, no RoPE)."""
        b, s, _ = x.shape
        k, v = self.kv(enc_out)
        out = A.chunked_attention(self._heads(self.wq(x), self.cfg.num_heads),
                                  k, v, causal=False)
        return self.wo(out.reshape(b, s, -1))

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int, positions: torch.Tensor,
               ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        """x: ``[B, 1, d]``; writes slot :func:`cache_slot` of the cache in
        place and attends to the slots :func:`cache_mask` gives."""
        b = x.shape[0]
        q, k_new, v_new = self.qkv(x, positions, ctx)
        s_c = cache["k"].shape[1]
        slot = cache_slot(self.kind, pos, s_c)
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        mask = cache_mask(self.kind, pos, s_c, x.device)[None, :] \
            .expand(b, s_c)
        out = A.decode_attention(q, ctx.constrain(cache["k"], "kv_cache"),
                                 ctx.constrain(cache["v"], "kv_cache"),
                                 mask)
        return self.wo(out.reshape(b, 1, -1))

    def cross_decode(self, x: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
        """x: ``[B, 1, d]`` on the primed cross cache, every slot valid."""
        b = x.shape[0]
        q = self._heads(self.wq(x), self.cfg.num_heads)
        mask = torch.ones(b, k.shape[1], dtype=torch.bool, device=x.device)
        out = A.decode_attention(q, k, v, mask)
        return self.wo(out.reshape(b, 1, -1))


class Block(nn.Module):
    """Pre-norm attention of one ``kind`` (``"global"``, ``"local"`` or, in
    whisper's encoder, ``"encoder"``), then, in an ``encdec`` decoder
    layer, cross-attention, then the dense or MoE FFN, each residual."""

    def __init__(self, cfg: ModelConfig, kind: str = "global", **kw):
        super().__init__()
        d = cfg.d_model
        fused = FUSE_PROJECTIONS and kind != "encoder"
        norm_kw = dict(device=kw["device"], trainable=kw["trainable"])
        self.ln1 = make_norm(cfg, d, **norm_kw)
        self.attn = Attention(cfg, kind, fused=fused, **kw)
        self.ln2 = make_norm(cfg, d, **norm_kw)
        if cfg.num_experts:
            self.moe = MoE(d, cfg.moe_d_ff, cfg.num_experts,
                           cfg.num_experts_per_token,
                           cfg.moe_capacity_factor, **kw)
        else:
            self.mlp = L.MLP(d, cfg.d_ff, cfg.mlp_variant, fused=fused,
                             **kw)
        if cfg.family == "encdec" and kind != "encoder":
            self.ln_cross = make_norm(cfg, d, **norm_kw)
            self.cross = Attention(cfg, "cross", **kw)

    def ffn(self, x: torch.Tensor, gmm: GroupedMatmul,
            ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        h = self.ln2(x)
        if hasattr(self, "moe"):
            return x + self.moe(h, gmm, ctx)
        return x + self.mlp(h, ctx)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor],
                gmm: GroupedMatmul = grouped_matmul,
                enc_out: Optional[torch.Tensor] = None,
                ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        # whisper's encoder constrains only its MLP, as the reference's.
        x = x + self.attn(self.ln1(x), positions,
                          NO_SHARDING if self.attn.kind == "encoder" else ctx)
        if hasattr(self, "cross"):
            x = x + self.cross.cross(self.ln_cross(x), enc_out)
        return self.ffn(x, gmm, ctx)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int, positions: torch.Tensor,
               gmm: GroupedMatmul,
               ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        x = x + self.attn.decode(self.ln1(x), cache, pos, positions, ctx)
        if hasattr(self, "cross"):
            x = x + self.cross.cross_decode(self.ln_cross(x),
                                            cache["cross_k"],
                                            cache["cross_v"])
        return self.ffn(x, gmm, ctx)


class MambaBlock(nn.Module):
    """An ``ssm`` layer: ``x + mamba(ln(x))`` (:class:`models.ssm.Mamba`).
    Its methods take :class:`Block`'s arguments and ignore the positions,
    the grouped matmul and the encoder's output."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.ln = make_norm(cfg, cfg.d_model, device=kw["device"],
                            trainable=kw["trainable"])
        self.mamba = S.Mamba(cfg.d_model, cfg.ssm_state, cfg.ssm_conv,
                             cfg.ssm_expand, **kw)

    def forward(self, x: torch.Tensor, positions=None, gmm=None,
                enc_out=None, ctx: ShardingCtx = NO_SHARDING
                ) -> torch.Tensor:
        return x + S.mamba_forward(self.mamba, self.ln(x), ctx=ctx)

    def init_cache(self, batch: int, dtype: torch.dtype):
        return S.init_mamba_cache(self.mamba, batch, dtype)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int, positions, gmm, ctx=NO_SHARDING) -> torch.Tensor:
        """One token; the cache's ``conv`` and ``h`` are replaced."""
        out, new = S.mamba_decode(self.mamba, cache, self.ln(x))
        cache.update(new)
        return x + out


class RGLRUBlock(nn.Module):
    """An ``rglru`` layer: ``x + rglru(ln1(x))``, then ``+ mlp(ln2(x))``
    (:class:`models.rglru.RGLRU`, the dense FFN).  Its methods take
    :class:`Block`'s arguments and ignore the positions, the grouped
    matmul and the encoder's output."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        norm_kw = dict(device=kw["device"], trainable=kw["trainable"])
        self.ln1 = make_norm(cfg, cfg.d_model, **norm_kw)
        self.rglru = R.RGLRU(cfg.d_model, cfg.rnn_width or cfg.d_model,
                             cfg.ssm_conv, **kw)
        self.ln2 = make_norm(cfg, cfg.d_model, **norm_kw)
        self.mlp = L.MLP(cfg.d_model, cfg.d_ff, cfg.mlp_variant,
                         fused=FUSE_PROJECTIONS, **kw)

    def forward(self, x: torch.Tensor, positions=None, gmm=None,
                enc_out=None, ctx: ShardingCtx = NO_SHARDING
                ) -> torch.Tensor:
        x = x + R.rglru_forward(self.rglru, self.ln1(x), ctx=ctx)
        return x + self.mlp(self.ln2(x), ctx)

    def init_cache(self, batch: int, dtype: torch.dtype):
        return R.init_rglru_cache(self.rglru, batch, dtype)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: int, positions, gmm, ctx=NO_SHARDING) -> torch.Tensor:
        """One token; the cache's ``conv`` and ``h`` are replaced (as in
        the reference, its MLP sees no constraint)."""
        out, new = R.rglru_decode(self.rglru, cache, self.ln1(x))
        cache.update(new)
        x = x + out
        return x + self.mlp(self.ln2(x))


def make_block(cfg: ModelConfig, kind: str, **kw) -> nn.Module:
    """The block of one decoder layer of ``kind``."""
    if kind == "ssm":
        return MambaBlock(cfg, **kw)
    if kind == "rglru":
        return RGLRUBlock(cfg, **kw)
    return Block(cfg, kind, **kw)


class Encoder(nn.Module):
    """whisper's encoder: ``encoder_layers`` bidirectional :class:`Block`\\ s
    and a final norm."""

    def __init__(self, cfg: ModelConfig, **kw):
        super().__init__()
        self.layers = nn.ModuleList(Block(cfg, "encoder", **kw)
                                    for _ in range(cfg.encoder_layers))
        self.norm = make_norm(cfg, cfg.d_model, device=kw["device"],
                              trainable=kw["trainable"])


class LM(nn.Module):
    """The LM: embedding (and qwen2-vl's ``mm_proj``), ``num_layers``
    blocks of the kinds ``cfg.layer_pattern`` repeats (:func:`make_block`),
    final
    norm and the tied table or a separate ``lm_head``; for ``encdec``, an
    :class:`Encoder` and cross-attention in every decoder layer.

    Args:
        cfg: a config of one of :data:`FAMILIES` whose layers are of
            :data:`LAYER_KINDS`.
        device: where the weights are made (None: the card).  ``"meta"``
            makes no storage, for weights loaded afterwards
            (``repro_torch.interop.params_from_numpy``).
        generator: the ``torch.Generator`` (on ``device``) the weights
            are drawn from.
        dtype: the compute dtype (default :data:`COMPUTE_DTYPE`, read
            when the model is made).
        masters: hold every weight as a trainable fp32 master (for
            training) instead of a frozen copy in the dtype of its use.

    Raises:
        NotImplementedError: for a family or layer kind the port does not
            know.
    """

    def __init__(self, cfg: ModelConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 dtype: Optional[torch.dtype] = None, masters: bool = False):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.dtype = dtype or COMPUTE_DTYPE
        kw = dict(dtype=torch.float32 if masters else self.dtype, device=dev,
                  generator=generator, trainable=masters)
        self.embed = L.Embedding(cfg.padded_vocab, cfg.d_model, **kw)
        self.layers = nn.ModuleList(make_block(cfg, kind, **kw)
                                    for kind in layer_kinds(cfg))
        self.final_norm = make_norm(cfg, cfg.d_model, device=dev,
                                    trainable=masters)
        self.lm_head = None if cfg.tie_embeddings else \
            L.Dense(cfg.d_model, cfg.padded_vocab, **kw)
        if cfg.family == "encdec":
            self.encoder = Encoder(cfg, **kw)
        if cfg.family == "vlm":
            self.mm_proj = L.Dense(cfg.d_model, cfg.d_model, **kw)
        self._sinusoid_table: Optional[torch.Tensor] = None

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def _sinusoid(self, rows: int) -> torch.Tensor:
        """The first ``rows`` rows of whisper's fp32 sinusoidal table, kept
        on the model's device and built again only to grow it."""
        t = self._sinusoid_table
        if t is None or t.shape[0] < rows or t.device != self.device:
            t = L.sinusoidal_positions(rows, self.cfg.d_model, self.device)
            self._sinusoid_table = t
        return t[:rows]

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed(self.embed.table, tokens.to(self.device),
                       scale=scale_embed(self.cfg), dtype=self.dtype)

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states -> fp32 logits."""
        if self.lm_head is None:
            return L.unembed(self.embed.table, x).float()
        return self.lm_head(x).float()

    def unembed_table(self) -> torch.Tensor:
        """``[V_padded, d]`` output-projection table (tied or separate), in
        the dtype it is stored in."""
        if self.lm_head is None:
            return self.embed.table
        return self.lm_head.kernel.T

    def _layer(self, block: nn.Module, remat: bool,
               *args) -> torch.Tensor:
        if remat and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def encode(self, frames: torch.Tensor, remat: bool = True,
               ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        """whisper's encoder on ``frames [B, S_enc, d]`` (the stubbed
        front end's embeddings): the frames in the compute dtype plus the
        sinusoidal table, the bidirectional layers (checkpointed under
        ``remat`` where gradients are recorded), the final norm."""
        if self.cfg.family != "encdec":
            raise ValueError(f"{self.cfg.name} has no encoder")
        x = frames.to(self.device).to(self.dtype)
        x = x + self._sinusoid(x.shape[1]).to(x.dtype)
        for block in self.encoder.layers:
            x = self._layer(block, remat, x, None, None, None, ctx)
        return self.encoder.norm(x)

    def _embed_tokens(self, tokens: torch.Tensor,
                      mm_embeds: Optional[torch.Tensor],
                      ctx: ShardingCtx) -> torch.Tensor:
        """Token embeddings; qwen2-vl's first ``n_mm`` replaced by
        ``mm_proj(mm_embeds)`` in the compute dtype; whisper's plus the
        sinusoidal table's first ``S`` rows; constrained as
        ``"tokens_bse"``."""
        x = self._embed(tokens)
        if self.cfg.family == "vlm" and mm_embeds is not None:
            mm = self.mm_proj(mm_embeds.to(self.device).to(x.dtype))
            x = torch.cat([mm, x[:, mm.shape[1]:]], dim=1)
        if self.cfg.family == "encdec":
            x = x + self._sinusoid(tokens.shape[1]).to(x.dtype)
        return ctx.constrain(x, "tokens_bse")

    def forward(self, tokens: torch.Tensor,
                gmm: GroupedMatmul = grouped_matmul, *,
                frames: Optional[torch.Tensor] = None,
                mm_embeds: Optional[torch.Tensor] = None,
                positions_3d: Optional[torch.Tensor] = None,
                remat: bool = True, return_pre_logits: bool = False,
                ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        """tokens ``[B, S]`` -> fp32 logits ``[B, S, V_padded]``, or the
        final-norm hidden states ``[B, S, d]`` when ``return_pre_logits``
        (the chunked loss).  ``frames [B, S_enc, d]`` feed whisper's
        encoder (required for ``encdec``); ``mm_embeds [B, n_mm, d]``
        replace qwen2-vl's first ``n_mm`` token embeddings and
        ``positions_3d [3, B, S]`` give its M-RoPE positions (other configs
        ignore both).  With ``remat``, where gradients are recorded, each
        layer is checkpointed: its activations are recomputed in the
        backward pass (the MoE layers' grouped launches too).  ``ctx``
        hears the reference's constraints (``models.sharding_ctx``): the
        embedding and every layer's output as ``"tokens_bse"``, the
        logits as ``"logits_bsv"``, and the layers' own.

        Raises:
            ValueError: an ``encdec`` config without ``frames``.
        """
        cfg = self.cfg
        if cfg.family == "encdec" and frames is None:
            raise ValueError(f"{cfg.name}: forward needs the encoder's "
                             f"frames")
        x = self._embed_tokens(tokens, mm_embeds, ctx)
        b, s = tokens.shape
        if cfg.mrope and positions_3d is not None:
            positions = positions_3d.to(self.device)
        else:
            positions = torch.arange(s, device=self.device)[None] \
                .expand(b, s)
        enc_out = self.encode(frames, remat, ctx) \
            if cfg.family == "encdec" else None
        for block in self.layers:
            x = ctx.constrain(self._layer(block, remat, x, positions, gmm,
                                          enc_out, ctx), "tokens_bse")
        x = self.final_norm(x)
        if return_pre_logits:
            return x
        return ctx.constrain(self._head(x), "logits_bsv")

    def init_cache(self, batch: int,
                   cache_len: int) -> List[Dict[str, torch.Tensor]]:
        """Per layer, zeros: for an attention layer ``{"k", "v"}`` ``[B,
        S_c, Hkv, D]`` in the compute dtype, ``S_c = cache_len`` for a
        global layer, ``min(cache_len, window_size)`` for a local layer's
        ring; for an ``ssm`` or ``rglru`` layer ``{"conv", "h"}``, the last
        ``K - 1`` raw conv inputs in the compute dtype and the fp32 state
        (``[B, d_in, N]`` and ``[B, rnn_width]``), whatever ``cache_len``;
        for ``encdec``, also ``{"cross_k", "cross_v"}`` zeros ``[B,
        encoder_seq, Hkv, D]`` (:meth:`prime_cross_cache` fills them) and
        the sinusoidal table's ``cache_len`` rows, built here once."""
        cfg = self.cfg

        def zeros(slots):
            return torch.zeros((batch, slots, cfg.num_kv_heads,
                                cfg.head_dim), dtype=self.dtype,
                               device=self.device)

        cache = []
        for block, kind in zip(self.layers, layer_kinds(cfg)):
            if kind not in ATTENTION_KINDS:
                cache.append(block.init_cache(batch, self.dtype))
                continue
            s_c = min(cache_len, cfg.window_size) if kind == "local" \
                else cache_len
            layer = {"k": zeros(s_c), "v": zeros(s_c)}
            if cfg.family == "encdec":
                layer["cross_k"] = zeros(cfg.encoder_seq)
                layer["cross_v"] = zeros(cfg.encoder_seq)
            cache.append(layer)
        if cfg.family == "encdec":
            self._sinusoid(cache_len)
        return cache

    def prime_cross_cache(self, cache: List[Dict[str, torch.Tensor]],
                          enc_out: torch.Tensor
                          ) -> List[Dict[str, torch.Tensor]]:
        """Fill every decoder layer's cross K/V from the encoder's output
        ``[B, S_enc, d]``, in the compute dtype, in place; returns the
        cache."""
        for block, layer in zip(self.layers, cache):
            k, v = block.cross.kv(enc_out)
            layer["cross_k"] = k.to(self.dtype)
            layer["cross_v"] = v.to(self.dtype)
        return cache

    def decode_step(self, cache: List[Dict[str, torch.Tensor]],
                    tokens: torch.Tensor, pos: int,
                    gmm: GroupedMatmul = grouped_matmul, *,
                    positions_3d: Optional[torch.Tensor] = None,
                    ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        """One decode step: tokens ``[B]`` at position ``pos`` (the same for
        the whole batch) -> fp32 logits ``[B, V_padded]``; the cache is
        updated in place.  ``positions_3d [3, B, 1]`` give qwen2-vl's M-RoPE
        positions (otherwise every stream is ``pos``: 1-D RoPE); whisper
        adds row ``pos`` of the sinusoidal table."""
        x = ctx.constrain(self._embed(tokens[:, None]), "tokens_bse")
        b = x.shape[0]
        if self.cfg.family == "encdec":
            x = x + self._sinusoid(pos + 1)[pos].to(x.dtype)
        if self.cfg.mrope and positions_3d is not None:
            positions = positions_3d.to(self.device)
        else:
            positions = torch.full((b, 1), pos, dtype=torch.int64,
                                   device=self.device)
        for block, layer_cache in zip(self.layers, cache):
            x = ctx.constrain(block.decode(x, layer_cache, pos, positions,
                                           gmm, ctx), "tokens_bse")
        return self._head(self.final_norm(x))[:, 0]

    def grouped_launches_per_step(self, train: bool = False,
                                  remat: bool = True) -> int:
        """Grouped-matmul launches on the card per MoE layer times the
        layers: for one ``decode_step`` or ``forward``, two per layer (gate
        and up share one); for one micro-batch of a train step, those two,
        their recompute under ``remat``, and the two input gradients."""
        if not self.cfg.num_experts:
            return 0
        passes = (3 if remat else 2) if train else 1
        return LAUNCHES_PER_LAYER * passes * self.cfg.num_layers


def init_params(cfg: ModelConfig, *, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                dtype: Optional[torch.dtype] = None,
                masters: bool = False) -> LM:
    """A randomly initialised :class:`LM` (see its arguments)."""
    return LM(cfg, device=device, generator=generator, dtype=dtype,
              masters=masters)
