"""Shared building blocks: norms, dense layers, MLPs, rotary embeddings
(with qwen2-vl's M-RoPE), whisper's sinusoidal positions, embeddings and
their initialisers.

The counterpart of the reference's ``repro.models.layers``.  The plain
functions take tensors; the modules hold their weights and call them.

In a partitioned step (a ``ShardingCtx`` with a ``ProcessMesh``,
``models.sharding_ctx``) each module holds its block of every weight, as
``launch.sharding.param_pspecs`` splits it (``LM.shard``), and the
Megatron points live here: :func:`mesh_param` (a block as this rank uses
it: FSDP-gathered over ``"data"`` in the compute dtype after the cast,
its gradient summed over the ranks it is replicated on), :func:`sp_enter`
and :func:`sp_exit` (the sequence-parallel residual stream: all-gathered
along the sequence over ``"model"`` at a sublayer's entry, its
row-parallel partial sums reduce-scattered at the exit), the
column-/row-parallel MLP (:meth:`MLP.forward`), the vocab-split
embedding (:func:`embed_mesh`), and the decode step's column- and
row-parallel projections of one token (:func:`column_gather`,
:func:`row_dense`, :func:`local_dense`).  Norms stay local: every rank
holds the whole ``d_model`` of its tokens.
Compute runs in the model's compute dtype (bf16, ``models.model``) with
fp32 statistics in the norms and fp32 rotary angles.  The reference keeps
fp32 masters and casts each weight to the compute dtype where it is used.
A module here holds each weight in the ``dtype`` it is given: for serving,
the dtype it is used in (a matrix in the compute dtype, a norm scale in
fp32), cast once when it is made, which is the same tensor bit for bit as
the reference's per-use cast; for training, fp32 masters that are
``trainable`` and cast at each use, as the reference does.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import comm
from repro_torch.launch import sharding as SH
from repro_torch.models.sharding_ctx import NO_SHARDING, ShardingCtx


def he_init(shape, fan_in: Optional[int] = None, *,
            generator: Optional[torch.Generator],
            device: torch.device) -> torch.Tensor:
    """``N(0, 1/fan_in)`` in fp32 (``fan_in`` defaults to ``shape[0]``),
    drawn on ``device`` from ``generator``; on the ``meta`` device, an
    empty tensor of that shape."""
    return normal(shape, 1.0 / math.sqrt(max(fan_in or shape[0], 1)),
                  generator=generator, device=device)


def normal(shape, std: float, *, generator: Optional[torch.Generator],
           device: torch.device) -> torch.Tensor:
    """``N(0, std**2)`` in fp32 on ``device`` (empty on ``meta``)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device=device)
    return torch.randn(shape, generator=generator, device=device) * std


def weight(t: torch.Tensor, dtype: torch.dtype,
           trainable: bool = False) -> nn.Parameter:
    """``t`` in ``dtype`` as a parameter: a trainable master, or a frozen
    weight the serving path reads."""
    return nn.Parameter(t.to(dtype), requires_grad=trainable)


# ---------------------------------------------------------------------------
# Norms.
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with the ``(1 + scale)`` parameterisation; fp32 statistics,
    the result in x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((1.0 + scale) * (xf * torch.rsqrt(var + eps))).to(x.dtype)


class RMSNorm(nn.Module):
    """``scale`` starts at zero (the identity gain) and stays fp32."""

    def __init__(self, d: int, eps: float, *, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        self.eps = eps
        self.scale = weight(torch.zeros(d, device=device), torch.float32,
                            trainable)

    def forward(self, x: torch.Tensor,
                ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        scale = self.scale if ctx.process_mesh is None else \
            mesh_param(self, "scale", ctx)
        return rmsnorm(x, scale, self.eps)


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with fp32 statistics (the biased variance), the result in
    x's dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
    return (scale * ((xf - mu) * torch.rsqrt(var + eps)) + bias).to(x.dtype)


class LayerNorm(nn.Module):
    """The ``encdec`` family's norm: fp32 ``scale`` (ones) and ``bias``
    (zeros).  Its eps is 1e-5, the reference's ``layernorm`` default, which
    it uses whatever ``cfg.norm_eps`` says."""

    def __init__(self, d: int, eps: float = 1e-5, *, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        self.eps = eps
        self.scale = weight(torch.ones(d, device=device), torch.float32,
                            trainable)
        self.bias = weight(torch.zeros(d, device=device), torch.float32,
                           trainable)

    def forward(self, x: torch.Tensor,
                ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        if ctx.process_mesh is None:
            return layernorm(x, self.scale, self.bias, self.eps)
        return layernorm(x, mesh_param(self, "scale", ctx),
                         mesh_param(self, "bias", ctx), self.eps)


# ---------------------------------------------------------------------------
# Partitioned steps: blocks, and the sequence-parallel residual stream.
# ---------------------------------------------------------------------------

def mesh_param(module: nn.Module, name: str, ctx: ShardingCtx,
               dtype: Optional[torch.dtype] = None,
               keep: tuple = ("model",)) -> torch.Tensor:
    """``module``'s block of weight ``name`` as this rank uses it in a
    partitioned step.

    The block (split by ``module.specs[name]``, ``LM.shard``) is marked as
    used on every rank of the axes it is replicated over
    (``comm.pvary``: its gradient is the sum of theirs), cast to ``dtype``
    (default: kept), and all-gathered over every axis of its spec not in
    ``keep``: the FSDP gather over ``"data"``, in the compute dtype after
    the cast (half the bytes, the same values), and over ``"model"`` too
    where the caller needs the weight whole.
    """
    mesh = ctx.process_mesh
    spec = module.specs[name]
    w = getattr(module, name)
    rep = SH.replicated_axes(spec, mesh)
    if rep:
        w = comm.pvary(w, rep, mesh=mesh)
    if dtype is not None:
        w = w.to(dtype)
    for dim, entry in enumerate(spec):
        for a in reversed(SH.axes_of(entry)):
            if a not in keep and mesh.shape[a] > 1:
                w = comm.all_gather(w, a, dim=dim, tiled=True, mesh=mesh)
    return w


def sequence_parallel(ctx: ShardingCtx) -> bool:
    """Whether the residual stream is split along the sequence over
    ``"model"`` (the rule of ``"tokens_bse"``; not where the axis does
    not divide the sequence)."""
    return ctx.parts("tokens_bse", 1) > 1


def sp_enter(x: torch.Tensor, ctx: ShardingCtx) -> torch.Tensor:
    """A sublayer's entry: this rank's ``[B, S / tp, d]`` block of the
    residual stream all-gathered along the sequence over ``"model"`` (the
    stream as it is where it is not split)."""
    if not sequence_parallel(ctx):
        return x
    return comm.all_gather(x, "model", dim=1, tiled=True,
                           mesh=ctx.process_mesh)


def sp_exit(y: torch.Tensor, ctx: ShardingCtx,
            partial: bool) -> torch.Tensor:
    """A sublayer's exit: ``y [B, S, d]``, this rank's row-parallel
    partial sums (``partial``) or the whole value on every rank of
    ``"model"``, to the residual stream's layout.  Partial sums are
    ``psum_scatter``-ed along the sequence, or ``psum``-med where the
    stream is not split; a whole value keeps this rank's block of the
    sequence."""
    mesh = ctx.process_mesh
    tp = mesh.shape["model"]
    if sequence_parallel(ctx):
        if partial:
            return comm.psum_scatter(y, "model", scatter_dimension=1,
                                     tiled=True, mesh=mesh)
        n = y.shape[1] // tp
        return y.narrow(1, mesh.axis_index("model") * n, n)
    if partial and tp > 1:
        return comm.psum(y, "model", mesh=mesh)
    return y


def splits(module: nn.Module, name: str, dim: int,
           ctx: ShardingCtx) -> bool:
    """Whether ``module``'s block of weight ``name`` is split over
    ``"model"`` along ``dim`` (its spec names the axis and the axis has
    more than one rank)."""
    return "model" in SH.axes_of(module.specs[name][dim]) and \
        ctx.process_mesh.shape["model"] > 1


def local_dense(x: torch.Tensor, module: nn.Module,
                ctx: ShardingCtx) -> torch.Tensor:
    """``x`` through this rank's block of a :class:`Dense` (its kernel and
    bias gathered over the data axes, still split over ``"model"``): a
    column-parallel layer's columns of the product, or a row-parallel
    layer's partial sums of ``x``'s matching block."""
    bias = None if module.bias is None else \
        mesh_param(module, "bias", ctx, x.dtype)
    return dense(x, mesh_param(module, "kernel", ctx, x.dtype), bias)


def column_gather(x: torch.Tensor, module: nn.Module,
                  ctx: ShardingCtx) -> torch.Tensor:
    """``x`` through a column-parallel :class:`Dense`, every column on every
    rank: this rank's columns all-gathered over ``"model"`` (in decode the
    output is one token's, small beside the kernel)."""
    y = local_dense(x, module, ctx)
    if splits(module, "kernel", 1, ctx):
        y = comm.all_gather(y, "model", dim=-1, tiled=True,
                            mesh=ctx.process_mesh)
    return y


def row_dense(x: torch.Tensor, module: nn.Module,
              ctx: ShardingCtx) -> torch.Tensor:
    """A row-parallel :class:`Dense` (no bias) of ``x`` whole on every rank:
    this rank's block of ``x``'s last dim times its rows of the kernel,
    ``psum``-med over ``"model"``; the whole product where the kernel is
    not split."""
    kernel = mesh_param(module, "kernel", ctx, x.dtype)
    if not splits(module, "kernel", 0, ctx):
        return x @ kernel
    n = kernel.shape[0]
    lo = ctx.process_mesh.axis_index("model") * n
    return comm.psum(x[..., lo:lo + n] @ kernel, "model",
                     mesh=ctx.process_mesh)


# ---------------------------------------------------------------------------
# Dense / MLP.
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, kernel: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ kernel (+ bias)`` in x's dtype; ``kernel`` is ``[d_in,
    d_out]``, as the reference stores it."""
    y = x @ kernel.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype)
    return y


class Dense(nn.Module):
    """``kernel`` ``[d_in, d_out]`` (He init) and an optional zero bias, both
    in ``dtype``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator],
                 trainable: bool = False):
        super().__init__()
        self.kernel = weight(he_init((d_in, d_out), generator=generator,
                                     device=device), dtype, trainable)
        self.bias = weight(torch.zeros(d_out, device=device), dtype,
                           trainable) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.kernel, self.bias)


def mlp(x: torch.Tensor, w_in: torch.Tensor, w_out: torch.Tensor,
        variant: str, w_up: Optional[torch.Tensor] = None,
        ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """``swiglu`` / ``geglu``: ``act(x @ w_in) * (x @ w_up) @ w_out`` with
    SiLU / tanh-GELU; ``gelu``: ``gelu(x @ w_in) @ w_out`` (``w_up``
    unused).  A gated variant given ``w_up=None`` takes ``w_in`` as the
    fused ``[d, 2 * d_ff]`` kernel, the gate's columns first.  The hidden
    activation is constrained as ``"ffn_bsf"``."""
    h = dense(x, w_in)
    if variant in ("swiglu", "geglu"):
        if w_up is None:
            h, up = torch.chunk(h, 2, dim=-1)
        else:
            up = dense(x, w_up)
        act = F.silu(h) if variant == "swiglu" else \
            F.gelu(h, approximate="tanh")
        h = act * up
    else:
        h = F.gelu(h, approximate="tanh")
    return dense(ctx.constrain(h, "ffn_bsf"), w_out)


class MLP(nn.Module):
    """The dense FFN: ``wi_gate``, ``wi_up``, ``wo`` (gated variants),
    ``wi_fused`` (``[d, 2 * d_ff]``, the gate's and up's columns side by
    side) and ``wo`` (gated and ``fused``), or ``wi``, ``wo``
    (``gelu``)."""

    def __init__(self, d: int, d_ff: int, variant: str, *,
                 dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator],
                 trainable: bool = False, fused: bool = False):
        super().__init__()
        self.variant = variant
        kw = dict(dtype=dtype, device=device, generator=generator,
                  trainable=trainable)
        if variant in ("swiglu", "geglu"):
            if fused:
                self.wi_fused = Dense(d, 2 * d_ff, **kw)
            else:
                self.wi_gate = Dense(d, d_ff, **kw)
                self.wi_up = Dense(d, d_ff, **kw)
        else:
            self.wi = Dense(d, d_ff, **kw)
        self.wo = Dense(d_ff, d, **kw)

    def forward(self, x: torch.Tensor,
                ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
        """``x [B, S, d]`` -> ``[B, S, d]``; in a partitioned step, this
        rank's residual block in and out (:meth:`forward_mesh`)."""
        if ctx.process_mesh is not None:
            return self.forward_mesh(x, ctx)
        if hasattr(self, "wi_fused"):
            return mlp(x, self.wi_fused.kernel, self.wo.kernel,
                       self.variant, ctx=ctx)
        if self.variant in ("swiglu", "geglu"):
            return mlp(x, self.wi_gate.kernel, self.wo.kernel, self.variant,
                       self.wi_up.kernel, ctx=ctx)
        return mlp(x, self.wi.kernel, self.wo.kernel, self.variant, ctx=ctx)

    def forward_mesh(self, x: torch.Tensor,
                     ctx: ShardingCtx) -> torch.Tensor:
        """Megatron's MLP on this rank's block ``x`` of the residual
        stream: the sequence gathered, the input projections
        column-parallel (``d_ff / tp`` columns), ``wo`` row-parallel, its
        partial sums reduce-scattered back along the sequence.  Where
        ``"model"`` does not divide ``d_ff``, or for the fused kernel
        (whose blocks would cut the gate's columns from the up's), every
        rank computes the whole FFN on the gathered weights and keeps its
        block.  In decode (one token, no ``"ffn_bsf"`` rule) the split
        follows ``wo``'s spec, and the exit is a ``psum``."""
        split = (ctx.parts("ffn_bsf", 2) > 1 if "ffn_bsf" in ctx.rules
                 else splits(self.wo, "kernel", 0, ctx)) and \
            not hasattr(self, "wi_fused")
        keep = ("model",) if split else ()

        def w(dense):
            return mesh_param(dense, "kernel", ctx, x.dtype, keep)

        h = sp_enter(x, ctx)
        if hasattr(self, "wi_fused"):
            # Whole on every rank: not the "ffn_bsf" rule's layout.
            y = mlp(h, w(self.wi_fused), w(self.wo), self.variant)
        elif self.variant in ("swiglu", "geglu"):
            y = mlp(h, w(self.wi_gate), w(self.wo), self.variant,
                    w(self.wi_up), ctx=ctx)
        else:
            y = mlp(h, w(self.wi), w(self.wo), self.variant, ctx=ctx)
        return sp_exit(y, ctx, partial=split)


# ---------------------------------------------------------------------------
# Rotary position embeddings.
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device: torch.device) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotate the two halves of each head (not interleaved pairs).

    x: ``[B, S, H, D]``; positions: ``[B, S]`` integers.  Angles and the
    rotation are fp32; the result is in x's dtype.
    """
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # [D/2]
    angles = positions[..., None].float() * freqs               # [B,S,D/2]
    return _rotate(x, angles)


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate the halves of x ``[B, S, H, D]`` by ``angles`` ``[B, S,
    D/2]`` in fp32; the result in x's dtype."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


#: qwen2-vl's M-RoPE: the share of the D/2 frequency slots each position
#: stream (temporal, height, width) rotates.
MROPE_SECTION_FRACTIONS = (0.25, 0.375, 0.375)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor,
                theta: float) -> torch.Tensor:
    """qwen2-vl's multimodal RoPE.

    x: ``[B, S, H, D]``; positions_3d: ``[3, B, S]`` (temporal, height,
    width ids).  The D/2 frequency slots are cut into three consecutive
    sections (:data:`MROPE_SECTION_FRACTIONS`), each rotated by its own
    position stream.
    """
    half = x.shape[-1] // 2
    freqs = rope_frequencies(x.shape[-1], theta, x.device)      # [half]
    sec_t = int(half * MROPE_SECTION_FRACTIONS[0])
    sec_h = int(half * MROPE_SECTION_FRACTIONS[1])
    slot = torch.arange(half, device=x.device)
    which = (slot >= sec_t).long() + (slot >= sec_t + sec_h).long()
    pos = positions_3d.to(x.device).float()[which]            # [half,B,S]
    return _rotate(x, pos.permute(1, 2, 0) * freqs)


def sinusoidal_positions(seq: int, d: int,
                         device: Optional[torch.device] = None
                         ) -> torch.Tensor:
    """Whisper's fixed sinusoidal position table ``[seq, d]`` in fp32: the
    sines of ``pos / 10000**(2i/d)`` for ``i < d/2``, then the cosines."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)


# ---------------------------------------------------------------------------
# Embedding.
# ---------------------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor, scale: bool = False,
          dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Rows of ``table`` cast to ``dtype`` (default the table's), times
    ``sqrt(d_model)`` rounded to that dtype when ``scale`` (gemma).  The
    rows are gathered before the cast, which gives the reference's
    cast-then-gather bit for bit without casting the whole table; the
    gradient of an fp32 table then sums a repeated token's rows in fp32,
    where the reference sums them in ``dtype``."""
    x = table[tokens].to(dtype or table.dtype)
    if scale:
        x = x * torch.tensor(math.sqrt(table.shape[1]), dtype=x.dtype,
                             device=x.device)
    return x


def embed_mesh(module: nn.Module, tokens: torch.Tensor, ctx: ShardingCtx,
               scale: bool, dtype: torch.dtype) -> torch.Tensor:
    """The embedding in a partitioned step: this rank's block of the
    residual stream for the tokens ``[B, S]`` of its data shard.  With the
    table split over the vocab (``"model"``), each rank looks up the
    tokens its rows hold, zeros elsewhere, and the partial rows are
    reduce-scattered along the sequence, or ``psum``-med where the stream
    is not split (decode; exactly one rank adds a nonzero row, so the sum
    is exact); else the whole lookup keeps its block."""
    table = mesh_param(module, "table", ctx)
    if "model" not in SH.spec_axes(module.specs["table"]) or \
            ctx.process_mesh.shape["model"] == 1:
        return sp_exit(embed(table, tokens, scale, dtype), ctx,
                       partial=False)
    rows = table.shape[0]
    local = tokens - ctx.process_mesh.axis_index("model") * rows
    inside = (local >= 0) & (local < rows)
    x = embed(table, local.clamp(0, rows - 1), scale, dtype)
    return sp_exit(torch.where(inside[..., None], x, 0.0), ctx,
                   partial=True)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Logits through the tied table: ``[.., d] -> [.., V]``."""
    return x @ table.to(x.dtype).T


class Embedding(nn.Module):
    """``table`` ``[V_padded, d]``, ``N(0, 0.02**2)``, in ``dtype``."""

    def __init__(self, vocab: int, d: int, *, dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator],
                 trainable: bool = False):
        super().__init__()
        self.table = weight(normal((vocab, d), 0.02, generator=generator,
                                   device=device), dtype, trainable)
