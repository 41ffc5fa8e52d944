"""Shared building blocks: norms, dense layers, MLPs, rotary embeddings
(with qwen2-vl's M-RoPE), whisper's sinusoidal positions, embeddings and
their initialisers.

The counterpart of the reference's ``repro.models.layers``.  The plain
functions take tensors; the modules hold their weights and call them.
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rmsnorm(x, self.scale, self.eps)


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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x, self.scale, self.bias, self.eps)


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
        variant: str, w_up: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``swiglu`` / ``geglu``: ``act(x @ w_in) * (x @ w_up) @ w_out`` with
    SiLU / tanh-GELU; ``gelu``: ``gelu(x @ w_in) @ w_out`` (``w_up``
    unused)."""
    h = dense(x, w_in)
    h = F.silu(h) if variant == "swiglu" else F.gelu(h, approximate="tanh")
    if variant in ("swiglu", "geglu"):
        h = h * dense(x, w_up)
    return dense(h, w_out)


class MLP(nn.Module):
    """The dense FFN: ``wi_gate``, ``wi_up``, ``wo`` (gated variants) or
    ``wi``, ``wo`` (``gelu``)."""

    def __init__(self, d: int, d_ff: int, variant: str, *,
                 dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator],
                 trainable: bool = False):
        super().__init__()
        self.variant = variant
        kw = dict(dtype=dtype, device=device, generator=generator,
                  trainable=trainable)
        if variant in ("swiglu", "geglu"):
            self.wi_gate = Dense(d, d_ff, **kw)
            self.wi_up = Dense(d, d_ff, **kw)
        else:
            self.wi = Dense(d, d_ff, **kw)
        self.wo = Dense(d_ff, d, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.variant in ("swiglu", "geglu"):
            return mlp(x, self.wi_gate.kernel, self.wo.kernel, self.variant,
                       self.wi_up.kernel)
        return mlp(x, self.wi.kernel, self.wo.kernel, self.variant)


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
