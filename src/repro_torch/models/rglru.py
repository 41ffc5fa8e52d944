"""RG-LRU recurrent block (Griffin / recurrentgemma).

The counterpart of the reference's ``repro.models.rglru``.  A gated linear
recurrence ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)`` with ``a_t =
exp(-c softplus(lam) r_t)``, one fp32 state per channel.  The gates ``r``
and ``i`` come from :data:`NUM_GATE_BLOCKS` diagonal blocks
(:func:`block_diag`).  :func:`rglru_forward` scans chunks of ``chunk``
timesteps (one chunk where the length is not a multiple of it), folding
each chunk's carry into its first element, as ``models.ssm`` does;
:func:`rglru_decode` is the O(1) update.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.sharding_ctx import NO_SHARDING, ShardingCtx

NUM_GATE_BLOCKS = 16
_C = 8.0


class RGLRU(nn.Module):
    """The weights of one RG-LRU block, named as the reference's leaves:
    ``wx`` and ``wy`` (the gelu branch) ``[d, rw]``, ``conv_w`` ``[K,
    rw]``, ``conv_b``, the gate blocks ``w_r`` and ``w_i`` ``[nb, bs,
    bs]``, ``lam`` ``[rw]`` and ``out`` ``[rw, d]``.  ``lam`` stays fp32;
    every other weight is held in ``dtype``, the dtype of its use."""

    def __init__(self, d: int, rw: int, conv: int = 4, *,
                 dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator],
                 trainable: bool = False):
        super().__init__()
        nb = NUM_GATE_BLOCKS
        bs = rw // nb
        kw = dict(dtype=dtype, device=device, generator=generator,
                  trainable=trainable)

        def he(shape, fan_in):
            return L.weight(L.he_init(shape, fan_in, generator=generator,
                                      device=device), dtype, trainable)
        self.wx = L.Dense(d, rw, **kw)
        self.wy = L.Dense(d, rw, **kw)
        self.conv_w = he((conv, rw), conv)
        self.conv_b = L.weight(torch.zeros(rw, device=device), dtype,
                               trainable)
        self.w_r = he((nb, bs, bs), bs)
        self.w_i = he((nb, bs, bs), bs)
        self.lam = L.weight(torch.linspace(0.5, 4.0, rw, device=device),
                            torch.float32, trainable)
        self.out = L.Dense(rw, d, **kw)


def block_diag(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``x [..., rw]`` times the block-diagonal ``w [nb, bs, bs]``, in x's
    dtype."""
    nb, bs, _ = w.shape
    xb = x.reshape(*x.shape[:-1], nb, bs)
    out = torch.einsum("...nb,nbc->...nc", xb, w.to(x.dtype))
    return out.reshape(x.shape)


def gates(p: RGLRU, xb: torch.Tensor):
    """The decay ``a`` and the gated input ``sqrt(1 - a^2) i x``, fp32."""
    r = torch.sigmoid(block_diag(p.w_r, xb).float())
    i = torch.sigmoid(block_diag(p.w_i, xb).float())
    log_a = -_C * F.softplus(p.lam.float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * i \
        * xb.float()
    return a, gated


def rglru_forward(p: RGLRU, x: torch.Tensor, *, chunk: int = 512,
                  ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """x: ``[B, S, d]`` -> ``[B, S, d]``; chunks of ``min(chunk, S)``
    timesteps, or one chunk where ``S`` is not a multiple of that.  The
    conv's output is constrained as ``"ssm_bsdn"``."""
    b, s, _ = x.shape
    branch = F.gelu(p.wy(x), approximate="tanh")
    xb = ctx.constrain(S.causal_conv(p.wx(x), p.conv_w, p.conv_b),
                       "ssm_bsdn")
    ch = min(chunk, s)
    if s % ch:
        ch = s
    h = xb.new_zeros((b, xb.shape[-1]), dtype=torch.float32)
    outs = []
    for c in range(s // ch):
        a, gated = gates(p, xb[:, c * ch:(c + 1) * ch])
        _, hs = S.linear_scan(a, S.fold_carry(a, gated, h))
        h = hs[:, -1]
        outs.append(hs.to(x.dtype))
    return p.out(torch.cat(outs, dim=1) * branch)


def init_rglru_cache(p: RGLRU, batch: int,
                     dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``conv``: the last ``K - 1`` raw inputs of the conv ``[B, K - 1,
    rw]`` in ``dtype`` (the compute dtype); ``h``: the fp32 state ``[B,
    rw]``; both zeros."""
    conv, rw = p.conv_w.shape
    dev = p.conv_w.device
    return {"conv": torch.zeros(batch, conv - 1, rw, dtype=dtype,
                                device=dev),
            "h": torch.zeros(batch, rw, dtype=torch.float32, device=dev)}


def rglru_decode(p: RGLRU, cache: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
    """x: ``[B, 1, d]`` -> (``[B, 1, d]``, the new cache); ``cache`` is not
    changed."""
    branch = F.gelu(p.wy(x), approximate="tanh")
    xb_raw = p.wx(x)                                         # [B,1,rw]
    xb = S.causal_conv(xb_raw, p.conv_w, p.conv_b, state=cache["conv"])
    new_conv = torch.cat([cache["conv"][:, 1:],
                          xb_raw.to(cache["conv"].dtype)], dim=1)
    a, gated = gates(p, xb[:, 0])
    h = a * cache["h"] + gated
    out = p.out(h[:, None, :].to(x.dtype) * branch)
    return out, {"conv": new_conv, "h": h}
