"""Mamba-1 selective SSM block (falcon-mamba-7b).

The counterpart of the reference's ``repro.models.ssm``.  The recurrence
``h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t`` runs in fp32:

* :func:`mamba_forward` (training and prefill) cuts the sequence into
  chunks of ``chunk`` timesteps, materialises the ``[B, ch, d_in, N]``
  discretised tensors of one chunk at a time, folds the previous chunk's
  last state into the chunk's first element and runs :func:`linear_scan`
  inside the chunk: ``ceil(log2 ch)`` doubling steps of
  :func:`ssm_combine`, a few large kernels per step instead of one per
  timestep;
* :func:`mamba_decode` is the O(1) update of one token against a cache of
  the last ``K - 1`` raw conv inputs and the fp32 state.

:func:`causal_conv` and :func:`ssm_combine` are shared with
``models.rglru``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.models.sharding_ctx import NO_SHARDING, ShardingCtx


def causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv1d of kernel size ``K``, unrolled.

    u: ``[B, S, C]``; w: ``[K, C]``; b: ``[C]``; state: ``[B, K - 1, C]``,
    the ``K - 1`` inputs before ``u`` (None: zeros).  As the reference
    does, the sum starts from term 0 and adds terms 1 .. K-1 and then the
    bias, each product and sum rounded to u's dtype; a ``conv1d`` would
    accumulate in fp32 and round once, which is another result in bf16.
    """
    K, S = w.shape[0], u.shape[1]
    if state is None:
        up = F.pad(u, (0, 0, K - 1, 0))
    else:
        up = torch.cat([state.to(u.dtype), u], dim=1)
    out = up[:, 0:S] * w[0].to(u.dtype)
    for i in range(1, K):
        out = out + up[:, i:i + S] * w[i].to(u.dtype)
    return out + b.to(u.dtype)


def ssm_combine(e1, e2):
    """The associative combine of ``h -> a h + b`` maps: ``e1`` then
    ``e2``."""
    a1, b1 = e1
    a2, b2 = e2
    return a2 * a1, a2 * b1 + b2


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                dim: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of :func:`ssm_combine` along ``dim``: the second
    output is ``h_t = a_t h_{t-1} + b_t`` from ``h_{-1} = 0``.

    ``ceil(log2 n)`` doubling steps: step ``k`` combines element ``t - k``
    into element ``t`` for every ``t >= k`` at once, so each element's
    products are associated in at most ``ceil(log2 n)`` levels (the
    reference's ``lax.associative_scan`` associates them in another
    order of the same depth)."""
    n, k = a.shape[dim], 1
    while k < n:
        earlier = (a.narrow(dim, 0, n - k), b.narrow(dim, 0, n - k))
        later = (a.narrow(dim, k, n - k), b.narrow(dim, k, n - k))
        na, nb = ssm_combine(earlier, later)
        a = torch.cat([a.narrow(dim, 0, k), na], dim)
        b = torch.cat([b.narrow(dim, 0, k), nb], dim)
        k *= 2
    return a, b


def fold_carry(a: torch.Tensor, b: torch.Tensor,
               h: torch.Tensor) -> torch.Tensor:
    """``b`` with the carried state folded into its first timestep:
    ``b[:, 0] + a[:, 0] * h``, so that the chunk's scan continues from
    ``h``."""
    return torch.cat([b[:, :1] + a[:, :1] * h[:, None], b[:, 1:]], dim=1)


class Mamba(nn.Module):
    """The weights of one mamba block, named as the reference's leaves:
    ``in_proj`` ``[d, 2 d_in]``, ``conv_w`` ``[K, d_in]``, ``conv_b``,
    ``x_proj`` ``[d_in, dt_rank + 2 N]``, ``dt_proj`` ``[dt_rank, d_in]``
    with a bias, ``A_log`` ``[d_in, N]``, ``D`` and ``out_proj`` ``[d_in,
    d]``.  ``A_log`` stays fp32 (the reference reads it in fp32); every
    other weight is held in ``dtype``, the dtype of its use."""

    def __init__(self, d: int, state: int, conv: int, expand: int, *,
                 dtype: torch.dtype, device: torch.device,
                 generator: Optional[torch.Generator],
                 trainable: bool = False):
        super().__init__()
        d_in = expand * d
        dt_rank = max(d // 16, 1)
        kw = dict(dtype=dtype, device=device, generator=generator,
                  trainable=trainable)
        self.in_proj = L.Dense(d, 2 * d_in, **kw)
        self.conv_w = L.weight(L.he_init((conv, d_in), fan_in=conv,
                                         generator=generator, device=device),
                               dtype, trainable)
        self.conv_b = L.weight(torch.zeros(d_in, device=device), dtype,
                               trainable)
        self.x_proj = L.Dense(d_in, dt_rank + 2 * state, **kw)
        self.dt_proj = L.Dense(dt_rank, d_in, bias=True, **kw)
        a = torch.arange(1, state + 1, dtype=torch.float32, device=device)
        self.A_log = L.weight(torch.log(a)[None, :].repeat(d_in, 1),
                              torch.float32, trainable)
        self.D = L.weight(torch.ones(d_in, device=device), dtype, trainable)
        self.out_proj = L.Dense(d_in, d, **kw)


def discretize(p: Mamba, u: torch.Tensor):
    """u: ``[..., d_in]`` -> ``(dA, dBu, C)`` in fp32, the state dim
    appended: ``dt = softplus(dt_proj(x_proj(u)[:dt_rank]))``, ``dA =
    exp(dt A)`` with ``A = -exp(A_log)``, ``dBu = dt u B``."""
    dt_rank = p.dt_proj.kernel.shape[0]
    state = p.A_log.shape[1]
    xdbc = p.x_proj(u)
    dt_r = xdbc[..., :dt_rank]
    bc = xdbc[..., dt_rank:dt_rank + state].float()
    cc = xdbc[..., dt_rank + state:].float()
    dt = F.softplus(p.dt_proj(dt_r).float())                 # [..., d_in]
    a = -torch.exp(p.A_log.float())                          # [d_in, N]
    da = torch.exp(dt[..., None] * a)                        # [..., d_in, N]
    dbu = (dt * u.float())[..., None] * bc[..., None, :]
    return da, dbu, cc


def mamba_forward(p: Mamba, x: torch.Tensor, *, chunk: int = 256,
                  ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """x: ``[B, S, d]`` -> ``[B, S, d]``.  ``S`` must be a multiple of
    ``min(chunk, S)``.  The conv's output is constrained as
    ``"ssm_bsdn"``."""
    B, S, _ = x.shape
    ch = min(chunk, S)
    assert S % ch == 0
    u, z = torch.chunk(p.in_proj(x), 2, dim=-1)
    u = ctx.constrain(F.silu(causal_conv(u, p.conv_w, p.conv_b)),
                      "ssm_bsdn")
    h = u.new_zeros((B, u.shape[-1], p.A_log.shape[1]), dtype=torch.float32)
    ys = []
    for c in range(S // ch):
        da, dbu, cc = discretize(p, u[:, c * ch:(c + 1) * ch])
        _, hs = linear_scan(da, fold_carry(da, dbu, h))
        h = hs[:, -1]
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, cc).to(x.dtype))
    y = torch.cat(ys, dim=1)
    y = y + u * p.D.to(x.dtype)
    y = y * F.silu(z)
    return p.out_proj(y)


def init_mamba_cache(p: Mamba, batch: int,
                     dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """``conv``: the last ``K - 1`` raw conv inputs ``[B, K - 1, d_in]`` in
    ``dtype`` (the compute dtype); ``h``: the fp32 state ``[B, d_in,
    N]``; both zeros."""
    conv, d_in = p.conv_w.shape
    dev = p.conv_w.device
    return {"conv": torch.zeros(batch, conv - 1, d_in, dtype=dtype,
                                device=dev),
            "h": torch.zeros(batch, d_in, p.A_log.shape[1],
                             dtype=torch.float32, device=dev)}


def mamba_decode(p: Mamba, cache: Dict[str, torch.Tensor],
                 x: torch.Tensor) -> Tuple[torch.Tensor,
                                           Dict[str, torch.Tensor]]:
    """x: ``[B, 1, d]`` -> (``[B, 1, d]``, the new cache); ``cache`` is not
    changed."""
    u, z = torch.chunk(p.in_proj(x), 2, dim=-1)              # [B,1,d_in]
    conv_in = cache["conv"]
    u_act = F.silu(causal_conv(u, p.conv_w, p.conv_b, state=conv_in))
    new_conv = torch.cat([conv_in[:, 1:], u.to(conv_in.dtype)], dim=1)
    da, dbu, cc = discretize(p, u_act[:, 0])                 # [B,d_in,N]
    h = da * cache["h"] + dbu
    y = torch.einsum("bdn,bn->bd", h, cc)[:, None, :].to(x.dtype)
    y = y + u_act * p.D.to(x.dtype)
    y = y * F.silu(z)
    return p.out_proj(y), {"conv": new_conv, "h": h}
