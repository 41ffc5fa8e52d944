"""Mamba-1 selective SSM block (falcon-mamba-7b).

The counterpart of the reference's ``repro.models.ssm``.  The recurrence
``h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t`` runs in fp32:

* :func:`mamba_forward` (training and prefill; in a partitioned step on
  this rank's channels) cuts the sequence into
  chunks of ``chunk`` timesteps, materialises the ``[B, ch, d_in, N]``
  discretised tensors of one chunk at a time, folds the previous chunk's
  last state into the chunk's first element and runs :func:`linear_scan`
  inside the chunk: ``ceil(log2 ch)`` doubling steps of
  :func:`ssm_combine`, a few large kernels per step instead of one per
  timestep;
* :func:`mamba_decode` is the O(1) update of one token against a cache of
  the last ``K - 1`` raw conv inputs and the fp32 state;
  :func:`mamba_decode_mesh` is the same on a rank's block of the
  channels, in the serve step over a mesh.

:func:`causal_conv` and :func:`ssm_combine` are shared with
``models.rglru``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import comm
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


def discretize(p: Mamba, u: torch.Tensor,
               ctx: ShardingCtx = NO_SHARDING):
    """u: ``[..., d_in]`` -> ``(dA, dBu, C)`` in fp32, the state dim
    appended: ``dt = softplus(dt_proj(x_proj(u)[:dt_rank]))``, ``dA =
    exp(dt A)`` with ``A = -exp(A_log)``, ``dBu = dt u B``.

    In a partitioned step (``ctx`` with a process mesh) ``u`` holds this
    rank's channels: ``x_proj`` is row-parallel (its partial sums
    ``psum``-med over ``"model"``, so ``dt_r``, B and C are whole),
    ``dt_proj``, ``A_log`` and the outputs are on the channel block."""
    state = p.A_log.shape[1]
    if ctx.process_mesh is None:
        xdbc = p.x_proj(u)
        a_log = p.A_log
    else:
        xdbc = L.local_dense(u, p.x_proj, ctx)
        if L.splits(p.x_proj, "kernel", 0, ctx):
            xdbc = comm.psum(xdbc, "model", mesh=ctx.process_mesh)
        a_log = L.mesh_param(p, "A_log", ctx)
    dt_rank = xdbc.shape[-1] - 2 * state
    dt_r = xdbc[..., :dt_rank]
    bc = xdbc[..., dt_rank:dt_rank + state].float()
    cc = xdbc[..., dt_rank + state:].float()
    dt_lin = p.dt_proj(dt_r) if ctx.process_mesh is None else \
        L.local_dense(dt_r, p.dt_proj, ctx)
    dt = F.softplus(dt_lin.float())                          # [..., d_in]
    a = -torch.exp(a_log.float())                            # [d_in, N]
    da = torch.exp(dt[..., None] * a)                        # [..., d_in, N]
    dbu = (dt * u.float())[..., None] * bc[..., None, :]
    return da, dbu, cc


def mamba_forward(p: Mamba, x: torch.Tensor, *, chunk: int = 256,
                  ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """x: ``[B, S, d]`` -> ``[B, S, d]``.  ``S`` must be a multiple of
    ``min(chunk, S)``.  The conv's output is constrained as
    ``"ssm_bsdn"``.

    In a partitioned step (``ctx`` with a process mesh; ``p`` holds this
    rank's blocks, ``LM.shard``) ``x`` is this rank's block of the
    residual stream's norm and so is the output: the sequence is gathered
    (``models.layers.sp_enter``), ``u`` and ``z`` are the rank's channels
    (:func:`in_proj_channels`), the conv, :func:`discretize`, the scan and
    ``D`` run on them, and ``out_proj`` is row-parallel, its partial sums
    reduce-scattered back along the sequence (``sp_exit``).  Where
    ``"model"`` does not split the channels, every rank computes all of
    them and keeps its block."""
    mesh = ctx.process_mesh
    if mesh is None:
        u, z = torch.chunk(p.in_proj(x), 2, dim=-1)
        conv_w, conv_b, d_skip, full = p.conv_w, p.conv_b, p.D, None
    else:
        x = L.sp_enter(x, ctx)
        u, z = in_proj_channels(p, x, ctx)
        conv_w, conv_b, d_skip = (L.mesh_param(p, n, ctx)
                                  for n in ("conv_w", "conv_b", "D"))
        tp = mesh.shape["model"] if L.splits(p, "conv_w", -1, ctx) else 1
        full = (ctx.dims["b"], x.shape[1], u.shape[-1] * tp)
    B, S, _ = x.shape
    ch = min(chunk, S)
    assert S % ch == 0
    u = ctx.constrain(F.silu(causal_conv(u, conv_w, conv_b)), "ssm_bsdn",
                      full)
    h = u.new_zeros((B, u.shape[-1], p.A_log.shape[1]), dtype=torch.float32)
    ys = []
    for c in range(S // ch):
        da, dbu, cc = discretize(p, u[:, c * ch:(c + 1) * ch], ctx)
        _, hs = linear_scan(da, fold_carry(da, dbu, h))
        h = hs[:, -1]
        ys.append(torch.einsum("bsdn,bsn->bsd", hs, cc).to(x.dtype))
    y = torch.cat(ys, dim=1)
    y = y + u * d_skip.to(x.dtype)
    y = y * F.silu(z)
    if mesh is None:
        return p.out_proj(y)
    return L.sp_exit(L.local_dense(y, p.out_proj, ctx), ctx,
                     partial=L.splits(p.out_proj, "kernel", 0, ctx))


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


def channel_block(y: torch.Tensor, module: nn.Module, name: str,
                  ctx: ShardingCtx) -> torch.Tensor:
    """This rank's block of the last dim of ``y`` (every channel) where
    weight ``name`` of ``module`` splits the channels over ``"model"``
    (its last dim), else ``y``."""
    if not L.splits(module, name, -1, ctx):
        return y
    c = getattr(module, name).shape[-1]
    lo = ctx.process_mesh.axis_index("model") * c
    return y[..., lo:lo + c]


def in_proj_channels(p: Mamba, x: torch.Tensor, ctx: ShardingCtx):
    """``u`` and ``z`` of ``x`` on this rank's channels: ``in_proj``'s
    block of columns is contiguous (at ``tp = 2`` one rank holds all of
    ``u``, the other all of ``z``), so its output is all-gathered over
    ``"model"`` and the rank takes its channels of each half."""
    u, z = torch.chunk(L.column_gather(x, p.in_proj, ctx), 2, dim=-1)
    return (channel_block(u, p, "conv_w", ctx),
            channel_block(z, p, "conv_w", ctx))


def mamba_decode_mesh(p: Mamba, cache: Dict[str, torch.Tensor],
                      x: torch.Tensor, ctx: ShardingCtx
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`mamba_decode` on this rank's ``d_in / tp`` channels, in the
    serve step over a mesh: ``p`` holds this rank's blocks
    (``LM.shard``), ``cache`` its ``conv [B, K - 1, d_in / tp]`` and ``h
    [B, d_in / tp, N]`` blocks; x ``[B, 1, d]`` is whole on every rank of
    ``"model"``, and so is the output.

    ``u`` and ``z`` come from :func:`in_proj_channels`, ``dt``, B and C
    from :func:`discretize` on the mesh, and ``out_proj`` is row-parallel
    with a ``psum``.  Where ``"model"`` does not
    split the channels, every rank computes all of them."""
    mesh = ctx.process_mesh
    u, z = in_proj_channels(p, x, ctx)
    conv_in = cache["conv"]
    u_act = F.silu(causal_conv(u, L.mesh_param(p, "conv_w", ctx),
                               L.mesh_param(p, "conv_b", ctx),
                               state=conv_in))
    new_conv = torch.cat([conv_in[:, 1:], u.to(conv_in.dtype)], dim=1)
    da, dbu, cc = discretize(p, u_act[:, 0], ctx)
    h = da * cache["h"] + dbu
    y = torch.einsum("bdn,bn->bd", h, cc)[:, None, :].to(x.dtype)
    y = y + u_act * L.mesh_param(p, "D", ctx).to(x.dtype)
    y = y * F.silu(z)
    out = L.local_dense(y, p.out_proj, ctx)
    if L.splits(p.out_proj, "kernel", 0, ctx):
        out = comm.psum(out, "model", mesh=mesh)
    return out, {"conv": new_conv, "h": h}
