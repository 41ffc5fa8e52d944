"""RG-LRU recurrent block (Griffin / recurrentgemma).

The counterpart of the reference's ``repro.models.rglru``.  A gated linear
recurrence ``h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)`` with ``a_t =
exp(-c softplus(lam) r_t)``, one fp32 state per channel.  The gates ``r``
and ``i`` come from :data:`NUM_GATE_BLOCKS` diagonal blocks
(:func:`block_diag`).  :func:`rglru_forward` scans chunks of ``chunk``
timesteps (one chunk where the length is not a multiple of it), folding
each chunk's carry into its first element, as ``models.ssm`` does (in a
partitioned step on this rank's channels);
:func:`rglru_decode` is the O(1) update, and :func:`rglru_decode_mesh`
the same on a rank's block of the channels in the serve step over a mesh.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import comm
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
    return gates_of(p.w_r, p.w_i, p.lam, xb)


def gates_of(w_r: torch.Tensor, w_i: torch.Tensor, lam: torch.Tensor,
             xb: torch.Tensor):
    """:func:`gates` on the given gate blocks and ``lam``, which cover
    ``xb``'s channels."""
    r = torch.sigmoid(block_diag(w_r, xb).float())
    i = torch.sigmoid(block_diag(w_i, xb).float())
    log_a = -_C * F.softplus(lam.float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * i \
        * xb.float()
    return a, gated


def rglru_forward(p: RGLRU, x: torch.Tensor, *, chunk: int = 512,
                  ctx: ShardingCtx = NO_SHARDING) -> torch.Tensor:
    """x: ``[B, S, d]`` -> ``[B, S, d]``; chunks of ``min(chunk, S)``
    timesteps, or one chunk where ``S`` is not a multiple of that.  The
    conv's output is constrained as ``"ssm_bsdn"``.

    In a partitioned step (``ctx`` with a process mesh; ``p`` holds this
    rank's blocks, ``LM.shard``) ``x`` is this rank's block of the
    residual stream's norm and so is the output: the sequence is gathered
    (``models.layers.sp_enter``), ``wx`` and ``wy`` are column-parallel
    (the rank's channels), the conv, ``lam`` and the scan run on the
    channel block with the rank's gate blocks (:func:`gate_blocks`), and
    ``out`` is row-parallel, its partial sums reduce-scattered back along
    the sequence (``sp_exit``).

    Raises:
        NotImplementedError: ``"model"`` splits the channels but not the
            gate blocks (:func:`check_gate_split`).
    """
    mesh = ctx.process_mesh
    if mesh is None:
        branch = F.gelu(p.wy(x), approximate="tanh")
        xb = p.wx(x)
        conv_w, conv_b, full = p.conv_w, p.conv_b, None
        w_r, w_i, lam = p.w_r, p.w_i, p.lam
    else:
        check_gate_split(p, ctx)
        x = L.sp_enter(x, ctx)
        branch = F.gelu(L.local_dense(x, p.wy, ctx), approximate="tanh")
        xb = L.local_dense(x, p.wx, ctx)
        conv_w, conv_b = (L.mesh_param(p, n, ctx) for n in ("conv_w",
                                                            "conv_b"))
        (w_r, w_i), lam = gate_blocks(p, ctx), L.mesh_param(p, "lam", ctx)
        tp = mesh.shape["model"] if L.splits(p, "conv_w", -1, ctx) else 1
        full = (ctx.dims["b"], x.shape[1], xb.shape[-1] * tp)
    b, s, _ = x.shape
    xb = ctx.constrain(S.causal_conv(xb, conv_w, conv_b), "ssm_bsdn", full)
    ch = min(chunk, s)
    if s % ch:
        ch = s
    h = xb.new_zeros((b, xb.shape[-1]), dtype=torch.float32)
    outs = []
    for c in range(s // ch):
        a, gated = gates_of(w_r, w_i, lam, xb[:, c * ch:(c + 1) * ch])
        _, hs = S.linear_scan(a, S.fold_carry(a, gated, h))
        h = hs[:, -1]
        outs.append(hs.to(x.dtype))
    y = torch.cat(outs, dim=1) * branch
    if mesh is None:
        return p.out(y)
    return L.sp_exit(L.local_dense(y, p.out, ctx), ctx,
                     partial=L.splits(p.out, "kernel", 0, ctx))


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


def gate_blocks(p: RGLRU, ctx: ShardingCtx):
    """This rank's ``(w_r, w_i)`` blocks: ``NUM_GATE_BLOCKS / tp`` gate
    blocks each (``P("model", None, None)``), exactly its channels."""
    return (L.mesh_param(p, "w_r", ctx), L.mesh_param(p, "w_i", ctx))


def check_gate_split(p: RGLRU, ctx: ShardingCtx) -> None:
    """Raise ``NotImplementedError`` where ``"model"`` splits the
    RG-LRU's channels but not its gate blocks (it does not divide
    :data:`NUM_GATE_BLOCKS`): a rank's gate blocks would not be its
    channels'."""
    if L.splits(p, "conv_w", -1, ctx) != L.splits(p, "w_r", 0, ctx):
        tp = ctx.process_mesh.shape["model"]
        raise NotImplementedError(
            f"a model axis of {tp} splits the RG-LRU's "
            f"{p.conv_w.shape[-1] * tp} channels but not its "
            f"{NUM_GATE_BLOCKS} gate blocks")


def rglru_decode_mesh(p: RGLRU, cache: Dict[str, torch.Tensor],
                      x: torch.Tensor, ctx: ShardingCtx
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """:func:`rglru_decode` on this rank's ``rw / tp`` channels, in the
    serve step over a mesh: ``p`` holds this rank's blocks
    (``LM.shard``), ``cache`` its ``conv [B, K - 1, rw / tp]`` and ``h [B,
    rw / tp]`` blocks; x ``[B, 1, d]`` is whole on every rank of
    ``"model"``, and so is the output.  ``wx`` and ``wy`` are
    column-parallel (the rank's channels), the conv, ``lam`` and the
    state are on the channel block, the rank's gate blocks
    (:func:`gate_blocks`) are exactly its channels, and ``out`` is
    row-parallel with a ``psum``.

    Raises:
        NotImplementedError: ``"model"`` splits the channels but not the
            gate blocks (:func:`check_gate_split`).
    """
    mesh = ctx.process_mesh
    branch = F.gelu(L.local_dense(x, p.wy, ctx), approximate="tanh")
    xb_raw = L.local_dense(x, p.wx, ctx)                     # [B,1,rw/tp]
    xb = S.causal_conv(xb_raw, L.mesh_param(p, "conv_w", ctx),
                       L.mesh_param(p, "conv_b", ctx), state=cache["conv"])
    new_conv = torch.cat([cache["conv"][:, 1:],
                          xb_raw.to(cache["conv"].dtype)], dim=1)
    check_gate_split(p, ctx)
    a, gated = gates_of(*gate_blocks(p, ctx), L.mesh_param(p, "lam", ctx),
                        xb[:, 0])
    h = a * cache["h"] + gated
    out = L.local_dense(h[:, None, :].to(x.dtype) * branch, p.out, ctx)
    if L.splits(p.out, "kernel", 0, ctx):
        out = comm.psum(out, "model", mesh=mesh)
    return out, {"conv": new_conv, "h": h}
