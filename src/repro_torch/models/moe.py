"""Mixture-of-Experts FFN on the grouped-matmul kernel.

The counterpart of the reference's ``repro.models.moe`` without a mesh
(its ``shard_map`` branch waits for multi-card work).  Routing, capacity
and bucketing are the reference's exactly: top-k of an fp32 softmax,
renormalised; GShard-style sequential ranks over the slot-major order; a
slot whose rank reaches the capacity C is dropped, and a dropped slot
adds a zero into row ``(0, 0)`` of the buffer.  The expert FFN, which the
reference computes as an einsum over the ``[E, C, d]`` capacity buffer,
runs as a block-diagonal SpMM on the grouped-matmul kernel
(``kernels.grouped_matmul``, ``csrc/grouped_matmul.cu``): each expert's
buffer is padded from C to ``C_pad`` rows, a multiple of the kernel's
64-row tile, and the ``[E * C_pad, d]`` rows go through two launches, one
over the gate and up weights side by side (``[E, d, 2 * d_ff]``: each
output column is its own product, so one launch gives both, bit for bit)
and one over the down weights, with SwiGLU between them.  Padding rows
are zero going in and come out zero.  Under autograd each launch goes
through ``GroupedMatmulFn``, whose input gradient is a third launch of the
same kernel (``kernels.grouped_matmul``).
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.grouped_matmul import (TILE_M, check_group_ids,
                                                grouped_matmul)
from repro_torch.models.layers import he_init, weight

#: ``(x, w, group_ids, *, bm, bk, bn, expert_rows) -> out``: the grouped
#: product the expert FFN calls (the kernel by default; tests and
#: ``chip_smoke.py`` pass ``grouped_matmul_plain`` to run the same model on
#: the plain one).
GroupedMatmul = Callable[..., torch.Tensor]

#: Grouped-matmul launches per MoE layer: gate and up share one.
LAUNCHES_PER_LAYER = 2


def router(x: torch.Tensor, kernel: torch.Tensor, k: int):
    """Top-k routing. x: ``[T, d]`` -> (weights ``[T, k]`` fp32, renormalised;
    ids ``[T, k]`` int64).  Logits and softmax are fp32."""
    probs = torch.softmax(x.float() @ kernel.float(), dim=-1)
    weights, ids = torch.topk(probs, k, dim=-1)
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    return weights, ids


def capacity(t_local: int, k: int, num_experts: int,
             capacity_factor: float) -> int:
    """Rows per expert in the buffer: the reference's ``_capacity``."""
    c = int((t_local * k * capacity_factor) / num_experts) + 1
    c = max(c, min(8, t_local * k))
    return min(c, t_local * k)


def padded_capacity(c: int) -> int:
    """C rounded up to the kernel's row tile (:data:`TILE_M`)."""
    return -(-c // TILE_M) * TILE_M


def slot_ranks(ids: torch.Tensor, e0: int, e_loc: int):
    """Each (token, slot)'s expert among ``[e0, e0 + e_loc)`` and its rank
    within that expert, counted over the slot-major order (all tokens' slot
    0, then slot 1, ...).  Returns ``(e_local, local, pos)``, each
    ``[T, k]``; a slot routed elsewhere has ``local`` false."""
    T, k = ids.shape
    local = (ids >= e0) & (ids < e0 + e_loc)
    e_local = torch.clamp(ids - e0, 0, e_loc - 1)
    experts = torch.arange(e_loc, device=ids.device)
    pos = torch.zeros(T, k, dtype=torch.int64, device=ids.device)
    counts = torch.zeros(e_loc, dtype=torch.int64, device=ids.device)
    for r in range(k):
        onehot = (experts[None, :] == e_local[:, r][:, None]) & \
            local[:, r][:, None]                               # [T, E_loc]
        within = torch.cumsum(onehot.long(), dim=0) - 1
        pos[:, r] = torch.gather(within + counts[None, :], 1,
                                 e_local[:, r][:, None])[:, 0]
        counts = counts + onehot.long().sum(dim=0)
    return e_local, local, pos


def bucket_local(x: torch.Tensor, weights: torch.Tensor, ids: torch.Tensor,
                 e0: int, e_loc: int, cap: int, rows: Optional[int] = None):
    """Bucket the tokens routed to experts ``[e0, e0 + e_loc)``.

    x: ``[T, d]``; weights/ids: ``[T, k]``.  Returns ``(buffer [E_loc,
    rows, d], (e_idx, c_idx, keep * w))``, the combine spec each ``[T,
    k]``.  A slot whose rank is ``cap`` or more is dropped: its combine
    weight is 0 and it adds a zero into ``buffer[0, 0]``.  ``rows``
    (default ``cap``) pads each expert's block with zero rows.
    """
    T, d = x.shape
    k = ids.shape[1]
    e_local, local, pos = slot_ranks(ids, e0, e_loc)
    keep = local & (pos < cap)
    buf = torch.zeros(e_loc, rows or cap, d, dtype=x.dtype, device=x.device)
    flat_e = torch.where(keep, e_local, 0).reshape(-1)
    flat_c = torch.where(keep, pos, 0).reshape(-1)
    updates = x[:, None, :].expand(T, k, d).reshape(-1, d) * \
        keep.reshape(-1, 1).to(x.dtype)
    buf.index_put_((flat_e, flat_c), updates, accumulate=True)
    return buf, (e_local, torch.clamp(pos, 0, cap - 1),
                 weights * keep.to(weights.dtype))


def combine_local(out_buf: torch.Tensor, combine) -> torch.Tensor:
    """``sum_k w[t, k] * out_buf[e_idx[t, k], c_idx[t, k]]`` in the
    buffer's dtype: ``[T, d]``."""
    e_idx, c_idx, w = combine
    gathered = out_buf[e_idx, c_idx]                         # [T, k, d]
    return (gathered * w[..., None].to(gathered.dtype)).sum(dim=1)


def tile(n: int) -> int:
    """The reference's 128 tile where it divides n, else the largest power
    of two that does (the grouped wrapper checks ``n % tile == 0``)."""
    return math.gcd(n, 128)


class MoE(nn.Module):
    """Router ``[d, E]`` (fp32), ``w_gate_up`` ``[E, d, 2 * d_ff]`` (the
    reference's ``w_gate`` and ``w_up`` side by side) and ``w_down`` ``[E,
    d_ff, d]``, both in ``dtype`` (the compute dtype, or fp32 masters that
    :meth:`expert_ffn` casts at each use)."""

    def __init__(self, d: int, d_ff: int, num_experts: int, k: int,
                 capacity_factor: float, *, dtype: torch.dtype,
                 device: torch.device,
                 generator: Optional[torch.Generator],
                 trainable: bool = False):
        super().__init__()
        self.k, self.num_experts = k, num_experts
        self.capacity_factor = capacity_factor
        self.router = weight(he_init((d, num_experts), generator=generator,
                                     device=device), torch.float32,
                             trainable)
        gate = he_init((num_experts, d, d_ff), fan_in=d, generator=generator,
                       device=device).to(dtype)
        up = he_init((num_experts, d, d_ff), fan_in=d, generator=generator,
                     device=device).to(dtype)
        self.w_gate_up = weight(torch.cat([gate, up], dim=2), dtype,
                                trainable)
        del gate, up
        self.w_down = weight(he_init((num_experts, d_ff, d), fan_in=d_ff,
                                     generator=generator, device=device),
                             dtype, trainable)
        self._group_ids: Dict[int, torch.Tensor] = {}

    def group_ids(self, rows: int) -> torch.Tensor:
        """Expert of each 64-row block of the ``[E * rows, d]`` buffer,
        made and checked once per ``rows``."""
        if rows not in self._group_ids:
            ids = torch.repeat_interleave(
                torch.arange(self.num_experts, dtype=torch.int32,
                             device=self.w_down.device), rows // TILE_M)
            check_group_ids(ids, self.num_experts)
            self._group_ids[rows] = ids
        return self._group_ids[rows]

    def expert_ffn(self, buf: torch.Tensor,
                   gmm: GroupedMatmul = grouped_matmul) -> torch.Tensor:
        """``[E, rows, d] -> [E, rows, d]``: SwiGLU per expert through two
        grouped products."""
        e, rows, d = buf.shape
        f = self.w_down.shape[1]
        gids = self.group_ids(rows)
        x = buf.reshape(e * rows, d)
        gu = gmm(x, self.w_gate_up.to(buf.dtype), gids, bm=TILE_M,
                 bk=tile(d), bn=tile(2 * f), expert_rows=rows)
        h = F.silu(gu[:, :f]) * gu[:, f:]
        out = gmm(h, self.w_down.to(buf.dtype), gids, bm=TILE_M, bk=tile(f),
                  bn=tile(d), expert_rows=rows)
        return out.reshape(e, rows, d)

    def forward(self, x: torch.Tensor,
                gmm: GroupedMatmul = grouped_matmul) -> torch.Tensor:
        """x: ``[B, S, d]`` in the compute dtype."""
        B, S, d = x.shape
        flat = x.reshape(B * S, d)
        weights, ids = router(flat, self.router, self.k)
        cap = capacity(B * S, self.k, self.num_experts, self.capacity_factor)
        buf, combine = bucket_local(flat, weights, ids, 0, self.num_experts,
                                    cap, rows=padded_capacity(cap))
        return combine_local(self.expert_ffn(buf, gmm), combine) \
            .reshape(B, S, d)


def moe_ffn_dense(moe: MoE, x: torch.Tensor) -> torch.Tensor:
    """Oracle: every expert computes every token, combined by the router's
    weights (the reference's ``moe_ffn_dense``; tests only)."""
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    f = moe.w_down.shape[1]
    weights, ids = router(flat, moe.router, moe.k)
    w_gate_up = moe.w_gate_up.to(x.dtype)
    w_gate, w_up = w_gate_up[..., :f], w_gate_up[..., f:]
    h = F.silu(torch.einsum("td,edf->tef", flat, w_gate)) * \
        torch.einsum("td,edf->tef", flat, w_up)
    all_out = torch.einsum("tef,efd->ted", h,
                           moe.w_down.to(x.dtype))              # [T, E, d]
    gate = torch.zeros(flat.shape[0], moe.num_experts, device=x.device)
    gate.scatter_add_(1, ids, weights)
    out = torch.einsum("ted,te->td", all_out.float(), gate)
    return out.reshape(B, S, d).to(x.dtype)
