"""Attention: chunked (flash-style) causal or bidirectional attention and
sliding-window (``local``) attention for ``forward``, and one-token
attention against a KV cache (linear or ring) for ``decode_step``.

The counterpart of the reference's ``repro.models.attention``, with both
of its causal implementations (:data:`CAUSAL_IMPL`): ``"masked"`` (the
default) computes every (q block, kv block) pair and masks the upper
triangle; ``"triangle"`` computes only the pairs on and below the
diagonal, on square blocks, so its products fall to ``(nq + 1) / (2 nq)``
of the masked ones at ``nq`` q blocks.  Local attention is the
paper's banded regime applied to attention: each q block reads one band of
``window`` keys before it, so its traffic and FLOPs scale with the window,
not the sequence.  Logits, softmax statistics and accumulators are fp32;
the probabilities that multiply V are rounded to V's dtype, as in the
reference.

Over a mesh the decode cache is split along its sequence
(``launch.sharding.cache_pspecs``), and one token's softmax spans the
blocks: :func:`decode_attention_partial` gives each rank's unnormalised
output, row max and sum on its slots, and :func:`combine` merges them over
the sequence axes with ``core.comm``'s ``pmax`` and ``psum`` (the
distributed softmax that XLA's partitioner writes for the reference).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import comm

NEG_INF = -1e30

#: The causal implementation of :func:`chunked_attention`: ``"masked"`` or
#: ``"triangle"``.  Module-level, as the reference's, so a launch script
#: flips it per experiment (``launch.dryrun --causal-impl``).
CAUSAL_IMPL = "masked"


def set_causal_impl(impl: str) -> None:
    """Set :data:`CAUSAL_IMPL`.

    Raises:
        ValueError: for another name than ``"masked"`` or ``"triangle"``.
    """
    global CAUSAL_IMPL
    if impl not in ("masked", "triangle"):
        raise ValueError(f"causal impl must be 'masked' or 'triangle', "
                         f"not {impl!r}")
    CAUSAL_IMPL = impl


def _remat(fn, *args):
    """``fn(*args)``, checkpointed where gradients are recorded: its
    activations are recomputed in the backward pass, as the reference's
    ``jax.checkpoint`` of each q block's step (flash-attention memory:
    no tile's probabilities are saved)."""
    if torch.is_grad_enabled() and any(
            isinstance(a, torch.Tensor) and a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def kv_blocks(i: int, nk: int, triangle: bool) -> range:
    """The kv blocks q block ``i`` of :func:`chunked_attention` computes:
    the ``i + 1`` on and below the diagonal for the triangle, else all
    ``nk``."""
    return range(i + 1) if triangle else range(nk)


def _pick_block(s: int, pref: int) -> int:
    """Largest block size <= pref that divides s."""
    b = min(pref, s)
    while s % b:
        b -= 1
    return b


def _gqa_expand(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """``[B,S,Hq,D] -> [B,S,Hkv,G,D]``: query heads grouped per kv head."""
    b, s, hq, d = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, d)


def _attn_block(q, k, v, mask):
    """One (q block, kv block) tile: ``(unnormalised out, m, l)``.

    q: ``[B, bq, Hkv, G, D]``; k/v: ``[B, bk, Hkv, D]``; mask ``[bq, bk]``
    or None.  m is the max over the *unmasked* logits, an upper bound on
    the masked max and equally valid for stability.
    """
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float())
    m = logits.amax(dim=-1)                                  # [B,H,G,bq]
    p = torch.exp(logits - m[..., None])
    if mask is not None:
        p = torch.where(mask, p, 0.0)
    p = p.to(v.dtype)
    l = p.float().sum(dim=-1)                                # [B,H,G,bq]
    out = torch.einsum("bhgqk,bkhd->bhgqd", p.float(), v.float())
    return out, m, l


def _merge(acc, m_acc, l_acc, out, m, l):
    """Online-softmax merge of a new tile into the accumulators."""
    m_new = torch.maximum(m_acc, m)
    scale_old = torch.exp(m_acc - m_new)
    scale_new = torch.exp(m - m_new)
    acc = acc * scale_old[..., None] + out * scale_new[..., None]
    return acc, m_new, l_acc * scale_old + l * scale_new


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_block: int = 512,
                      kv_block: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Global (or bidirectional) chunked attention.

    q: ``[B,Sq,Hq,D]``; k/v: ``[B,Skv,Hkv,D]``.  Causal masking puts query
    row ``i`` at position ``q_offset + i`` and key ``j`` at ``j``
    (``Sq == Skv`` and offset 0 in ``forward``; a context-parallel rank's
    block of the queries starts at its first row).  Returns
    ``[B,Sq,Hq,D]`` in q's dtype.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    bq = _pick_block(sq, q_block)
    triangle = causal and CAUSAL_IMPL == "triangle" and sq == skv and \
        q_offset == 0
    # The triangle walks square block pairs (i, j <= i) row by row.
    bk = bq if triangle else _pick_block(skv, kv_block)
    # The 1/sqrt(D) scale is applied in q's dtype, as the reference does.
    qe = _gqa_expand(q, hkv) * (1.0 / math.sqrt(d))
    q_pos = torch.arange(bq, device=q.device)
    k_pos = torch.arange(bk, device=q.device)

    def tile(i, j, qi, kj, vj, acc, m_acc, l_acc):
        mask = None
        if causal:
            mask = (q_offset + i * bq + q_pos[:, None]) >= \
                (j * bk + k_pos[None, :])
        return _merge(acc, m_acc, l_acc, *_attn_block(qi, kj, vj, mask))

    def q_step(i, qi, k, v, pairs):
        # Made from qi, so a step counter splits them as it splits q.
        acc = qi.new_zeros((b, hkv, g, bq, d), dtype=torch.float32)
        m_acc = qi.new_full((b, hkv, g, bq), NEG_INF, dtype=torch.float32)
        l_acc = qi.new_zeros((b, hkv, g, bq), dtype=torch.float32)
        for j in pairs:
            kv = (k[:, j * bk:(j + 1) * bk], v[:, j * bk:(j + 1) * bk])
            # The triangle rematerialises each pair, as the reference's
            # checkpointed scan over pairs does.
            acc, m_acc, l_acc = _remat(tile, i, j, qi, *kv, acc, m_acc,
                                       l_acc) if triangle else \
                tile(i, j, qi, *kv, acc, m_acc, l_acc)
        out = acc / torch.clamp(l_acc[..., None], min=1e-30)
        # [B,Hkv,G,bq,D] -> [B,bq,Hq,D]
        return out.permute(0, 3, 1, 2, 4).reshape(b, bq, hq, d).to(q.dtype)

    blocks = []
    for i in range(sq // bq):
        qi = qe[:, i * bq:(i + 1) * bq]
        pairs = kv_blocks(i, skv // bk, triangle)
        if triangle:
            blocks.append(q_step(i, qi, k, v, pairs))
        else:
            blocks.append(_remat(q_step, i, qi, k, v, pairs))
    return torch.cat(blocks, dim=1)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, q_block: int = 512,
                    q_offset: int = 0) -> torch.Tensor:
    """Sliding-window causal attention: query ``i`` sees keys ``j`` with
    ``i - window < j <= i``.

    q: ``[B,Sq,Hq,D]``; k/v: ``[B,Skv,Hkv,D]``, query row ``i`` at
    position ``q_offset + i`` (a context-parallel rank's block of the
    queries on the gathered K/V; ``Skv >= q_offset + Sq``).  K and V are
    padded on the left by ``window``; q block ``i`` (``bq`` rows) takes the
    band of ``bq + window`` padded rows that starts at ``q_offset + i *
    bq``, masks ``q >= k``, ``q - k < window`` and the padded slots, and is
    normalised once (no online merge: the band is one tile).  Returns
    ``[B,Sq,Hq,D]`` in q's dtype.
    """
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    bq = _pick_block(s, q_block)
    band = bq + window
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, window, 0))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, window, 0))
    qe = _gqa_expand(q, hkv) * (1.0 / math.sqrt(d))
    # In band coordinates query row r sits at r + window; band slot t holds
    # absolute position start + t - window.
    q_pos = torch.arange(bq, device=q.device)[:, None] + window
    k_pos = torch.arange(band, device=q.device)
    in_window = (q_pos >= k_pos) & (q_pos - k_pos < window)

    def q_step(start, qi, kj, vj):
        mask = in_window & (start + k_pos - window >= 0)[None, :]
        out, _, l = _attn_block(qi, kj, vj, mask)
        out = out / torch.clamp(l[..., None], min=1e-30)
        return out.permute(0, 3, 1, 2, 4).reshape(b, bq, hq, d).to(q.dtype)

    blocks = []
    for i in range(s // bq):
        start = q_offset + i * bq
        blocks.append(_remat(q_step, start, qe[:, i * bq:(i + 1) * bq],
                             kp[:, start:start + band],
                             vp[:, start:start + band]))
    return torch.cat(blocks, dim=1)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     slot_mask: torch.Tensor) -> torch.Tensor:
    """One-token attention against a cache.

    q: ``[B,1,Hq,D]``; caches: ``[B,S,Hkv,D]``; slot_mask: ``[B,S]`` bool,
    the valid slots.  fp32 logits and softmax; masked slots get
    :data:`NEG_INF`.  Returns ``[B,1,Hq,D]`` in q's dtype.
    """
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    qe = _gqa_expand(q, hkv)[:, 0] * (1.0 / math.sqrt(d))    # [B,Hkv,G,D]
    logits = torch.einsum("bhgd,bshd->bhgs", qe.float(), k_cache.float())
    logits = torch.where(slot_mask[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", probs, v_cache.float())
    return out.reshape(b, 1, hq, d).to(q.dtype)


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, slot_mask: torch.Tensor):
    """One-token attention on a block of the cache, not yet normalised.

    q: ``[B,1,Hq,D]``; caches: ``[B,S_blk,Hkv,D]``, this rank's slots;
    slot_mask: ``[B,S_blk]`` bool.  Returns ``(acc, m, l)``, fp32: ``acc
    [B,1,Hq,D]`` the sum over the valid slots of ``e^{logit - m} v``, ``m
    [B,1,Hq]`` the largest valid logit and ``l [B,1,Hq]`` the sum of
    ``e^{logit - m}``.  A row with no valid slot has ``m = -inf`` and adds
    exactly zero: its ``acc`` and ``l`` are 0, whatever ``m`` is."""
    b, _, hq, d = q.shape
    hkv = k_cache.shape[2]
    qe = _gqa_expand(q, hkv)[:, 0] * (1.0 / math.sqrt(d))    # [B,Hkv,G,D]
    logits = torch.einsum("bhgd,bshd->bhgs", qe.float(), k_cache.float())
    valid = slot_mask[:, None, None, :]
    m = torch.where(valid, logits, -math.inf).amax(dim=-1)   # [B,Hkv,G]
    m_safe = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(valid, torch.exp(logits - m_safe[..., None]), 0.0)
    acc = torch.einsum("bhgs,bshd->bhgd", p, v_cache.float())
    return (acc.reshape(b, 1, hq, d), m.reshape(b, 1, hq),
            p.sum(dim=-1).reshape(b, 1, hq))


def combine(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor, mesh,
            axes, dtype: torch.dtype) -> torch.Tensor:
    """The softmax of one token over every block of the cache, from each
    rank's :func:`decode_attention_partial` on ``mesh``: ``m* = pmax(m)``
    over ``axes`` (the cache's sequence axes), then ``psum`` of ``l e^{m -
    m*}`` and of ``acc e^{m - m*}``, and their quotient, in ``dtype``.  A
    block with no valid slot (``m = -inf``) is weighted by exactly 0.
    Every rank of ``axes`` must call it; with no axes it normalises the
    one block."""
    if axes:
        m_all = comm.pmax(m, axes, mesh=mesh)
        w = torch.where(torch.isfinite(m), torch.exp(m - m_all), 0.0)
        l = comm.psum(l * w, axes, mesh=mesh)
        acc = comm.psum(acc * w[..., None], axes, mesh=mesh)
    return (acc / torch.clamp(l[..., None], min=1e-30)).to(dtype)
