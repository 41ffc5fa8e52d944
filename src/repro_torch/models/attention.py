"""Attention: chunked (flash-style) causal or bidirectional attention and
sliding-window (``local``) attention for ``forward``, and one-token
attention against a KV cache (linear or ring) for ``decode_step``.

The counterpart of the reference's ``repro.models.attention`` with its
default causal implementation, ``"masked"``: every (q block, kv block)
pair is computed and the upper triangle masked.  Local attention is the
paper's banded regime applied to attention: each q block reads one band of
``window`` keys before it, so its traffic and FLOPs scale with the window,
not the sequence.  Logits, softmax statistics and accumulators are fp32;
the probabilities that multiply V are rounded to V's dtype, as in the
reference.  The ``"triangle"`` causal implementation is not ported.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


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
                      kv_block: int = 1024) -> torch.Tensor:
    """Global (or bidirectional) chunked attention.

    q: ``[B,Sq,Hq,D]``; k/v: ``[B,Skv,Hkv,D]``.  Causal masking aligns q
    and k positions at the start (``Sq == Skv`` in ``forward``).  Returns
    ``[B,Sq,Hq,D]`` in q's dtype.
    """
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    bq, bk = _pick_block(sq, q_block), _pick_block(skv, kv_block)
    # The 1/sqrt(D) scale is applied in q's dtype, as the reference does.
    qe = _gqa_expand(q, hkv) * (1.0 / math.sqrt(d))
    q_pos = torch.arange(bq, device=q.device)
    k_pos = torch.arange(bk, device=q.device)
    blocks = []
    for i in range(sq // bq):
        qi = qe[:, i * bq:(i + 1) * bq]
        acc = torch.zeros(b, hkv, g, bq, d, device=q.device)
        m_acc = torch.full((b, hkv, g, bq), NEG_INF, device=q.device)
        l_acc = torch.zeros(b, hkv, g, bq, device=q.device)
        for j in range(skv // bk):
            mask = None
            if causal:
                mask = (i * bq + q_pos[:, None]) >= (j * bk + k_pos[None, :])
            out, m, l = _attn_block(qi, k[:, j * bk:(j + 1) * bk],
                                    v[:, j * bk:(j + 1) * bk], mask)
            acc, m_acc, l_acc = _merge(acc, m_acc, l_acc, out, m, l)
        out = acc / torch.clamp(l_acc[..., None], min=1e-30)
        # [B,Hkv,G,bq,D] -> [B,bq,Hq,D]
        blocks.append(out.permute(0, 3, 1, 2, 4).reshape(b, bq, hq, d)
                      .to(q.dtype))
    return torch.cat(blocks, dim=1)


def local_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int, q_block: int = 512) -> torch.Tensor:
    """Sliding-window causal attention: query ``i`` sees keys ``j`` with
    ``i - window < j <= i``.

    q: ``[B,S,Hq,D]``; k/v: ``[B,S,Hkv,D]``.  K and V are padded on the
    left by ``window``; q block ``i`` (``bq`` rows) takes the band of ``bq +
    window`` padded rows that starts at ``i * bq``, masks ``q >= k``, ``q -
    k < window`` and the padded slots, and is normalised once (no online
    merge: the band is one tile).  Returns ``[B,S,Hq,D]`` in q's dtype.
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
    blocks = []
    for i in range(s // bq):
        start = i * bq
        mask = in_window & (start + k_pos - window >= 0)[None, :]
        out, _, l = _attn_block(qe[:, start:start + bq],
                                kp[:, start:start + band],
                                vp[:, start:start + band], mask)
        out = out / torch.clamp(l[..., None], min=1e-30)
        blocks.append(out.permute(0, 3, 1, 2, 4).reshape(b, bq, hq, d)
                      .to(q.dtype))
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
