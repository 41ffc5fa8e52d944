"""Error-feedback int8 gradient compression (the reference's
``repro.optim.compression``).

Per-tensor symmetric int8 with an fp32 residual that carries each step's
quantisation error into the next, so the compressed sum tracks the true
sum.  :func:`compressed_psum`, the cross-device reduction it feeds, needs
several cards and is not ported yet.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.device import MULTI_CARD
from repro_torch.core.tree import map_tree


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation: ``(q, scale)``, ``scale`` a
    0-d fp32 tensor; rounding is half to even."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_grad(g: torch.Tensor, residual: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Error-feedback int8 compression of one gradient tensor.

    Returns ``(q, scale, new_residual)`` with ``q * scale + new_residual ==
    g + residual``.
    """
    corrected = g.float() + residual
    q, scale = quantize_int8(corrected)
    return q, scale, corrected - dequantize_int8(q, scale)


def compressed_psum(g: torch.Tensor, residual: torch.Tensor,
                    axis_name: str):
    """The int8 all-reduce over a device axis: not ported (it needs several
    cards)."""
    raise NotImplementedError(
        f"compressed_psum reduces across devices; it comes with "
        f"{MULTI_CARD}")


def init_residuals(grads: Dict) -> Dict:
    """fp32 zeros shaped like every leaf of a nested dict of tensors."""
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
