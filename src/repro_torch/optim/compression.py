"""Error-feedback int8 gradient compression (the reference's
``repro.optim.compression``).

Per-tensor symmetric int8 with an fp32 residual that carries each step's
quantisation error into the next, so the compressed sum tracks the true
sum.  :func:`compressed_psum` is the cross-rank reduction it feeds, on an
axis of a ``launch.mesh.ProcessMesh`` (``core.comm``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import comm
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
                    axis_name: str, *, mesh=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 all-reduce of ``g`` over ``axis_name``, the reference's line
    for line: each rank compresses ``g + residual``, the int8 ``q`` is
    summed in int32 lanes (an int8 sum can overflow int8; the wire format
    it models stays 8-bit), the scales are reduced by ``pmax``, and the
    mean is taken in fp32 after dequantisation.

    Args:
        g: this rank's gradient.
        residual: this rank's fp32 error-feedback residual.
        axis_name: the mesh axis to reduce over.
        mesh: the ``ProcessMesh`` (default: the entered one).

    Returns:
        ``(mean, new_residual)``: the mean in ``g``'s dtype and this
        rank's new residual.
    """
    q, scale, new_residual = compress_grad(g.detach(), residual)
    n = comm.axis_size(axis_name, mesh=mesh)
    q_sum = comm.psum(q.to(torch.int32), axis_name, mesh=mesh)
    scale_max = comm.pmax(scale, axis_name, mesh=mesh)
    out = q_sum.float() * scale_max / n
    return out.to(g.dtype), new_residual


def init_residuals(grads: Dict) -> Dict:
    """fp32 zeros shaped like every leaf of a nested dict of tensors."""
    return map_tree(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)
