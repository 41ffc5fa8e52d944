"""Banded (diagonal-regime) SpMM over a block-band tensor (CUDA kernel).

The counterpart of the reference's ``banded_spmm_pallas``.  A is
``band[nb, 2w+1, t, t]`` (``registry.band_to_blocks``): ``band[i, o]`` is
the block at block position ``(i, i + o - w)``, zero where out of range.
:func:`banded_spmm` runs ``C = A @ B``: the hand-written kernel
``csrc/banded_spmm.cu`` for a CUDA operand, the plain PyTorch version
:func:`banded_spmm_plain` for a CPU operand.  Block products are exact in
fp32 and C is cast once.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import build
from repro_torch.kernels.csr_spmm import check_operands, value_code

#: Kernel launches made by :func:`banded_spmm` (a plain counter).
LAUNCHES = 0

#: Largest block edge the kernel holds in shared memory.
MAX_T = 128


@dataclasses.dataclass(frozen=True)
class BandLayout:
    """The packed operand of :func:`banded_spmm`, on one device."""

    band: torch.Tensor   # [nb, 2w+1, t, t] float32 or bfloat16
    w: int               # half-bandwidth in blocks
    t: int               # block edge

    @property
    def nb(self) -> int:
        """Block rows."""
        return int(self.band.shape[0])

    @property
    def device(self) -> torch.device:
        """The device the layout lives on."""
        return self.band.device


def banded_spmm_plain(layout: BandLayout, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the banded kernel on the same layout."""
    nb, t, w, d = layout.nb, layout.t, layout.w, b.shape[1]
    b_tiles = b.reshape(nb, t, d)
    rows = torch.arange(nb, device=b.device)
    out = torch.zeros(nb, t, d, dtype=torch.float32, device=b.device)
    for o in range(2 * w + 1):
        cols = torch.clamp(rows + o - w, 0, nb - 1)
        out += torch.bmm(layout.band[:, o].to(torch.float32),
                         b_tiles[cols].to(torch.float32))
    return out.reshape(nb * t, d).to(b.dtype)


_P = ctypes.c_void_p
_ARGTYPES = (ctypes.c_int, _P, _P, _P, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, _P)


def _kernel():
    fn = build.library("banded_spmm").banded_spmm_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def banded_spmm_cuda(layout: BandLayout, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/banded_spmm.cu``) on a CUDA operand."""
    global LAUNCHES
    nb, W, t = layout.nb, layout.band.shape[1], layout.t
    if not 1 <= t <= MAX_T:
        raise ValueError(f"banded_spmm: block edge t={t} outside "
                         f"[1, {MAX_T}]")
    if W != 2 * layout.w + 1 or tuple(layout.band.shape[2:]) != (t, t):
        raise ValueError(f"banded_spmm: band shape "
                         f"{tuple(layout.band.shape)} does not match "
                         f"w={layout.w}, t={t}")
    check_operands("banded_spmm", (layout.band,), b, layout.band)
    if b.shape[0] != nb * t:
        raise ValueError(f"banded_spmm: b has {b.shape[0]} rows, the band "
                         f"{nb * t}")
    d = b.shape[1]
    c = torch.empty(nb * t, d, dtype=b.dtype, device=b.device)
    err = _kernel()(value_code(b.dtype), build.ptr(layout.band),
                    build.ptr(b), build.ptr(c), nb, W, layout.w, t, d,
                    build.stream_ptr(b.device))
    LAUNCHES += 1
    build.check(err, "banded_spmm")
    return c


def banded_spmm(layout: BandLayout, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` for banded A: the CUDA kernel for a CUDA operand,
    :func:`banded_spmm_plain` for a CPU one.

    Args:
        layout: the block-band tensor, on ``b``'s device.
        b: ``[nb * t, d]`` float32 or bfloat16, the band's dtype.

    Returns:
        ``C`` as ``[n, d]`` in ``b``'s dtype.
    """
    if b.device.type == "cuda":
        return banded_spmm_cuda(layout, b)
    if b.device.type == "cpu":
        return banded_spmm_plain(layout, b)
    raise ValueError(f"banded_spmm runs on CUDA or the CPU, not {b.device}")
