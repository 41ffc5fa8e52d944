"""Banded (diagonal-regime) SpMM as a walk over the stored diagonals.

The counterpart of the reference's ``banded_spmm_pallas``.  The layout
keeps the reference's block-band tensor ``band[nb, 2w+1, t, t]``
(``registry.band_to_blocks``): ``band[i, o]`` is the block at block
position ``(i, i + o - w)``, zero where out of range.  The plain version
:func:`banded_spmm_plain` multiplies its blocks.  From the band alone,
once per layout, :func:`band_diagonals` derives the k stored diagonals
(``offsets``, ``diags``) that the hand-written kernel
``csrc/banded_spmm.cu`` walks:

    C[r, :] = sum_j diags[j, r] * B[r + offsets[j], :]

:func:`banded_spmm` runs the kernel for a CUDA operand and the plain
version for a CPU one.  Products are exact in fp32 and C is cast once.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.kernels import build
from repro_torch.kernels.csr_spmm import check_operands, value_code

#: Kernel launches made by :func:`banded_spmm` (a plain counter).
LAUNCHES = 0

#: Most diagonals the kernel walks (the DIA conversion's own cap).
MAX_DIAGONALS = 64


@dataclasses.dataclass(frozen=True)
class BandLayout:
    """The packed operand of :func:`banded_spmm`, on one device.

    ``offsets`` stays on the host: it is launch metadata, passed to the
    kernel by value.  Build one with :func:`band_layout`.
    """

    band: torch.Tensor     # [nb, 2w+1, t, t] float32 or bfloat16
    w: int                 # half-bandwidth in blocks
    t: int                 # block edge
    offsets: torch.Tensor  # [k] int32 on the CPU, sorted diagonal offsets
    diags: torch.Tensor    # [k, nb * t] band dtype, A[r, r + offsets[j]]

    @property
    def nb(self) -> int:
        """Block rows."""
        return int(self.band.shape[0])

    @property
    def device(self) -> torch.device:
        """The device the layout lives on."""
        return self.band.device


def band_diagonals(band: np.ndarray, w: int, t: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The stored diagonals of a block-band tensor, from the band alone.

    A diagonal is kept when any of its slots in the band is not all zero
    bits (so a stored ``-0.0`` keeps it and an all-zero one is dropped).

    Args:
        band: numpy ``[nb, 2w+1, t, t]`` (float32, or bf16 as ``uint16``
            bits or numpy ``bfloat16``).
        w: half-bandwidth in blocks.
        t: block edge.

    Returns:
        ``(offsets, diags)``: int32 ``[k]`` sorted offsets and ``[k, nb *
        t]`` values in the band's dtype, ``diags[j, r] = A[r, r +
        offsets[j]]`` and 0 where ``r + offsets[j]`` leaves ``[0, n)``.
    """
    band = np.asarray(band)
    nb, W = band.shape[:2]
    if W != 2 * w + 1 or band.shape[2:] != (t, t):
        raise ValueError(f"band shape {band.shape} does not match w={w}, "
                         f"t={t}")
    bits = band.view(np.uint16 if band.dtype.itemsize == 2 else np.uint32)
    used = np.bitwise_or.reduce(bits, axis=0) != 0          # [W, t, t]
    o, rr, cc = np.nonzero(used)
    offsets = np.unique((o.astype(np.int64) - w) * t + cc - rr)
    n = nb * t
    r = np.arange(n, dtype=np.int64)
    diags = np.zeros((offsets.shape[0], n), dtype=band.dtype)
    for j, off in enumerate(offsets):
        c = r + off
        oj = c // t - r // t + w
        keep = (c >= 0) & (c < n) & (oj >= 0) & (oj < W)
        rk, ck = r[keep], c[keep]
        diags[j, rk] = band[rk // t, oj[keep], rk % t, ck % t]
    return offsets.astype(np.int32), diags


def band_layout(band: np.ndarray, w: int, t: int, device=None) -> BandLayout:
    """The kernel's layout from a host band: the band and its derived
    diagonals on ``device`` (None: the CPU), the offsets on the host."""
    from repro_torch.sparse.formats import tensor_from_host
    offsets, diags = band_diagonals(band, w, t)
    return BandLayout(band=tensor_from_host(band, device), w=int(w),
                      t=int(t), offsets=torch.from_numpy(offsets),
                      diags=tensor_from_host(diags, device))


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
_ARGTYPES = (ctypes.c_int, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, _P, _P)


def _kernel():
    fn = build.library("banded_spmm").banded_spmm_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    return fn


def banded_spmm_cuda(layout: BandLayout, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel (``csrc/banded_spmm.cu``) on a CUDA operand."""
    global LAUNCHES
    traced = trace.recording()
    if traced:
        t_check = trace.now()
    n = layout.nb * layout.t
    k = int(layout.offsets.shape[0])
    offsets = layout.offsets
    if k > MAX_DIAGONALS:
        raise ValueError(f"banded_spmm: the kernel walks at most "
                         f"{MAX_DIAGONALS} diagonals, the layout has {k}")
    if (offsets.device.type != "cpu" or offsets.dtype != torch.int32
            or not offsets.is_contiguous()):
        raise ValueError("banded_spmm: offsets must be a contiguous int32 "
                         "tensor on the host")
    if tuple(layout.diags.shape) != (k, n):
        raise ValueError(f"banded_spmm: diags {tuple(layout.diags.shape)} "
                         f"is not [{k}, {n}]")
    check_operands("banded_spmm", (layout.diags,), b, layout.diags)
    if b.shape[0] != n:
        raise ValueError(f"banded_spmm: b has {b.shape[0]} rows, the band "
                         f"{n}")
    d = b.shape[1]
    if k == 0:                      # no stored diagonal: A is zero
        return torch.zeros(n, d, dtype=b.dtype, device=b.device)
    if traced:
        t_alloc = trace.now()
    c = torch.empty(n, d, dtype=b.dtype, device=b.device)
    if traced:
        t_launch = trace.now()
    err = _kernel()(value_code(b.dtype), build.ptr(layout.diags),
                    build.ptr(b), build.ptr(c), n, d, k, build.ptr(offsets),
                    build.stream_ptr(b.device))
    LAUNCHES += 1
    if traced:
        trace.record_launch(t_check, t_alloc, t_launch)
    build.check(err, "banded_spmm")
    return c


def banded_spmm(layout: BandLayout, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` for banded A: the CUDA kernel for a CUDA operand,
    :func:`banded_spmm_plain` for a CPU one.

    Args:
        layout: the band and its diagonals (:func:`band_layout`), on
            ``b``'s device.
        b: ``[nb * t, d]`` float32 or bfloat16, the band's dtype.

    Returns:
        ``C`` as ``[n, d]`` in ``b``'s dtype.
    """
    if b.device.type == "cuda":
        return banded_spmm_cuda(layout, b)
    if b.device.type == "cpu":
        return banded_spmm_plain(layout, b)
    raise ValueError(f"banded_spmm runs on CUDA or the CPU, not {b.device}")
