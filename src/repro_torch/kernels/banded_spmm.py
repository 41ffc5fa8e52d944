"""Banded (diagonal-regime) SpMM as a walk over the stored diagonals.

The counterpart of the reference's ``banded_spmm_pallas``.  The layout is
DIA storage as ``sparse.formats.coo_to_dia`` builds it: the k sorted
diagonal offsets and their values ``diags[k, n]``, with

    C[r, :] = sum_j diags[j, r] * B[r + offsets[j], :]

(``diags[j, r]`` is 0 where ``r + offsets[j]`` leaves ``[0, n)``).  The
hand-written kernel ``csrc/banded_spmm.cu`` walks them, and so does the
plain version :func:`banded_spmm_plain`, with shifted slices.  No block
band is packed: the reference's ``band[nb, 2w+1, t, t]`` stores ``t *
(2w+1)`` slots a row, which for diagonals far apart (a 3-D stencil's)
is hundreds of times the k values the walk reads.  A band that comes from
the reference (``interop``) gives its diagonals through
:func:`band_diagonals`.

:func:`banded_spmm` runs the kernel for a CUDA operand and the plain
version for a CPU one.  Products are exact in fp32 and C is cast once.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import trace
from repro_torch.kernels import build
from repro_torch.kernels.csr_spmm import check_operands, value_code

#: Kernel launches made by :func:`banded_spmm` (a plain counter).
LAUNCHES = 0

#: How the kernel staged its B window, by the mode its launch reports
#: (``csrc/banded_spmm.cu``'s ``Window``, in its order): one bulk copy of
#: whole rows, 16-byte copies per column slice, plain loads, or none (the
#: window would pass the shared-memory budget, so B is read through L1).
WINDOWS = ("bulk", "async16", "scalar", "none")

#: Launches by window mode (the kernel's choice, reported per launch).
LAUNCHES_BY_WINDOW = dict.fromkeys(WINDOWS, 0)

#: Most diagonals the kernel walks (the DIA conversion's own cap).
MAX_DIAGONALS = 64

#: Output rows of one block of the kernel (its ``ROWS``): a block stages
#: ``k * ROWS`` diagonal values.
ROWS = 128

#: Shared memory a block may give its B window (the kernel's
#: ``WINDOW_BUDGET``); a wider window is not staged.
WINDOW_BUDGET = 96 * 1024


@dataclasses.dataclass(frozen=True)
class BandLayout:
    """The packed operand of :func:`banded_spmm`, on one device.

    ``offsets`` stays on the host: it is launch metadata, passed to the
    kernel by value.  Build one with :func:`dia_layout`.
    """

    offsets: torch.Tensor  # [k] int32 on the CPU, sorted diagonal offsets
    diags: torch.Tensor    # [k, n] float32 or bfloat16, A[r, r + offsets[j]]
    n: int

    @property
    def device(self) -> torch.device:
        """The device the layout lives on."""
        return self.diags.device


def dia_layout(diags: torch.Tensor, offsets: Sequence[int]) -> BandLayout:
    """The kernel's layout from DIA storage: ``diags[k, n]`` as it is (on
    its device) and the k sorted offsets as an int32 host tensor (the
    launch checks both)."""
    return BandLayout(offsets=torch.tensor([int(o) for o in offsets],
                                           dtype=torch.int32),
                      diags=diags, n=int(diags.shape[1]))


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
    """The kernel's layout from a host band (the reference's): its
    derived diagonals on ``device`` (None: the CPU); the band itself is
    not kept."""
    from repro_torch.sparse.formats import tensor_from_host
    offsets, diags = band_diagonals(band, w, t)
    return dia_layout(tensor_from_host(diags, device), offsets.tolist())


def banded_spmm_plain(layout: BandLayout, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the banded kernel on the same layout:
    the same walk, one shifted slice of B per diagonal, summed in fp32."""
    n, d = layout.n, b.shape[1]
    out = torch.zeros(n, d, dtype=torch.float32, device=b.device)
    for j, off in enumerate(layout.offsets.tolist()):
        lo, hi = max(0, -off), min(n, n - off)
        if hi > lo:
            out[lo:hi] += (layout.diags[j, lo:hi, None].to(torch.float32)
                           * b[lo + off:hi + off].to(torch.float32))
    return out.to(b.dtype)


_P = ctypes.c_void_p
_ARGTYPES = (ctypes.c_int, _P, _P, _P, ctypes.c_longlong, ctypes.c_int,
             ctypes.c_int, _P, _P, ctypes.POINTER(ctypes.c_int))


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
    n = layout.n
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
        raise ValueError(f"banded_spmm: b has {b.shape[0]} rows, the "
                         f"layout {n}")
    d = b.shape[1]
    if k == 0:                      # no stored diagonal: A is zero
        return torch.zeros(n, d, dtype=b.dtype, device=b.device)
    if traced:
        t_alloc = trace.now()
    c = torch.empty(n, d, dtype=b.dtype, device=b.device)
    if traced:
        t_launch = trace.now()
    mode = ctypes.c_int(-1)
    err = _kernel()(value_code(b.dtype), build.ptr(layout.diags),
                    build.ptr(b), build.ptr(c), n, d, k, build.ptr(offsets),
                    build.stream_ptr(b.device), ctypes.byref(mode))
    LAUNCHES += 1
    if 0 <= mode.value < len(WINDOWS):
        LAUNCHES_BY_WINDOW[WINDOWS[mode.value]] += 1
    if traced:
        trace.record_launch(t_check, t_alloc, t_launch)
    build.check(err, "banded_spmm")
    return c


def banded_spmm(layout: BandLayout, b: torch.Tensor) -> torch.Tensor:
    """``C = A @ B`` for banded A: the CUDA kernel for a CUDA operand,
    :func:`banded_spmm_plain` for a CPU one.

    Args:
        layout: the diagonals and their offsets (:func:`dia_layout`),
            on ``b``'s device.
        b: ``[n, d]`` float32 or bfloat16, the diagonals' dtype.

    Returns:
        ``C`` as ``[n, d]`` in ``b``'s dtype.
    """
    if b.device.type == "cuda":
        return banded_spmm_cuda(layout, b)
    if b.device.type == "cpu":
        return banded_spmm_plain(layout, b)
    raise ValueError(f"banded_spmm runs on CUDA or the CPU, not {b.device}")
