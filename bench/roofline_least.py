"""The least roofline of one SpMM request, C = A @ B: what any storage of A
must read.

* bytes: A's nonzero values at 4 B each and no index at all, B ``[n, d]``
  float32 read once and C ``[n, d]`` float32 written once;
* operations: 2 * nnz * d.

The bound is the larger of the bytes over the HBM bandwidth and the
operations over the float32 rate outside the tensor cores (the peaks of
``bench/roofline.py``, the H100 SXM's published ones). Every format stores
at least the values, so no honest kernel reads above 100 % of it, where
``bench/roofline.py``'s count, which charges A as CSR, is above what DIA
storage holds (no per-entry index).
"""
from __future__ import annotations

from bench.roofline import FP32_FLOPS_PER_S, HBM_BYTES_PER_S, SIZEOF_VAL


def request_bytes(n: int, nnz: int, d: int) -> int:
    """Bytes one request needs at least: the values, B once, C once."""
    return SIZEOF_VAL * int(nnz) + 2 * SIZEOF_VAL * int(n) * int(d)


def request_bound_s(n: int, nnz: int, d: int) -> float:
    """The least time one request can take on the card, in seconds."""
    return max(request_bytes(n, nnz, d) / HBM_BYTES_PER_S,
               2 * int(nnz) * int(d) / FP32_FLOPS_PER_S)
