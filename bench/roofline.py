"""The benchmark's fixed roofline count for one SpMM request, C = A @ B.

The count depends only on (n, nnz, d), never on the format or kernel that
serves the request, so a share of it compares any two versions of the
program on the same work:

* bytes: A as float32 CSR (4 B value + 4 B column index per nonzero, and
  4 B per row pointer, n + 1 of them), B ``[n, d]`` float32 read once and
  C ``[n, d]`` float32 written once;
* operations: 2 * nnz * d (one multiply and one add per nonzero and column).

The bound is the larger of bytes over the HBM bandwidth and operations
over the float32 rate outside the tensor cores. Both are NVIDIA's
published peaks of the H100 SXM part (the data sheet's dense rates, at its
700 W power limit). Every format the port may pick for the benchmark's
configurations stores at least these bytes, so an honest kernel cannot
read above 100 % of it; a format that stores A in fewer bytes (a full
diagonal band, 16-bit indices) needs this count revisited.
"""
from __future__ import annotations

#: HBM3 bandwidth of one H100 SXM, bytes per second.
HBM_BYTES_PER_S = 3.35e12
#: Float32 peak outside the tensor cores of one H100 SXM, FLOP per second.
FP32_FLOPS_PER_S = 67e12
#: L2 cache of one H100, bytes: a streamed mix's pool of B holds at least
#: four times it, so no request finds its B there and B is read from HBM.
L2_BYTES = 50 * 2**20

SIZEOF_VAL = 4
SIZEOF_IDX = 4


def request_flops(nnz: int, d: int) -> int:
    """Useful operations of one request: 2 * nnz * d."""
    return 2 * int(nnz) * int(d)


def request_bytes(n: int, nnz: int, d: int) -> int:
    """Bytes one request needs: A as float32 CSR, B read and C written once."""
    a = (SIZEOF_VAL + SIZEOF_IDX) * int(nnz) + SIZEOF_IDX * (int(n) + 1)
    return a + 2 * SIZEOF_VAL * int(n) * int(d)


def request_bound_s(n: int, nnz: int, d: int) -> float:
    """The least time one request can take on the card, in seconds."""
    return max(request_bytes(n, nnz, d) / HBM_BYTES_PER_S,
               request_flops(nnz, d) / FP32_FLOPS_PER_S)


def bound_side(n: int, nnz: int, d: int) -> str:
    """Which peak bounds the request: ``"bytes"`` or ``"operations"``."""
    return ("bytes" if request_bytes(n, nnz, d) / HBM_BYTES_PER_S
            >= request_flops(nnz, d) / FP32_FLOPS_PER_S else "operations")
