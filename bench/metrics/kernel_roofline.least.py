"""``kernel_roofline.least``: the least roofline of one request
(``bench/roofline_least.py``: A's values alone, B once, C once) over the
device time per request of the program's kernels in the traced segment,
in %."""
from bench import roofline_least


def read(rec):
    """None where the trace saw none of the program's kernels."""
    tr = rec.trace
    if tr is None or tr.port_kernel_s <= 0 or tr.requests <= 0:
        return None
    bound = roofline_least.request_bound_s(rec.n, rec.nnz, rec.d)
    return 100.0 * bound / (tr.port_kernel_s / tr.requests)
