"""``spmm_mfu.least``: the window's requests times the least roofline of
one (``bench/roofline_least.py``), over the window's seconds, in %."""
from bench import roofline_least


def read(rec):
    """Requests times the least bound of one, over the window."""
    if rec.served.requests <= 0:
        return None
    bound = roofline_least.request_bound_s(rec.n, rec.nnz, rec.d)
    return 100.0 * rec.served.requests * bound / rec.served.window_s
