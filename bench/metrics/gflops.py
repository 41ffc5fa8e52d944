"""``gflops``: useful GFLOP/s over the whole window, all requests' 2*nnz*d
over the seconds from the first call until the last answer."""


def read(rec):
    """Requests times their operations, over the window."""
    return rec.served.requests * rec.flops / rec.served.window_s / 1e9
