"""``spmm_mfu``: the window's requests' fixed roofline over the window's
seconds, in %: the whole request's share of the chip's peak."""


def read(rec):
    """Requests times the bound of one, over the window."""
    if rec.served.requests <= 0:
        return None
    return 100.0 * rec.served.requests * rec.bound_s / rec.served.window_s
