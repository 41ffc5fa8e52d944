"""``device_idle``: the traced segment's share, in %, in which no kernel,
copy or set ran on the card."""


def read(rec):
    """1 - busy / window over the traced segment."""
    tr = rec.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
