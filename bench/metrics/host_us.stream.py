"""``host_us.stream``: mean microseconds the host spends inside the
program's call per request when it enqueues without waiting."""


def read(rec):
    """Mean host time per call, over the window's requests."""
    host = rec.served.host_s
    return sum(host) / len(host) * 1e6 if host else None
