"""``req_p95_ms``: the 95th percentile, in ms, of every request's latency in
the window (call to synchronised answer); None where the traffic does not
wait on each request."""
import statistics


def read(rec):
    """The 95th of ``statistics.quantiles(n=100)`` over all latencies."""
    lat = rec.served.latency_s
    if not lat or len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100)[94] * 1e3
