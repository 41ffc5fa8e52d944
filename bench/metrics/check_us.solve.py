"""``check_us.solve``: mean microseconds per request that the synchronous
request path spends checking operands, the program's ``spmm.check`` spans
under its ``spmm.execute`` roots over the number of roots.

Request spans record only under the profiler, so this reads the traced
segment and includes the profiler's cost per operation inside the part;
``host_us.solve``, taken untraced, stays the layer's total."""
import pathlib

from bench import spec

_spans = spec.load_module(pathlib.Path(__file__).resolve().parents[2],
                          "metrics", "classify_s")


def per_request_us(name: str, spans=None):
    """Mean microseconds in the spans ``name`` per ``spmm.execute`` root of
    the run; 0.0 where there are none, None where the run has no root."""
    run = _spans.run_spans(spans)
    if run is None:
        return None
    roots, found = _spans.under(run, "spmm.execute", name)
    if not roots:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / len(roots) / 1e3


def read(rec, spans=None):
    """Mean µs of ``spmm.check`` per request."""
    return per_request_us("spmm.check", spans)
