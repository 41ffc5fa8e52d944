"""``pack_host_s``: seconds of the run's pack spent on the host (convert
and pack the layout), the program's ``spmm.pack`` root less its
``spmm.pack.copy`` spans; with ``pack_copy_s`` it sums to the root."""
import pathlib

from bench import spec

_spans = spec.load_module(pathlib.Path(__file__).resolve().parents[2],
                          "metrics", "classify_s")


def read(rec, spans=None):
    """``spmm.pack`` roots' seconds minus ``pack_copy_s``."""
    run = _spans.run_spans(spans)
    if run is None:
        return None
    roots, copies = _spans.under(run, "spmm.pack", "spmm.pack.copy")
    if not roots:
        return None
    return (sum(s.end_ns - s.start_ns for s in roots)
            - sum(s.end_ns - s.start_ns for s in copies)) / 1e9
