"""``pack_diagonals_s``: seconds of the run's pack spent building DIA
storage on the host (finding the diagonals and scattering the values into
``[k, n]``), the total of the program's ``spmm.pack.diagonals`` spans under
its ``spmm.pack`` root."""
import pathlib

from bench import spec

_spans = spec.load_module(pathlib.Path(__file__).resolve().parents[2],
                          "metrics", "classify_s")


def read(rec, spans=None):
    """Total seconds of ``spmm.pack.diagonals``; None where the run's pack
    built no DIA storage, or the program records no such span."""
    run = _spans.run_spans(spans)
    if run is None:
        return None
    _, found = _spans.under(run, "spmm.pack", "spmm.pack.diagonals")
    if not found:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / 1e9
