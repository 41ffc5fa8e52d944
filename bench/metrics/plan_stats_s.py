"""``plan_stats_s``: seconds of the run's plan spent computing the
operator's structural statistics (degrees, blocks, diagonals, binned and
non-empty rows), the total of the program's ``spmm.plan.stat`` spans under
its ``spmm.plan`` root."""
import pathlib

from bench import spec

_spans = spec.load_module(pathlib.Path(__file__).resolve().parents[2],
                          "metrics", "classify_s")


def read(rec, spans=None):
    """Total seconds of ``spmm.plan.stat``."""
    return _spans.setup_total_s("spmm.plan.stat", "spmm.plan", spans)
