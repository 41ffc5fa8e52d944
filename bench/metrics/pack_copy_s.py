"""``pack_copy_s``: seconds of the run's pack spent copying the layout to
the card, the total of the program's ``spmm.pack.copy`` spans under its
``spmm.pack`` root."""
import pathlib

from bench import spec

_spans = spec.load_module(pathlib.Path(__file__).resolve().parents[2],
                          "metrics", "classify_s")


def read(rec, spans=None):
    """Total seconds of ``spmm.pack.copy``."""
    return _spans.setup_total_s("spmm.pack.copy", "spmm.pack", spans)
