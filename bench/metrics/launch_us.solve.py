"""``launch_us.solve``: mean microseconds per request that the synchronous
request path spends in the kernel's ``ctypes`` launch, the program's
``spmm.launch`` spans per ``spmm.execute`` root, in the traced segment."""
import pathlib

from bench import spec

_check = spec.load_module(pathlib.Path(__file__).resolve().parents[2],
                          "metrics", "check_us.solve")


def read(rec, spans=None):
    """Mean µs of ``spmm.launch`` per request."""
    return _check.per_request_us("spmm.launch", spans)
