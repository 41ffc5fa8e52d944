"""``host_us.solve``: ``host_us.stream``'s quantity in the synchronous loop:
mean microseconds the host spends inside the program's call per request
(the wait excluded)."""
import pathlib

from bench import spec

read = spec.load_module(pathlib.Path(__file__).resolve().parents[2],
                        "metrics", "host_us.stream").read
