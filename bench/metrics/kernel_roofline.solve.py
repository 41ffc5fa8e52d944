"""``kernel_roofline.solve``: ``kernel_roofline`` in the synchronous
(``solve-*``) cells, kept apart because those cells spread more between
runs and report another metric."""
import pathlib

from bench import spec

read = spec.load_module(pathlib.Path(__file__).resolve().parents[2],
                        "metrics", "kernel_roofline").read
