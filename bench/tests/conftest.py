"""Shared fixtures of the benchmark's own tests (``python -m pytest bench/tests``).

They run on the CPU at small sizes, except those marked ``gpu``, which
decide inside a fixture whether a card is present.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

#: The small cells the CPU tests run: cell -> (config, traffic, the
#: benchmark's cell whose metrics it reports).
SMALL = {"scalefree-small.stream-d64": ("scalefree-small", "stream-d64",
                                        "scalefree.stream-d64"),
         "fem-small.solve-d4": ("fem-small", "solve-d4", "fem.solve-d4")}


def small_config(name: str, n: int = 4096) -> dict:
    """A configuration of the benchmark cut to ``n`` rows for the CPU."""
    base = {"scalefree-small": "scalefree-n20", "fem-small": "fem-n20"}[name]
    cfg = json.loads((ROOT / "bench" / "configs" / f"{base}.json").read_text())
    cfg = dict(cfg, name=name, n=n)
    if "num_blocks" in cfg["params"]:
        cfg["params"] = dict(cfg["params"], num_blocks=n // 16)
    return cfg


def copy_checkout(dest: pathlib.Path) -> pathlib.Path:
    """``BENCHMARK.json`` and ``bench/`` copied to ``dest``."""
    shutil.copytree(ROOT / "bench", dest / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def add_small_cells(root: pathlib.Path) -> pathlib.Path:
    """Add :data:`SMALL`'s configurations and cells to the checkout at
    ``root``, as new files and new entries only."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell, (config, traffic, like) in SMALL.items():
        path = root / "bench" / "configs" / f"{config}.json"
        if not path.exists():
            path.write_text(json.dumps(small_config(config)))
            bench["configs"].append({
                "name": config, "source": "test", "reduced": ["n"],
                "file": f"bench/configs/{config}.json", "why": "CPU test"})
        bench["workloads"].append({"name": cell, "config": config,
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU test"})
        for metric in bench["per_layer"] + bench["end_to_end"]:
            if like in metric.get("workloads", ()):
                metric["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def small_root(tmp_path):
    """A checkout copy with the small CPU cells added."""
    return add_small_cells(copy_checkout(tmp_path))


@pytest.fixture
def one_thread():
    """Torch on one thread while a test runs."""
    import torch
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
