"""Find what ``BENCHMARK.json`` names: a cell, its configuration and traffic
files, and the modules that generate, drive and read.

Everything that belongs to one configuration, traffic mix, generator,
driver or metric is a file of its own, found by its name:

* ``bench/configs/<config>.json`` (the ``file`` of the configuration entry),
* ``bench/traffic/<traffic>.json``,
* ``bench/gen/<generator>.py`` (the configuration's ``generator``),
* ``bench/drivers/<driver>.py`` (the traffic's ``driver``),
* ``bench/metrics/<metric>.py`` (every end-to-end and per-layer metric).

So a new cell, mix or metric is new files and new entries, never an edit.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
import re
import sys
from types import ModuleType

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with what it names, loaded."""

    name: str
    chips: int
    config: dict          # the configuration file's contents
    traffic: dict         # the traffic file's contents
    end_to_end: tuple     # the cell's end-to-end metric entries
    per_layer: tuple      # the cell's per-layer metric entries


def load_benchmark(root: pathlib.Path) -> dict:
    """``BENCHMARK.json`` at the checkout's root."""
    return json.loads((root / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def load_cell(root: pathlib.Path, name: str) -> Cell:
    """The cell ``name`` of the checkout at ``root``.

    Raises:
        KeyError: when ``BENCHMARK.json`` has no such cell or configuration.
    """
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; have {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "bench" / "traffic" / f"{_checked(w['traffic'])}.json")
        .read_text())
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        end_to_end=tuple(m for m in bench["end_to_end"] if _applies(m, name)),
        per_layer=tuple(m for m in bench["per_layer"] if _applies(m, name)))


def load_module(root: pathlib.Path, folder: str, name: str) -> ModuleType:
    """``bench/<folder>/<name>.py`` of the checkout at ``root``, imported by
    its path (a metric's name may hold dots)."""
    path = root / "bench" / folder / f"{_checked(name)}.py"
    key = f"bench_{folder}_{name}".replace(".", "_").replace("-", "_")
    cached = sys.modules.get(key)
    if cached is not None and getattr(cached, "__file__", None) == str(path):
        return cached
    spec = importlib.util.spec_from_file_location(key, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no {folder} module {name!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod
