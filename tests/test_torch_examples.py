"""Smoke tests of the port's example scripts (``examples/torch_*.py``), each
on the CPU at a small size, in process (their ``main(argv)``)."""
from __future__ import annotations

import importlib.util
import pathlib
import sys

import pytest

from _torch_train_helpers import one_torch_thread  # noqa: F401

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"


def _example(name: str):
    if str(EXAMPLES) not in sys.path:
        # The train example's spawned ranks import it by name.
        sys.path.insert(0, str(EXAMPLES))
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_quickstart(capsys):
    _example("torch_quickstart").main(["--device", "cpu", "--n", "2048"])
    out = capsys.readouterr().out
    for name in ("er (random)", "ideal_diagonal", "fem blocks", "powerlaw",
                 "DispatchPlan("):
        assert name in out


def test_serve_lm(capsys):
    _example("torch_serve_lm").main(["--device", "cpu"])
    out = capsys.readouterr().out
    for arch in ("gemma3-12b", "recurrentgemma-9b", "falcon-mamba-7b"):
        assert f"{arch}" in out and "generated 12x4 tokens" in out
    assert "executed=12/12 planned" in out


def test_moe_block_sparse(capsys):
    rec = _example("torch_moe_block_sparse").main(["--device", "cpu",
                                                   "--tokens", "256"])
    assert rec["max_abs_err"] == 0.0
    assert "grouped matmul OK" in capsys.readouterr().out


@pytest.mark.parametrize("mesh", [None, "2,2"])
def test_train_lm(tmp_path, capsys, mesh):
    argv = ["--device", "cpu", "--steps", "12", "--ckpt-dir", str(tmp_path)]
    losses = _example("torch_train_lm").main(
        argv + (["--mesh", mesh] if mesh else []))
    assert len(losses) == 12
    assert "OK: trained, checkpointed, restarted" in capsys.readouterr().out
