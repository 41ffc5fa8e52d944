"""The comparison rejects the lower precision control and the planted
faults of the timed path, on small cells on the CPU.

The control is the port's own bf16-value path (``bf16i32``), the nearest
precision below the configurations' float32; on the card it reads
0.009-0.013 against sound runs' ~3e-7 (PERF.md). Each fault breaks the
kernel the plan replays, underneath the harness, and the rest of a run
(generation, plan, window, sample, reference) goes as in a benchmark run.
"""
import time

import pytest
import torch

from bench import run, spec
from conftest import SMALL


def _run(root, cell, **kw):
    return run.run_cell(root, spec.load_cell(root, cell), seed=2**31 + 9,
                        seconds=0.3, trace=False, device=torch.device("cpu"),
                        t0=time.perf_counter(), log=lambda s: None, **kw)


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails(small_root, cell, one_thread):
    sound = _run(small_root, cell)
    control = _run(small_root, cell, precision="bf16i32")
    assert sound["correct"] and not control["correct"]
    err = control["checks"]["max_rel_err"]["value"]
    assert err > 30 * control["checks"]["max_rel_err"]["limit"] \
        or err > 3e-3


def _stale(run_fn):
    """A step that returns its state unchanged: every request gets the
    first answer it computed."""
    first = []

    def broken(b):
        if not first:
            first.append(run_fn(b))
        return first[0]
    return broken


def _half(run_fn):
    """Half of the batch left out: the second half of B's columns is not
    computed, C's are zeros there."""
    def broken(b):
        c = run_fn(b).clone()
        c[:, c.shape[1] // 2:] = 0
        return c
    return broken


def _altered(run_fn):
    """An answer altered where it is produced: one element of C moves."""
    def broken(b):
        c = run_fn(b).clone()
        c[c.shape[0] // 3, 0] += 1.0
        return c
    return broken


@pytest.mark.parametrize("fault", [_stale, _half, _altered])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_faults_fail(small_root, cell, fault, monkeypatch, one_thread):
    from repro_torch.sparse import stream
    bind = stream.StreamPlan._bind
    monkeypatch.setattr(stream.StreamPlan, "_bind",
                        lambda self: fault(bind(self)))
    res = _run(small_root, cell)
    assert res["correct"] is False
