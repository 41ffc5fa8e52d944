"""Three train steps of each of the five archs, and the step's variants
(``remat=False``, ``grad_accum=2``, ``chunked_loss=True``), of the port
against ``repro.train.train_step.make_train_step(..., mesh=None)`` on the
CPU at fp32.  Inputs, runs and bounds: ``tests/_torch_train_helpers.py``.
"""
from __future__ import annotations

import pytest

from _torch_train_helpers import (ARCHS, _check_metrics, _check_params,
                                  _run_steps, use_fp32)
from _torch_train_helpers import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def fp32(monkeypatch):
    use_fp32(monkeypatch)


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_reference(arch, monkeypatch):
    m_r, m_p, want, got, grads, lr_scales = _run_steps(arch, 3, monkeypatch)
    _check_metrics(m_r, m_p)
    _check_params(want, got, grads, lr_scales)


@pytest.mark.parametrize("arch,variant", [
    ("olmoe-1b-7b", "no_remat"), ("llama3.2-1b", "no_remat"),
    ("olmoe-1b-7b", "grad_accum"), ("gemma-2b", "grad_accum"),
    ("olmoe-1b-7b", "chunked_loss"), ("gemma-2b", "chunked_loss")])
def test_train_step_variants_match_reference(arch, variant, monkeypatch):
    """Two steps with ``remat=False``, ``grad_accum=2`` or
    ``chunked_loss=True`` (gemma: the tied table; olmoe: ``lm_head``)."""
    kw = {"no_remat": {"remat": False}, "grad_accum": {"grad_accum": 2},
          "chunked_loss": {"chunked": True}}[variant]
    m_r, m_p, want, got, grads, lr_scales = _run_steps(arch, 2, monkeypatch,
                                                       **kw)
    _check_metrics(m_r, m_p)
    _check_params(want, got, grads, lr_scales)
