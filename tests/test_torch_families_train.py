"""One train step of the ``local``, ``vlm`` and ``encdec`` archs
(gemma3-12b, qwen2-vl-7b, whisper-base, reduced) against the reference's
``make_train_step(..., mesh=None)`` at fp32, on the data pipeline's batch:
whisper's ``frames`` and qwen2-vl's ``mm_embeds`` and ``positions_3d``
reach the model in both packages.  The inputs, runs and bounds are
``tests/_torch_train_helpers.py``'s (gradients within ``GRAD_RTOL`` of
each leaf's largest, loss within ``4 * eps_f32``, weights by the element
rule).  Also ``launch.train``'s ``--shape`` under ``--reduced``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest

from _torch_train_helpers import (BATCH, SEQ, _check_grads, _check_metrics,
                                  _check_params, _paths, _run_steps,
                                  _weights, use_fp32)
from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.configs.base import get_config as ref_config
from repro.models import model as ref_model
from repro.train import train_step as ref_ts
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch import train as train_cli
from repro_torch.models import model as port_model
from repro_torch.train.train_step import MODALITY_KEYS

ARCHS = ("gemma3-12b", "qwen2-vl-7b", "whisper-base")


def _pipeline_batch(cfg, seed=0) -> dict:
    """The data pipeline's batch of ``BATCH x SEQ`` tokens and labels with
    the arch's modality stubs."""
    return Pipeline(port_config(cfg.name.removesuffix("-smoke")).reduced(),
                    ShapeConfig("t", SEQ, BATCH, "train"),
                    DataConfig(seed=seed)).batch_for_step(0)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference_on_the_pipelines_batch(arch,
                                                             monkeypatch):
    """One step: loss, lr scale, grad_norm, every gradient leaf (against
    ``jax.grad`` of the reference's loss), the updated weights; the model
    saw the batch's modality entries."""
    use_fp32(monkeypatch)
    cfg = ref_config(arch).reduced()
    batch = _pipeline_batch(cfg)

    def ref_loss(p, b):
        logits = ref_model.forward(cfg, p, b, remat=True)
        return ref_ts.softmax_xent(logits, b["labels"], cfg.vocab_size)

    _, g_ref = jax.jit(jax.value_and_grad(ref_loss))(
        jax.tree.map(jnp.asarray, _weights(cfg)),
        jax.tree.map(jnp.asarray, batch))
    seen = []
    forward = port_model.LM.forward

    def recording(self, tokens, *a, **kw):
        seen.append(sorted(k for k in MODALITY_KEYS
                           if kw.get(k) is not None))
        return forward(self, tokens, *a, **kw)
    monkeypatch.setattr(port_model.LM, "forward", recording)
    m_r, m_p, want, got, grads, lr_scales = _run_steps(
        arch, 1, monkeypatch, make_batch=_pipeline_batch)
    assert seen == [sorted(k for k in MODALITY_KEYS if k in batch)]
    assert len(seen[0]) == (0 if arch == "gemma3-12b" else
                            1 if arch == "whisper-base" else 2)
    _check_metrics(m_r, m_p)
    _check_grads(grads[0], _paths(g_ref), f"{arch} gradients")
    _check_params(want, got, grads, lr_scales)


def test_reduced_trains_at_an_explicit_shape(tmp_path):
    """``--reduced --shape train_4k`` keeps ``train_4k``'s shape, as the
    reference does; ``--reduced`` alone takes the smoke shape."""
    argv = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
            "--ckpt-dir", str(tmp_path)]
    ap = train_cli.parser()
    assert train_cli.make_trainer(ap.parse_args(
        argv + ["--shape", "train_4k"])).shape == SHAPES["train_4k"]
    assert train_cli.make_trainer(ap.parse_args(argv)).shape == \
        train_cli.SMOKE_SHAPE
    assert train_cli.make_trainer(ap.parse_args(
        argv + ["--shape", "prefill_32k", "--seq-len", "64"])).shape == \
        ShapeConfig("custom", 64, SHAPES["prefill_32k"].global_batch,
                    "train")
