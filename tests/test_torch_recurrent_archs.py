"""The port's ``ssm`` and ``hybrid`` archs against the reference, on the
CPU: falcon-mamba-7b and recurrentgemma-9b at their reduced configs
(``tests/test_torch_recurrent.py`` holds the units, the full-size counts
and the port's decode against its forward).

Weights are drawn by the port from a seed, sent to the reference's layout
through ``interop.params_to_numpy`` with every norm scale and bias moved
off its init by seeded noise, and loaded back through
``interop.params_from_numpy``; tokens come from the data pipeline.

* ``forward`` logits and 32 teacher-forced ``decode_step`` calls against
  the reference's: fp32 (``use_fp32``) within ``1e-4`` of each row's
  largest |logit|; bf16 within ``models.model.logit_tolerance``, whose
  roundings count each kind of layer (``models.model.roundings``).
* ``generate`` at bf16: a greedy token may differ only where the
  reference's top-2 margin is within twice that bound, as in
  ``tests/test_torch_families.py``.
* ``interop``: the round trip exactly, recurrentgemma's 19-kind pattern
  by group, and the serving dtype policy.

Seconds in the suite's six-worker run are in ``CHANGES.md``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_helpers import use_fp32
from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.configs.base import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.models import model as ref_model
from repro_torch import interop
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch import serve as port_serve
from repro_torch.models import model as port_model

ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b")
BATCH, GEN = 2, 8
RTOL32 = 1e-4

#: Tokens per sequence at arch level.
STEPS = 32


@pytest.fixture(params=["fp32", "bf16"])
def arch_precision(request, monkeypatch):
    if request.param == "fp32":
        use_fp32(monkeypatch)
    return request.param


@pytest.fixture(scope="module")
def trees():
    """Each arch's reference weights as numpy, made once for the file."""
    return {}


def _weights(arch) -> dict:
    """The reduced arch's weights in the reference's layout, as numpy: the
    port's seeded init (which draws as the reference's ``init_params``
    does) through ``interop.params_to_numpy``, each norm scale and bias
    moved off its init by ``N(0, 0.1**2)`` / ``N(0, 0.02**2)``."""
    lm = port_model.LM(port_config(arch).reduced(), device="cpu",
                       generator=torch.Generator().manual_seed(0),
                       masters=True)
    tree = interop.params_to_numpy(lm)
    rng = np.random.default_rng(1)

    def redraw(node):
        for key, value in node.items():
            if isinstance(value, dict):
                redraw(value)
            elif key in ("scale", "bias"):
                std = 0.1 if key == "scale" else 0.02
                node[key] = (value + rng.normal(size=value.shape) * std
                             ).astype(np.float32)
    redraw(tree)
    return tree


def _models(arch, trees):
    cfg = ref_config(arch).reduced()
    if arch not in trees:
        trees[arch] = _weights(arch)
    tree = trees[arch]
    model = interop.params_from_numpy(port_config(arch).reduced(), tree)
    return cfg, jax.tree.map(jnp.asarray, tree), model


def _tokens(arch, seq=STEPS, batch=BATCH) -> np.ndarray:
    return Pipeline(port_config(arch).reduced(),
                    ShapeConfig("t", seq, batch, "train"),
                    DataConfig(seed=0)).batch_for_step(0)["tokens"]


def _bound(cfg, ref, precision):
    r = ref.astype(np.float64)
    if precision == "fp32":
        return RTOL32 * np.abs(r).max(axis=-1, keepdims=True)
    rms = np.sqrt((r ** 2).mean(axis=-1, keepdims=True))
    return port_model.logit_tolerance(cfg, torch.from_numpy(rms),
                                      r.size).numpy()


def _check_logits(cfg, got, ref, precision, what):
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    excess = float((np.abs(got - ref) - _bound(cfg, ref, precision)).max())
    assert excess <= 0, f"{what}: exceeds the {precision} bound by " \
        f"{excess:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch, arch_precision, trees):
    cfg, params, model = _models(arch, trees)
    toks = _tokens(arch)
    ref = np.asarray(jax.jit(lambda p, t: ref_model.forward(
        cfg, p, {"tokens": t}))(params, jnp.asarray(toks)))
    got = model(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32
    _check_logits(cfg, got, ref, arch_precision, f"{arch} forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_teacher_forced(arch, arch_precision, trees):
    cfg, params, model = _models(arch, trees)
    toks = _tokens(arch)
    step = jax.jit(lambda p, c, t, pos: ref_model.decode_step(cfg, p, c, t,
                                                              pos))
    cache_r = ref_model.init_cache(cfg, BATCH, STEPS)
    cache_p = model.init_cache(BATCH, STEPS)
    kinds = port_model.layer_kinds(model.cfg)
    for kind, layer in zip(kinds, cache_p):
        want = {"k", "v"} if kind == "local" else {"conv", "h"}
        assert set(layer) == want, kind
        if kind != "local":
            assert layer["conv"].dtype == model.dtype and \
                layer["h"].dtype == torch.float32
    ref, got = [], []
    with torch.inference_mode():
        for t in range(STEPS):
            logits, cache_r = step(params, cache_r, jnp.asarray(toks[:, t]),
                                   jnp.int32(t))
            ref.append(np.asarray(logits))
            got.append(model.decode_step(cache_p, torch.from_numpy(toks[:, t]),
                                         t).numpy())
    _check_logits(cfg, np.stack(got), np.stack(ref), arch_precision,
                  f"{arch} decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches(arch, trees, monkeypatch):
    """At bf16, the serving dtype: greedy tokens equal the reference's
    ``generate``."""
    cfg, params, model = _models(arch, trees)
    logits = []
    ref_step = ref_model.decode_step

    def recording_step(cfg_, p, c, t, pos, **kw):
        out, cache = ref_step(cfg_, p, c, t, pos, **kw)
        jax.debug.callback(lambda v: logits.append(np.asarray(v)), out,
                           ordered=True)
        return out, cache
    monkeypatch.setattr(ref_model, "decode_step", recording_step)
    prompts = port_serve.lm_prompts(cfg.vocab_size, BATCH, STEPS)
    ref = ref_serve.generate(cfg, params, prompts, GEN)
    out = port_serve.generate(model, prompts, GEN)
    jax.effects_barrier()
    assert out.tokens.shape == ref.shape == (BATCH, GEN)
    ref_logits = np.stack(logits[STEPS - 1:])[..., :cfg.vocab_size]
    for b in range(BATCH):
        for g in range(GEN):
            if out.tokens[b, g] == ref[b, g]:
                continue
            row = ref_logits[g, b]
            top2 = -np.sort(-row)[:2]
            slack = 2 * float(_bound(cfg, row[None], "bf16").max())
            assert top2[0] - top2[1] <= slack, \
                f"{arch} row {b} token {g}: {out.tokens[b, g]} vs " \
                f"{ref[b, g]} at top-2 margin {top2[0] - top2[1]:.3e}"
            break                           # the sequences diverge here


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_round_trip_is_exact(arch, trees):
    _models(arch, trees)
    tree = trees[arch]
    for masters in (False, True):
        model = interop.params_from_numpy(port_config(arch).reduced(), tree,
                                          dtype=torch.float32,
                                          masters=masters)
        back = interop.params_to_numpy(model)
        want = jax.tree_util.tree_flatten_with_path(tree)[0]
        got = dict((jax.tree_util.keystr(k), v) for k, v in
                   jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(got) == len(want)
        for k, v in want:
            assert np.array_equal(got[jax.tree_util.keystr(k)], v), k


def test_interop_maps_the_19_kind_pattern_by_group(trees):
    """recurrentgemma's pattern of 19 kinds, two groups: layer ``g * 19 +
    j`` is entry ``g`` of ``layers["p{j}"]`` (group 1 is group 0's weights
    plus 1)."""
    arch = "recurrentgemma-9b"
    _models(arch, trees)
    cfg = dataclasses.replace(ref_config(arch).reduced(), num_layers=38)
    tree = dict(trees[arch])
    tree["layers"] = jax.tree.map(lambda a: np.concatenate([a, a + 1]),
                                  tree["layers"])
    model = interop.params_from_numpy(
        dataclasses.replace(port_config("recurrentgemma-9b").reduced(),
                            num_layers=38), tree, dtype=torch.float32)
    layers = tree["layers"]
    for i, block in enumerate(model.layers):
        g, j = divmod(i, 19)
        kind = cfg.layer_pattern[j]
        if kind == "rglru":
            got, want = block.rglru.lam, layers[f"p{j}"]["rglru"]["lam"][g]
        else:
            got = block.attn.wq.kernel
            want = layers[f"p{j}"]["attn"]["wq"]["kernel"][g]
        assert np.array_equal(got.float().numpy(), want), (i, kind)
    assert isinstance(model.layers[20], port_model.RGLRUBlock)
    assert isinstance(model.layers[21], port_model.Block)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_dtypes(arch, trees):
    """Matrices, ``D``, the conv, biases and the gate blocks in the compute
    dtype (the reference casts them per use); ``A_log``, ``lam`` and the
    norm scales in fp32; training masters all fp32."""
    _models(arch, trees)
    model = interop.params_from_numpy(port_config(arch).reduced(),
                                      trees[arch])
    fp32 = ("A_log", "lam", "scale")
    for name, p in model.named_parameters():
        want = torch.float32 if name.endswith(fp32) else torch.bfloat16
        assert p.dtype == want and not p.requires_grad, name
    masters = interop.params_from_numpy(port_config(arch).reduced(),
                                        trees[arch], masters=True)
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in masters.parameters())
