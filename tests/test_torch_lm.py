"""The port's LM (``repro_torch.models.model``, ``launch.serve.generate``)
against the reference's, on the reduced configs of the five archs it runs.

The reference's ``init_params`` weights (its norm scales and biases
redrawn from a seed so that they are not the identity) go to the port
through ``interop.params_from_numpy``; the prompts come from numpy with a
seed.  Three paths are held to the reference at fp32 (both packages'
``COMPUTE_DTYPE`` monkeypatched) and at bf16, the serving dtype:

* ``decode_step``, teacher-forced over 8 steps, logits at every step;
* ``forward``, logits at every position;
* ``generate`` (bf16 only), greedy tokens (``launch/serve.py``'s
  ``generate``).

Bounds: fp32 logits within ``1e-4`` of each row's largest |logit|; bf16
logits within ``models.model.logit_tolerance``, the rounding bound of two
runs that round the same quantities to bf16 (derived there).

Routing: both packages' routers are recorded (the reference's through
``jax.debug.callback``).  Where a token's top-k set differs, its logit
margin (k-th minus (k+1)-th, in the reference) must be within twice the
largest difference the two routers' logits can have, ``|x_port - x_ref| @
|W| + 2 gamma_d (|x| @ |W|)``, from the recorded inputs; the sequence
that token belongs to is then left out of the logits comparison from that
step on (for ``forward``, with every sequence routed to an expert that
the change may push over capacity).  A greedy token may differ only where
the reference's top-2 logit margin is within twice the bound; that
sequence is compared no further.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro_torch import interop
from repro_torch.configs import get_config as port_config
from repro_torch.launch import serve as port_serve
from repro_torch.models import model as port_model
from repro_torch.models import moe as port_moe

ARCHS = ("llama3.2-1b", "gemma-2b", "qwen2-72b", "olmoe-1b-7b",
         "qwen3-moe-235b-a22b")
BATCH, STEPS, GEN = 4, 8, 8
RTOL32 = 1e-4
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(params=["fp32", "bf16"])
def precision(request, monkeypatch):
    if request.param == "fp32":
        monkeypatch.setattr(ref_model, "COMPUTE_DTYPE", jnp.float32)
        monkeypatch.setattr(port_model, "COMPUTE_DTYPE", torch.float32)
    return request.param


class Routes:
    """Each router call of both packages, in call order: the router's
    input (fp32) and the top-k ids."""

    def __init__(self, monkeypatch):
        self.ref, self.port = [], []
        ref_router, port_router = ref_moe._router, port_moe.router

        def record(x, ids):
            self.ref.append((np.asarray(x), np.asarray(ids)))

        def ref_patched(params, x, k):
            weights, ids = ref_router(params, x, k)
            jax.debug.callback(record, x.astype(jnp.float32), ids,
                               ordered=True)
            return weights, ids

        def port_patched(x, kernel, k):
            weights, ids = port_router(x, kernel, k)
            self.port.append((x.float().numpy(), ids.numpy()))
            return weights, ids

        monkeypatch.setattr(ref_moe, "_router", ref_patched)
        monkeypatch.setattr(port_moe, "router", port_patched)

    def flips(self, routers, k: int):
        """Per call, the tokens whose top-k sets differ; each must sit at a
        logit margin within the routers' error bound."""
        jax.effects_barrier()
        assert len(self.ref) == len(self.port) > 0
        out = []
        for i, ((x_r, ids_r), (x_p, ids_p)) in enumerate(zip(self.ref,
                                                             self.port)):
            w = routers[i % len(routers)].astype(np.float64)
            d = x_r.shape[-1]
            gamma = d * EPS32 / 2 / (1 - d * EPS32 / 2)
            dz = np.abs(x_p - x_r) @ np.abs(w) + \
                2 * gamma * (np.abs(x_r) @ np.abs(w))
            zs = -np.sort(-(x_r.astype(np.float64) @ w), axis=-1)
            margin = zs[:, k - 1] - zs[:, k]
            differ = np.array([set(a) != set(b)
                               for a, b in zip(ids_r, ids_p)])
            slack = 2 * dz.max(axis=-1)
            assert np.all(~differ | (margin <= slack)), \
                f"router call {i}: ids differ at margin {margin[differ]} " \
                f"above {slack[differ]}"
            out.append((differ, ids_r, ids_p))
        return out


@pytest.fixture(scope="module")
def trees():
    """Each arch's reference weights as numpy, made once for the file."""
    return {}


def _models(arch: str, precision: str, trees: dict):
    """The reference's reduced config and weights, and the port's model of
    the same weights."""
    cfg = ref_config(arch).reduced()
    if arch not in trees:
        trees[arch] = _weights(cfg)
    tree = trees[arch]
    model = interop.params_from_numpy(port_config(arch).reduced(), tree)
    assert model.dtype == (torch.float32 if precision == "fp32"
                           else torch.bfloat16)
    routers = [tree["layers"]["p0"]["moe"]["router"]["kernel"][i]
               for i in range(cfg.num_layers)] if cfg.num_experts else []
    return cfg, jax.tree.map(jnp.asarray, tree), model, routers


def _weights(cfg) -> dict:
    """The reference's ``init_params``, its norm scales and biases redrawn
    from a seed so that they are not the identity."""
    tree = jax.tree.map(np.asarray,
                        ref_model.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def redraw(node):
        for key, value in node.items():
            if isinstance(value, dict):
                redraw(value)
            elif key == "scale":
                node[key] = rng.normal(size=value.shape).astype(
                    np.float32) * 0.1
            elif key == "bias":
                node[key] = rng.normal(size=value.shape).astype(
                    np.float32) * 0.02
    redraw(tree)
    return tree


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(
        2, cfg.vocab_size - 1, size=shape).astype(np.int32)


def _bound(cfg, ref: np.ndarray, precision: str) -> np.ndarray:
    """Allowed |port - reference| per logit (rows on the last axis)."""
    r = ref.astype(np.float64)
    if precision == "fp32":
        return RTOL32 * np.abs(r).max(axis=-1, keepdims=True)
    rms = np.sqrt((r ** 2).mean(axis=-1, keepdims=True))
    return port_model.logit_tolerance(cfg, torch.from_numpy(rms),
                                      r.size).numpy()


def _check_logits(cfg, got, ref, compare, precision, what):
    """``got`` within the bound of ``ref`` on the rows ``compare`` selects
    (every axis but the last)."""
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    assert compare.any(), f"{what}: no row left to compare"
    excess = (np.abs(got - ref) - _bound(cfg, ref, precision)).max(axis=-1)
    worst = float(excess[compare].max())
    assert worst <= 0, f"{what}: exceeds the {precision} bound by {worst:.3e}"


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_teacher_forced(arch, precision, monkeypatch,
                                           trees):
    routes = Routes(monkeypatch)
    cfg, params, model, routers = _models(arch, precision, trees)
    toks = _tokens(cfg, (BATCH, STEPS))
    step = jax.jit(lambda p, c, t, pos: ref_model.decode_step(cfg, p, c, t,
                                                              pos))
    cache_r = ref_model.init_cache(cfg, BATCH, STEPS)
    cache_p = model.init_cache(BATCH, STEPS)
    ref, got = [], []
    for t in range(STEPS):
        logits, cache_r = step(params, cache_r, jnp.asarray(toks[:, t]),
                               jnp.int32(t))
        ref.append(np.asarray(logits))
        got.append(model.decode_step(cache_p, torch.from_numpy(toks[:, t]),
                                     t).numpy())
    ref, got = np.stack(ref), np.stack(got)          # [STEPS, B, V]
    assert got.dtype == np.float32 and got.shape == (STEPS, BATCH,
                                                     cfg.padded_vocab)
    diverged = np.zeros((STEPS, BATCH), dtype=bool)
    if cfg.num_experts:
        calls = routes.flips(routers, cfg.num_experts_per_token)
        for i, (differ, _, _) in enumerate(calls):
            diverged[i // cfg.num_layers] |= differ
        diverged = np.logical_or.accumulate(diverged, axis=0)
    _check_logits(cfg, got, ref, ~diverged, precision, f"{arch} decode")


def _forward_diverged(cfg, calls) -> np.ndarray:
    """Sequences a routing difference may have changed: those holding a
    token whose top-k set differs, and every sequence routed to an expert
    in that difference when it is over capacity in either package."""
    T = BATCH * STEPS
    k = cfg.num_experts_per_token
    cap = port_moe.capacity(T, k, cfg.num_experts, cfg.moe_capacity_factor)
    diverged = np.zeros(BATCH, dtype=bool)
    for differ, ids_r, ids_p in calls:
        for t in np.flatnonzero(differ):
            diverged[t // STEPS] = True
            for e in set(ids_r[t]) ^ set(ids_p[t]):
                full = max((ids_r == e).sum(), (ids_p == e).sum()) > cap
                if full:
                    hit = (ids_r == e).any(axis=1) | (ids_p == e).any(axis=1)
                    diverged[np.unique(np.flatnonzero(hit) // STEPS)] = True
    return diverged


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(arch, precision, monkeypatch, trees):
    routes = Routes(monkeypatch)
    cfg, params, model, routers = _models(arch, precision, trees)
    toks = _tokens(cfg, (BATCH, STEPS))
    ref = np.asarray(jax.jit(lambda p, b: ref_model.forward(cfg, p, b))(
        params, {"tokens": jnp.asarray(toks)}))
    got = model(torch.from_numpy(toks)).numpy()
    assert got.dtype == np.float32
    diverged = np.zeros(BATCH, dtype=bool)
    if cfg.num_experts:
        diverged = _forward_diverged(
            cfg, routes.flips(routers, cfg.num_experts_per_token))
    compare = np.repeat(~diverged[:, None], STEPS, axis=1)
    _check_logits(cfg, got, ref, compare, precision, f"{arch} forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches(arch, monkeypatch, trees):
    """At bf16, the serving dtype (the fp32 path is the decode test's)."""
    precision = "bf16"
    routes = Routes(monkeypatch)
    cfg, params, model, routers = _models(arch, precision, trees)
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
    assert len(out.step_ms) == STEPS - 1 + GEN
    ref_logits = np.stack(logits[STEPS - 1:])[..., :cfg.vocab_size]
    steps = STEPS - 1 + GEN
    flipped = np.zeros((steps, BATCH), dtype=bool)
    if cfg.num_experts:
        for i, (differ, _, _) in enumerate(
                routes.flips(routers, cfg.num_experts_per_token)):
            flipped[i // cfg.num_layers] |= differ
    compared = 0
    for b in range(BATCH):
        for g in range(GEN):
            if flipped[:STEPS + g, b].any():
                break                       # its routing differed: stop
            compared += 1
            if out.tokens[b, g] == ref[b, g]:
                continue
            row = ref_logits[g, b]
            top2 = -np.sort(-row)[:2]
            slack = 2 * float(_bound(cfg, row[None], precision).max())
            assert top2[0] - top2[1] <= slack, \
                f"{arch} row {b} token {g}: {out.tokens[b, g]} vs " \
                f"{ref[b, g]} at top-2 margin {top2[0] - top2[1]:.3e}"
            break                           # the sequences diverge here
    assert compared > 0


@pytest.mark.parametrize("arch", ["gemma3-12b", "qwen2-vl-7b",
                                  "falcon-mamba-7b", "recurrentgemma-9b",
                                  "whisper-base"])
def test_unported_families_raise_naming_the_roadmap_item(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item 7"):
        port_model.LM(port_config(arch).reduced(), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_full_size_model_holds_the_configs_parameters(arch):
    """At full width and depth on the meta device (no storage): the
    config's count plus the padded vocabulary rows and the final norm."""
    cfg = port_config(arch)
    model = port_model.init_params(cfg, device="meta")
    tables = 1 if cfg.tie_embeddings else 2
    want = cfg.param_count() + \
        tables * (cfg.padded_vocab - cfg.vocab_size) * cfg.d_model + \
        cfg.d_model
    assert sum(p.numel() for p in model.parameters()) == want
    assert len(model.layers) == cfg.num_layers
    assert model.grouped_launches_per_step() == \
        (2 * cfg.num_layers if cfg.num_experts else 0)


def test_serve_arch_runs_on_the_cpu_with_the_plain_version(capsys):
    args = port_serve.parser().parse_args(
        ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
         "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    rec = port_serve.serve_lm(args)
    out = rec["generation"]
    assert out.tokens.shape == (2, 3) and len(out.step_ms) == 4 + 3
    assert ((out.tokens >= 0) & (out.tokens < 256)).all()
    assert rec["launches"] == rec["planned_launches"] == 0
    np.testing.assert_array_equal(rec["prompts"],
                                  port_serve.lm_prompts(256, 2, 5))
    assert "tok/s" in capsys.readouterr().out
    # The same tokens again through main().
    port_serve.main(["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
                     "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    assert f"sample: {out.tokens[0][:10]}" in capsys.readouterr().out
