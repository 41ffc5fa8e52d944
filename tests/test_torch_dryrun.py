"""The step counter (``repro_torch.core.step_cost``) and the dry run's
counts (``repro_torch.launch.dryrun``).

* The reference's closed forms of ``tests/test_hlo_analysis.py``, exactly:
  a matmul, a loop of 7, nested loops of 3 x 5, a batched einsum, a
  checkpointed loop's backward (between 3x and 5x its forward), the bytes
  of ``a + 1``.
* The port's per-step FLOPs against the reference's ``analyze_hlo`` of the
  same jitted step (``jax.jit(...).lower(...).compile().as_text()`` on the
  CPU): prefill, one decode step and a train step with ``grad_accum`` 2 of
  reduced dense, MoE, ssm and local configs at fp32.  Exact, except that
  the port pads each expert's capacity C to whole 64-row blocks
  (``models.moe.padded_capacity``): its expert products are larger by
  exactly ``padded / C``, and the difference must equal the reference's
  expert FLOPs (derived from the config) times ``padded / C - 1``.
* Triangle against masked causal attention: the counted FLOPs fall by the
  block ratio exactly; fused projections count the same FLOPs as unfused.
* ``top_contributors`` ranks the largest product first.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.configs.base import ShapeConfig as RefShape
from repro.configs.base import get_config as ref_config
from repro.core.hlo_flops import analyze_hlo
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.train import train_step as ref_ts
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.step_cost import StepCounter
from repro_torch.launch import dryrun as DR
from repro_torch.models import attention as ATT
from repro_torch.models import model as port_model
from repro_torch.models import moe as port_moe


def _count(fn, *args):
    with StepCounter() as c:
        fn(*args)
    return c.count


# ---------------------------------------------------------------------- #
# Closed forms (tests/test_hlo_analysis.py).
# ---------------------------------------------------------------------- #

def test_plain_matmul():
    c = _count(lambda a, b: a @ b, torch.ones(64, 128), torch.ones(128, 32))
    assert c.flops == 2 * 64 * 128 * 32


def test_loop_multiplies_flops():
    def f(x, w):
        for _ in range(7):
            x = x @ w
        return x
    c = _count(f, torch.ones(8, 64), torch.ones(64, 64))
    assert c.flops == 2 * 8 * 64 * 64 * 7


def test_nested_loops():
    def g(x, w):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return x
    c = _count(g, torch.ones(8, 64), torch.ones(64, 64))
    assert c.flops == 2 * 8 * 64 * 64 * 15


def test_batched_einsum():
    c = _count(lambda q, k: torch.einsum("bqhgd,bkhd->bhgqk", q, k),
               torch.ones(2, 16, 4, 2, 8), torch.ones(2, 32, 4, 8))
    assert c.flops == 2 * 2 * 4 * 2 * 16 * 32 * 8


def test_remat_loop_counts_recompute():
    x = torch.ones(8, 64)
    w = torch.ones(64, 64, requires_grad=True)

    def body(c):
        # tanh keeps the product's output for the backward, so the
        # checkpoint must recompute it (a bare product saves only its
        # inputs, which torch's checkpoint keeps without recomputing).
        return torch.tanh(c @ w)

    def step():
        out = x
        for _ in range(6):
            out = checkpoint(body, out, use_reentrant=False)
        torch.autograd.grad(out.sum(), w)

    fwd = 2 * 8 * 64 * 64 * 6
    flops = _count(step).flops
    assert 3 * fwd <= flops <= 5 * fwd


def test_bytes_of_add():
    c = _count(lambda a: a + 1.0, torch.ones(256, 256))
    assert c.bytes == 2 * 256 * 256 * 4
    assert c.flops == 0


def test_outer_product_is_not_a_dot():
    """K = 1 contracts nothing: an elementwise product, as XLA makes it."""
    c = _count(lambda a, b: a @ b, torch.ones(64, 1), torch.ones(1, 32))
    assert c.flops == 0 and c.bytes > 0


def test_top_contributors_flops():
    def f(x, w, v):
        return (x @ w) @ v
    c = _count(f, torch.ones(32, 64), torch.ones(64, 256),
               torch.ones(256, 8))
    top = c.top_contributors("flops")
    assert top[0][0] == 2 * 32 * 64 * 256
    assert top[0][1] == "mm.default [32, 64] [64, 256] x1"
    assert top[1][0] == 2 * 32 * 256 * 8
    assert c.top_contributors("bytes")[0][0] > 0


# ---------------------------------------------------------------------- #
# The port's steps against the reference's compiled HLO.
# ---------------------------------------------------------------------- #

B, S, GA, CACHE = 4, 1024, 2, 64
ARCHS = ("llama3.2-1b", "olmoe-1b-7b", "falcon-mamba-7b", "gemma3-12b")


@pytest.fixture
def fp32(monkeypatch):
    monkeypatch.setattr(ref_model, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(port_model, "COMPUTE_DTYPE", torch.float32)


def _ref_flops(cfg, kind):
    params = jax.eval_shape(lambda k: ref_model.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    i32 = jnp.int32
    toks = jax.ShapeDtypeStruct((B, S), i32)
    if kind == "train":
        opt = ref_adamw.AdamWConfig()
        fn, _ = ref_ts.make_train_step(cfg, RefShape("t", S, B, "train"),
                                       None, opt_cfg=opt, grad_accum=GA)
        state = jax.eval_shape(lambda p: ref_adamw.init_state(p, opt),
                               params)
        low = fn.lower(params, state, {"tokens": toks, "labels": toks},
                       jax.ShapeDtypeStruct((), i32))
    elif kind == "prefill":
        fn, _ = ref_ts.make_prefill_step(cfg, RefShape("p", S, B, "prefill"))
        low = fn.lower(params, {"tokens": toks})
    else:
        fn, _ = ref_ts.make_serve_step(cfg, RefShape("d", CACHE, B,
                                                     "decode"))
        cache = jax.eval_shape(lambda: ref_model.init_cache(cfg, B, CACHE))
        low = fn.lower(params, cache, jax.ShapeDtypeStruct((B,), i32),
                       jax.ShapeDtypeStruct((), i32))
    return analyze_hlo(low.compile().as_text())["flops"]


def _port_shape(kind):
    if kind == "decode":
        return ShapeConfig("d", CACHE, B, "decode")
    return ShapeConfig(kind[0], S, B, kind)


def _expert_excess(cfg, kind) -> float:
    """Port minus reference expert FLOPs: the reference's three expert
    einsums per MoE layer (gate, up, down: ``2 E C d f`` each) per pass
    (forward; train: forward, recompute, ``dx`` and ``dw``), times the
    padding ``padded / C - 1`` (in integers: the products' FLOPs per
    row times the padding rows)."""
    if not cfg.num_experts:
        return 0.0
    tokens = {"train": B // GA * S, "prefill": B * S, "decode": B}[kind]
    cap = port_moe.capacity(tokens, cfg.num_experts_per_token,
                            cfg.num_experts, cfg.moe_capacity_factor)
    passes = 4 * GA if kind == "train" else 1
    per_row = 3 * 2 * cfg.num_experts * cfg.d_model * cfg.moe_d_ff
    return cfg.num_layers * passes * per_row * (
        port_moe.padded_capacity(cap) - cap)


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_flops_equal_reference(arch, kind, fp32):
    ref = _ref_flops(ref_config(arch).reduced(), kind)
    cfg = port_config(arch).reduced()
    port = DR.count_step(cfg, _port_shape(kind),
                         grad_accum=GA if kind == "train" else 1).flops
    assert ref > 0
    assert port - ref == _expert_excess(cfg, kind), (port, ref)


# ---------------------------------------------------------------------- #
# Loop-aware against whole; triangle; fused.
# ---------------------------------------------------------------------- #

def _with_impl(impl, fn):
    ATT.set_causal_impl(impl)
    try:
        return fn()
    finally:
        ATT.set_causal_impl("masked")


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_triangle_cuts_attention_flops_by_the_block_ratio(kind):
    cfg = port_config("llama3.2-1b").reduced()
    s, b = 2048, 2
    shape = ShapeConfig("x", s, b, kind)
    masked = _with_impl("masked", lambda: DR.count_step(cfg, shape).flops)
    tri = _with_impl("triangle", lambda: DR.count_step(cfg, shape).flops)
    nq = s // 512
    # Per layer and pass, QK^T and PV: 2 * (2 B Hq S S D); train: forward,
    # layer recompute, the q-block (pair) recompute, backward (2x).
    passes = 5 if kind == "train" else 1
    attn = cfg.num_layers * passes * 2 * 2 * b * cfg.num_heads * s * s \
        * cfg.head_dim
    assert masked - tri == attn * (1 - (nq + 1) / (2 * nq))


def test_fused_projections_count_the_same_flops():
    cfg = port_config("llama3.2-1b").reduced()
    counts = {}
    for fused in (False, True):
        port_model.set_fused_projections(fused)
        try:
            counts[fused] = [DR.count_step(cfg, ShapeConfig("x", 64, 4, k))
                             for k in ("prefill", "train")]
        finally:
            port_model.set_fused_projections(False)
    for unfused, fused in zip(counts[False], counts[True]):
        assert fused.flops == unfused.flops
