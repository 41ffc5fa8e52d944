"""The port's configs, model layers and MoE FFN against the reference.

The same inputs, drawn from numpy with a seed, go through the reference
(``repro.configs``, ``repro.models``) and the port (``repro_torch``), and
the results are held to each other:

* configs: every arch and its ``reduced()`` field by field, with
  ``param_count`` and ``model_flops`` for every shape cell;
* layers (``rmsnorm``, ``apply_rope``, ``dense``, ``mlp``,
  ``decode_attention``, ``chunked_attention``): fp32 within ``1e-5``
  relative, bf16 within a rounding bound;
* the router and capacity: the top-k ids equal wherever the k-th and
  (k+1)-th logits are further apart than the router's error bound (top-k
  of the probabilities is top-k of the logits), and, where the ids differ,
  the margin is shown to be within it;
* bucketing and combine: equal exactly, an overflowing capacity included;
* the MoE FFN at reduced widths and once at olmoe-1b-7b's full widths
  (d 2048, 64 experts, top-8, expert d_ff 1024, T = 4): fp32 within
  ``1e-4`` relative, bf16 within ``models.model.rounding_tolerance``.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.configs import base as ref_base
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import moe as ref_moe
from repro_torch.configs import base as port_base
from repro_torch.models import attention as port_attn
from repro_torch.models import layers as port_layers
from repro_torch.models import moe as port_moe
from repro_torch.models.model import rounding_tolerance

ARCHS = ref_base.list_archs()
RTOL32 = 1e-5
EPS32 = float(np.finfo(np.float32).eps)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, dtype=np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close32(got, ref, what, rtol=RTOL32):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, what
    scale = max(float(np.abs(r).max()), 1e-30)
    err = float(np.abs(g - r).max())
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} * {scale:.3e}"


def _close_bf16(got, ref, stages, what):
    """Within :func:`rounding_tolerance` of ``stages`` bf16 roundings,
    relative to each row's rms (last axis)."""
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, what
    rms = np.sqrt((r.astype(np.float64) ** 2).mean(axis=-1, keepdims=True))
    bound = rounding_tolerance(stages, torch.from_numpy(rms), r.size).numpy()
    excess = float((np.abs(g - r) - bound).max())
    assert excess <= 0, f"{what}: exceeds the bf16 bound by {excess:.3e}"


# ---------------------------------------------------------------------- #
# Configs.
# ---------------------------------------------------------------------- #

def test_arch_registry_matches_the_reference():
    assert port_base.list_archs() == ARCHS
    assert port_base.ARCH_MODULES == ref_base.ARCH_MODULES
    assert list(port_base.all_cells()) == list(ref_base.all_cells())
    assert {k: dataclasses.asdict(v) for k, v in port_base.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in ref_base.SHAPES.items()}


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_the_reference(arch, reduced):
    ref, port = ref_base.get_config(arch), port_base.get_config(arch)
    if reduced:
        ref, port = ref.reduced(), port.reduced()
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.padded_vocab == ref.padded_vocab
    assert port.d_head_total == ref.d_head_total
    assert port.d_kv_total == ref.d_kv_total
    assert port.runnable_shapes() == ref.runnable_shapes()
    for active in (False, True):
        assert port.param_count(active=active) == \
            ref.param_count(active=active)
    for name, shape in ref_base.SHAPES.items():
        assert port.model_flops(port_base.SHAPES[name]) == \
            ref.model_flops(shape), name


def test_unknown_arch_raises_like_the_reference():
    with pytest.raises(KeyError, match="unknown arch"):
        port_base.get_config("no-such-arch")


# ---------------------------------------------------------------------- #
# Layers.
# ---------------------------------------------------------------------- #

RNG = np.random.default_rng


@pytest.mark.parametrize("bf16", [False, True])
def test_rmsnorm_matches(bf16):
    rng = RNG(0)
    x = rng.normal(size=(3, 5, 64)) * 3.0
    scale = rng.normal(size=64) * 0.1
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    ref = ref_layers.rmsnorm({"scale": _j(scale)}, _j(x, jd), eps=1e-6)
    got = port_layers.rmsnorm(_t(x, td), _t(scale), 1e-6)
    assert got.dtype == td
    if bf16:
        _close_bf16(got, ref, 1, "rmsnorm bf16")
    else:
        _close32(got, ref, "rmsnorm")


@pytest.mark.parametrize("head_dim,theta", [(16, 10_000.0), (64, 5e5),
                                            (128, 1e6)])
def test_apply_rope_matches(head_dim, theta):
    rng = RNG(head_dim)
    x = rng.normal(size=(2, 7, 3, head_dim))
    pos = rng.integers(0, 4096, size=(2, 7))
    ref = ref_layers.apply_rope(_j(x), jnp.asarray(pos, jnp.int32), theta)
    got = port_layers.apply_rope(_t(x), torch.from_numpy(pos), theta)
    # Angles up to ~4096 rad: fp32 sin/cos of two libraries differ by a
    # few ulps of the angle.
    _close32(got, ref, f"rope D={head_dim}", rtol=4096 * 4 * EPS32)


def test_apply_rope_rotates_halves_not_pairs():
    x = torch.zeros(1, 1, 1, 4)
    x[..., 0] = 1.0                       # first element of the first half
    out = port_layers.apply_rope(x, torch.tensor([[1]]), 10_000.0)
    # The first half's element 0 rotates into the second half's element 0.
    assert float(out[..., 2]) == pytest.approx(np.sin(1.0), rel=1e-6)
    assert float(out[..., 1]) == 0.0


@pytest.mark.parametrize("bias", [False, True])
def test_dense_matches(bias):
    rng = RNG(1)
    x, w, b = rng.normal(size=(4, 6, 32)), rng.normal(size=(32, 48)), \
        rng.normal(size=48)
    params = {"kernel": _j(w)}
    if bias:
        params["bias"] = _j(b)
    ref = ref_layers.dense(params, _j(x))
    got = port_layers.dense(_t(x), _t(w), _t(b) if bias else None)
    _close32(got, ref, f"dense bias={bias}")


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu"])
def test_mlp_matches(variant):
    rng = RNG(2)
    d, f = 32, 64
    x = rng.normal(size=(2, 5, d))
    ws = {k: rng.normal(size=s) / np.sqrt(s[0]) for k, s in
          (("wi_gate", (d, f)), ("wi_up", (d, f)), ("wi", (d, f)),
           ("wo", (f, d)))}
    if variant == "gelu":
        params = {k: {"kernel": _j(ws[k])} for k in ("wi", "wo")}
        got = port_layers.mlp(_t(x), _t(ws["wi"]), _t(ws["wo"]), variant)
    else:
        params = {k: {"kernel": _j(ws[k])} for k in ("wi_gate", "wi_up",
                                                     "wo")}
        got = port_layers.mlp(_t(x), _t(ws["wi_gate"]), _t(ws["wo"]),
                              variant, _t(ws["wi_up"]))
    ref = ref_layers.mlp(params, _j(x), variant)
    _close32(got, ref, f"mlp {variant}")


def test_embed_scales_in_the_compute_dtype():
    rng = RNG(3)
    table = rng.normal(size=(16, 2048)) * 0.02
    toks = np.array([[1, 5, 9]])
    for scale in (False, True):
        ref = ref_layers.embed({"table": _j(table)}, jnp.asarray(toks),
                               scale=scale, dtype=jnp.bfloat16)
        got = port_layers.embed(_t(table, torch.bfloat16),
                                torch.from_numpy(toks), scale=scale)
        assert np.array_equal(_np(got), _np(ref)), scale
    ref = ref_layers.unembed({"table": _j(table)}, _j(rng.normal(
        size=(2, 3, 2048))))
    assert ref.shape == (2, 3, 16)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
def test_decode_attention_matches(hq, hkv):
    rng = RNG(hq * 10 + hkv)
    b, s, d = 3, 12, 16
    q = rng.normal(size=(b, 1, hq, d))
    k, v = rng.normal(size=(b, s, hkv, d)), rng.normal(size=(b, s, hkv, d))
    mask = np.arange(s)[None, :] <= np.array([0, 5, 11])[:, None]
    ref = ref_attn.decode_attention(_j(q), _j(k), _j(v), jnp.asarray(mask))
    got = port_attn.decode_attention(_t(q), _t(k), _t(v),
                                     torch.from_numpy(mask))
    _close32(got, ref, f"decode_attention {hq}/{hkv}")
    refb = ref_attn.decode_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                     _j(v, jnp.bfloat16), jnp.asarray(mask))
    gotb = port_attn.decode_attention(
        _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
        torch.from_numpy(mask))
    assert gotb.dtype == torch.bfloat16
    # q's scale and the output are rounded to bf16.
    _close_bf16(gotb, refb, 2, "decode_attention bf16")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("blocks", [(512, 1024), (4, 8), (8, 4)])
def test_chunked_attention_matches(causal, blocks):
    rng = RNG(7)
    b, s, hq, hkv, d = 2, 24, 4, 2, 16
    q = rng.normal(size=(b, s, hq, d))
    k, v = rng.normal(size=(b, s, hkv, d)), rng.normal(size=(b, s, hkv, d))
    qb, kb = blocks
    chunked = jax.jit(functools.partial(ref_attn.chunked_attention,
                                        causal=causal, q_block=qb,
                                        kv_block=kb))
    ref = chunked(_j(q), _j(k), _j(v))
    got = port_attn.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                      q_block=qb, kv_block=kb)
    _close32(got, ref, f"chunked_attention causal={causal} {blocks}")
    refb = chunked(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                   _j(v, jnp.bfloat16))
    gotb = port_attn.chunked_attention(
        _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
        causal=causal, q_block=qb, kv_block=kb)
    # q's scale, the probabilities and the output are rounded to bf16.
    _close_bf16(gotb, refb, 3, "chunked_attention bf16")


def test_chunked_attention_causal_matches_decode_attention():
    """The last query of a causal window equals one decode step over it."""
    rng = RNG(8)
    q = rng.normal(size=(1, 10, 4, 16))
    k, v = rng.normal(size=(1, 10, 2, 16)), rng.normal(size=(1, 10, 2, 16))
    full = port_attn.chunked_attention(_t(q), _t(k), _t(v), q_block=4,
                                       kv_block=2)
    last = port_attn.decode_attention(_t(q[:, -1:]), _t(k), _t(v),
                                      torch.ones(1, 10, dtype=torch.bool))
    torch.testing.assert_close(full[:, -1:], last, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------- #
# Router, capacity, bucketing, combine.
# ---------------------------------------------------------------------- #

def router_error_bound(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Per-logit bound on ``|port - reference|`` of the router's fp32
    ``x @ w`` for the same operands: each side is within ``gamma_d *
    (|x| @ |w|)`` of the exact product, ``gamma_d = d u / (1 - d u)``."""
    d = x.shape[-1]
    u = EPS32 / 2
    gamma = d * u / (1 - d * u)
    return 2 * gamma * (np.abs(x).astype(np.float64) @ np.abs(w))


def check_ids(ids_port, ids_ref, logits_ref, bound, k, what) -> np.ndarray:
    """Equal top-k sets wherever the reference's k-th and (k+1)-th logits
    are more than twice the largest logit error apart; where the sets
    differ, that margin must be within it.  Returns the tokens that
    differ."""
    zs = -np.sort(-logits_ref, axis=-1)
    margin = zs[:, k - 1] - zs[:, k] if k < zs.shape[-1] else \
        np.full(zs.shape[0], np.inf)
    same = np.array([set(a) == set(b) for a, b in zip(ids_port, ids_ref)])
    slack = 2 * bound.max(axis=-1)
    assert np.all(same | (margin <= slack)), \
        f"{what}: ids differ at margins {margin[~same]} > {slack[~same]}"
    return ~same


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("e,k", [(8, 2), (64, 8), (16, 1)])
def test_router_matches(e, k, bf16):
    rng = RNG(e + k)
    x, w = rng.normal(size=(64, 48)), rng.normal(size=(48, e)) * 0.2
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    xj = _j(x, jd)
    w_ref, ids_ref = ref_moe._router({"kernel": _j(w)}, xj, k)
    w_got, ids_got = port_moe.router(_t(x, td), _t(w), k)
    xs = _np(xj)
    logits = xs.astype(np.float64) @ w
    differ = check_ids(ids_got.numpy(), np.asarray(ids_ref), logits,
                       router_error_bound(xs, w), k, f"router e={e} k={k}")
    ok = ~differ
    np.testing.assert_allclose(w_got.numpy()[ok], np.asarray(w_ref)[ok],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(w_got.numpy().sum(-1), 1.0, rtol=1e-5)


def test_capacity_matches():
    for t in (1, 3, 4, 16, 128, 4096):
        for k in (1, 2, 8):
            for e in (8, 64, 128):
                for cf in (1.0, 1.25, 2.0):
                    assert port_moe.capacity(t, k, e, cf) == \
                        ref_moe._capacity(t, k, e, cf), (t, k, e, cf)


def _bucket_case(T, E, k, cap, e0, e_loc, seed):
    rng = RNG(seed)
    x = rng.normal(size=(T, 8)).astype(np.float32)
    # Skewed ids so some experts overflow the capacity.
    probs = np.linspace(1.0, 0.1, E)
    ids = np.stack([rng.choice(E, size=k, replace=False, p=probs / probs.sum())
                    for _ in range(T)]).astype(np.int32)
    weights = rng.uniform(0.1, 1.0, size=(T, k)).astype(np.float32)
    buf_r, (e_r, c_r, w_r) = jax.jit(ref_moe._bucket_local,
                                     static_argnums=(3, 4, 5))(
        jnp.asarray(x), jnp.asarray(weights), jnp.asarray(ids), e0, e_loc,
        cap)
    buf_p, (e_p, c_p, w_p) = port_moe.bucket_local(
        torch.from_numpy(x), torch.from_numpy(weights),
        torch.from_numpy(ids).long(), e0, e_loc, cap)
    return (x, ids, np.asarray(buf_r), np.asarray(e_r), np.asarray(c_r),
            np.asarray(w_r), buf_p, e_p, c_p, w_p)


@pytest.mark.parametrize("T,E,k,cap,e0,e_loc,drops", [
    (16, 8, 2, 4, 0, 8, True),      # 32 slots into 8 x 4, skewed
    (16, 8, 2, 16, 0, 8, False),    # no slot dropped
    (12, 8, 2, 3, 2, 4, True),      # a shard's experts [2, 6)
    (5, 64, 8, 1, 0, 64, True),     # capacity 1
])
def test_bucket_local_matches_exactly(T, E, k, cap, e0, e_loc, drops):
    (x, ids, buf_r, e_r, c_r, w_r, buf_p, e_p, c_p,
     w_p) = _bucket_case(T, E, k, cap, e0, e_loc, seed=T + cap)
    np.testing.assert_array_equal(e_p.numpy(), e_r)
    np.testing.assert_array_equal(c_p.numpy(), c_r)
    np.testing.assert_array_equal(w_p.numpy(), w_r)       # keep * w
    np.testing.assert_array_equal(buf_p.numpy(), buf_r)
    keep = w_r != 0
    local = (ids >= e0) & (ids < e0 + e_loc)
    assert bool((local & ~keep).any()) == drops
    # Padding each expert's block with zero rows keeps the kept rows.
    buf_pad, spec = port_moe.bucket_local(
        torch.from_numpy(x), torch.from_numpy(w_r * 0 + 1),
        torch.from_numpy(ids).long(), e0, e_loc, cap, rows=64)
    assert buf_pad.shape == (e_loc, 64, 8)
    np.testing.assert_array_equal(buf_pad[:, :cap].numpy(), buf_r)
    assert not bool(buf_pad[:, cap:].any())


def test_slot_ranks_are_slot_major():
    """Every token's slot 0 is ranked before any slot 1: expert 1 ranks
    token 2's slot 0 before token 0's slot 1, and expert 0 ranks token 2's
    slot 1 last, so with capacity 2 that slot is the one dropped."""
    ids = torch.tensor([[0, 1], [0, 2], [1, 0]])
    _, local, pos = port_moe.slot_ranks(ids, 0, 3)
    assert local.all()
    assert pos.tolist() == [[0, 1], [1, 0], [0, 2]]


@pytest.mark.parametrize("bf16", [False, True])
def test_combine_local_matches(bf16):
    (x, ids, buf_r, e_r, c_r, w_r, buf_p, e_p, c_p,
     w_p) = _bucket_case(16, 8, 2, 4, 0, 8, seed=3)
    out = RNG(4).normal(size=buf_r.shape).astype(np.float32)
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    ref = ref_moe._combine_local(_j(out, jd), (jnp.asarray(e_r),
                                               jnp.asarray(c_r),
                                               jnp.asarray(w_r)), 16)
    got = port_moe.combine_local(_t(out, td), (e_p, c_p, w_p))
    if bf16:
        _close_bf16(got, ref, 2, "combine bf16")
    else:
        _close32(got, ref, "combine")


# ---------------------------------------------------------------------- #
# The MoE FFN.
# ---------------------------------------------------------------------- #

def _moe_weights(d, f, e, seed):
    """The reference's ``init_moe`` shapes and He stds, drawn from a seeded
    ``torch.Generator`` (faster than the reference's PRNG on the CPU)."""
    gen = torch.Generator().manual_seed(seed)

    def he(shape, fan_in):
        return (torch.randn(shape, generator=gen) / np.sqrt(fan_in)).numpy()
    return {"router": {"kernel": he((d, e), d)},
            "w_gate": he((e, d, f), d), "w_up": he((e, d, f), d),
            "w_down": he((e, f, d), f)}


@pytest.fixture(scope="module")
def olmoe_moe_weights():
    """olmoe-1b-7b's expert FFN weights (about 1.6 GB of fp32), drawn once
    for the file."""
    return _moe_weights(2048, 1024, 64, 11)


def _port_moe(tree, k, cf, dtype) -> port_moe.MoE:
    d, e = tree["router"]["kernel"].shape
    f = tree["w_gate"].shape[2]
    m = port_moe.MoE(d, f, e, k, cf, dtype=dtype, device=torch.device("meta"),
                     generator=None)
    state = {"router": _t(tree["router"]["kernel"]),
             "w_gate_up": _t(np.concatenate([tree["w_gate"], tree["w_up"]],
                                            axis=2), dtype),
             "w_down": _t(tree["w_down"], dtype)}
    m.load_state_dict(state, assign=True)
    return m


#: Roundings to bf16 inside the MoE FFN: gate/up, the activation, its
#: product with up, down, the combine's product and its sum.
MOE_ROUNDINGS = 6


def _moe_case(tree, k, T, bf16, seed):
    d, e = tree["router"]["kernel"].shape
    cf = 1.25
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    x = RNG(seed).normal(size=(1, T, d)).astype(np.float32)
    xj = _j(x, jd)
    ref = jax.jit(functools.partial(ref_moe.moe_ffn, k=k, num_experts=e,
                                    capacity_factor=cf))(
        jax.tree.map(jnp.asarray, tree), xj)
    m = _port_moe(tree, k, cf, td)
    got = m(_t(x, td))
    assert got.dtype == td and got.shape == (1, T, d)
    # Routing sees the same x in both packages; a token whose top-k set
    # differs (a near-tie, checked) is left out of the comparison.
    xs = _np(xj)[0]
    w = tree["router"]["kernel"]
    _, ids_ref = ref_moe._router({"kernel": jnp.asarray(w)}, xj[0], k)
    _, ids_got = port_moe.router(_t(x[0], td), m.router, k)
    differ = check_ids(ids_got.numpy(), np.asarray(ids_ref),
                       xs.astype(np.float64) @ w, router_error_bound(xs, w),
                       k, "moe router")
    if differ.any():
        cap = port_moe.capacity(T, k, e, cf)
        # A changed id may also change who overflows the capacity.
        assert T * k <= cap, "a near-tie where slots can be dropped"
    keep = ~differ
    if bf16:
        _close_bf16(got[0][keep], ref[0][keep], MOE_ROUNDINGS, "moe_ffn bf16")
    else:
        _close32(got[0][keep], ref[0][keep], "moe_ffn", rtol=1e-4)
    return m, got, x


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("T", [4, 40])
def test_moe_ffn_matches_at_reduced_widths(T, bf16):
    """T = 40 tokens over 8 experts top-2 overflows the capacity (13)."""
    _moe_case(_moe_weights(64, 64, 8, T), 2, T, bf16, seed=T)


def test_moe_ffn_matches_the_dense_oracle_without_drops():
    tree = _moe_weights(64, 64, 8, 5)
    m, got, x = _moe_case(tree, 2, 4, False, seed=5)
    oracle = port_moe.moe_ffn_dense(m, _t(x))
    torch.testing.assert_close(got, oracle, rtol=1e-4, atol=1e-5)
    ref = ref_moe.moe_ffn_dense(jax.tree.map(jnp.asarray, tree), _j(x), k=2,
                                num_experts=8)
    _close32(oracle, ref, "moe_ffn_dense", rtol=1e-4)


@pytest.mark.parametrize("bf16", [False, True])
def test_moe_ffn_matches_at_olmoe_full_widths(olmoe_moe_weights, bf16):
    """olmoe-1b-7b's expert FFN: d 2048, 64 experts top-8, d_ff 1024, a
    decode step's 4 tokens."""
    _moe_case(olmoe_moe_weights, 8, 4, bf16, seed=11)
