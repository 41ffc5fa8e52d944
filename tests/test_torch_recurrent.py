"""The port's ``ssm`` and ``hybrid`` families on the CPU: falcon-mamba-7b's
selective scan (``models.ssm``) and recurrentgemma-9b's RG-LRU
(``models.rglru``), their units against the reference, the full-size
parameter counts, the port's decode against its forward with planted
faults, and ``serve --arch``.  The archs against the reference (forward,
decode, generate, interop) are in ``tests/test_torch_recurrent_archs.py``
and one train step each in ``tests/test_torch_recurrent_train.py``.

The units' inputs are drawn from numpy with a seed and go through the
reference (``repro.models.ssm`` / ``rglru``) and the port; weights are the
reference's ``init_*`` with every bias, ``D`` and norm scale moved off
its init by seeded noise, loaded into the port by name.  Neither family
reaches a Pallas kernel in the reference.

Bounds:

* ``causal_conv``: bit for bit at bf16 (both packages round each product
  and each sum in the input's dtype, in the same order), where a
  ``conv1d`` (fp32 accumulation, one rounding) must fail; at fp32, where
  the jitted reference may fuse a product and a sum, within ``2 * 2K``
  roundings of the sum of |terms|.
* Everything else at bf16: ``models.model.rounding_tolerance`` over the
  bf16 roundings each path counts, relative to each row's rms (the
  model's per-layer counts, ``SSM_ROUNDINGS_PER_LAYER`` and
  ``RGLRU_ROUNDINGS_PER_LAYER``, less the norm and the residual a unit
  does not run).
* Everything else at fp32: the same ``rounding_tolerance`` at fp32's unit
  roundoff, relative to each row's largest |value| (an fp32 reduction's
  accumulation error scales with its sum of |terms|, not with the rms of
  what remains after cancellation; the mamba state's row is the whole
  ``[d_in, N]`` state), over the fp32 roundings on the path: a product of a
  reduction of ``K`` terms counts ``K`` (the accumulator rounds once per
  term in the worst order), an elementwise op counts 1, and the scan
  counts ``3 * ceil(log2 ch) + 1`` per chunk it crosses: both packages
  associate each term ``(a_t ... a_{s+1}) b_s`` of ``h_t`` in at most
  ``ceil(log2 ch)`` levels (the port's doubling steps, the reference's
  ``associative_scan``), each level rounding once in the ``a`` product,
  once in the product with ``b`` and once in the sum, and the carry is
  folded in with one more rounding per chunk.  A decode state after ``t``
  steps counts its per-step roundings ``t`` times.
* A scan that drops the carry at a chunk boundary must fail.
* The port's decode against its forward: ``models.decode_check``, which
  must reject a dropped chunk carry, a conv cache of activated inputs and
  a decode without its decay.

Seconds in the suite's six-worker run are in ``CHANGES.md``.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.models import rglru as ref_rglru
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch import serve as port_serve
from repro_torch.models import decode_check
from repro_torch.models import model as port_model
from repro_torch.models import rglru as port_rglru
from repro_torch.models import ssm as port_ssm

ARCHS = ("falcon-mamba-7b", "recurrentgemma-9b")
D, N_STATE, K_CONV, EXPAND, RW = 32, 16, 4, 2, 64
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _ratio(got, ref, stages, dtype, flat: int = 1) -> float:
    """Worst ``|got - ref|`` over ``rounding_tolerance`` of ``stages``
    roundings at ``dtype`` relative to each row's scale: its rms at bf16,
    its largest |value| at fp32.  A row is the last ``flat`` axes."""
    g, r = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert g.shape == r.shape and np.isfinite(g).all()
    g = g.reshape(*g.shape[:g.ndim - flat], -1)
    r = r.reshape(g.shape)
    scale = np.sqrt((r ** 2).mean(axis=-1, keepdims=True)) \
        if dtype == torch.bfloat16 else np.abs(r).max(axis=-1, keepdims=True)
    bound = port_model.rounding_tolerance(stages, torch.from_numpy(scale),
                                          r.size, dtype).numpy()
    err = np.abs(g - r)
    # A row of zeros (a fresh conv cache's rows) must match exactly.
    ratio = np.where(bound > 0, err / np.where(bound > 0, bound, 1),
                     np.where(err > 0, np.inf, 0.0))
    return float(ratio.max())


def _close(got, ref, stages, dtype, what, flat: int = 1):
    ratio = _ratio(got, ref, stages, dtype, flat)
    assert ratio <= 1, f"{what}: err / bound {ratio:.3f} at {dtype}"


def _scan_stages(ch: int, chunks: int) -> int:
    """fp32 roundings of the chunked scan (module docstring)."""
    return (3 * math.ceil(math.log2(ch)) + 1) * chunks


def _load(module, tree: dict) -> None:
    """The reference's leaves into ``module`` by name, each cast to the
    dtype the module holds it in."""
    own = dict(module.named_parameters())

    def leaves(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}.")
            else:
                yield f"{prefix}{k}", np.asarray(v, dtype=np.float32)
    module.load_state_dict(
        {k: torch.from_numpy(v.copy()).to(own[k].dtype)
         for k, v in leaves(tree)}, strict=True, assign=True)


def _noisy(tree: dict, rng) -> dict:
    """Every bias, ``D`` and norm scale moved off its init."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _noisy(v, rng)
        elif k in ("bias", "conv_b", "D", "scale"):
            out[k] = (np.asarray(v) + rng.normal(size=v.shape) *
                      (0.1 if k in ("D", "scale") else 0.5)).astype(np.float32)
        else:
            out[k] = np.asarray(v)
    return out


#: The units' reference weights, drawn once per module.
_UNIT_TREES: dict = {}


def _unit_tree(name, init, *args) -> dict:
    if name not in _UNIT_TREES:
        _UNIT_TREES[name] = _noisy(jax.tree.map(np.asarray, jax.jit(
            init, static_argnums=tuple(range(1, len(args))))(*args)),
            np.random.default_rng(len(_UNIT_TREES) + 1))
    return _UNIT_TREES[name]


def _mamba(precision):
    tree = _unit_tree("mamba", ref_ssm.init_mamba, jax.random.PRNGKey(0), D,
                      N_STATE, K_CONV, EXPAND)
    mod = port_ssm.Mamba(D, N_STATE, K_CONV, EXPAND,
                         dtype=DTYPES[precision][1],
                         device=torch.device("meta"), generator=None)
    _load(mod, tree)
    return jax.tree.map(jnp.asarray, tree), mod


def _rglru(precision):
    tree = _unit_tree("rglru", ref_rglru.init_rglru, jax.random.PRNGKey(2),
                      D, RW, K_CONV)
    mod = port_rglru.RGLRU(D, RW, K_CONV, dtype=DTYPES[precision][1],
                           device=torch.device("meta"), generator=None)
    _load(mod, tree)
    return jax.tree.map(jnp.asarray, tree), mod


def _inputs(shape, precision, seed=0):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    jd, td = DTYPES[precision]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


@pytest.fixture(params=["fp32", "bf16"])
def precision(request):
    return request.param


# ---------------------------------------------------------------------- #
# Units.
# ---------------------------------------------------------------------- #

def _conv1d(u, w, b, state=None):
    """A planted variant: the same conv as one fp32 ``conv1d``."""
    K = w.shape[0]
    up = F.pad(u, (0, 0, K - 1, 0)) if state is None else \
        torch.cat([state.to(u.dtype), u], dim=1)
    out = F.conv1d(up.float().transpose(1, 2),
                   w.to(u.dtype).float().T[:, None, :],
                   b.to(u.dtype).float(), groups=u.shape[-1])
    return out.transpose(1, 2).to(u.dtype)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches(with_state, precision):
    rng = np.random.default_rng(4)
    w = rng.normal(size=(K_CONV, 64)).astype(np.float32) * 0.5
    b = rng.normal(size=64).astype(np.float32) * 0.1
    uj, ut = _inputs((2, 24, 64), precision, seed=5)
    sj, st = _inputs((2, K_CONV - 1, 64), precision, seed=6) if with_state \
        else (None, None)
    ref = _np(jax.jit(ref_ssm._causal_conv)(uj, jnp.asarray(w),
                                            jnp.asarray(b), sj))
    args = (torch.from_numpy(w), torch.from_numpy(b), st)
    got = port_ssm.causal_conv(ut, *args)
    assert got.dtype == ut.dtype
    if precision == "bf16":
        assert np.array_equal(_np(got), ref)
        assert not np.array_equal(_np(_conv1d(ut, *args)), ref)
        return
    # Under jit XLA may contract a product and a sum into one fma, so each
    # side rounds at most 2K times: |diff| <= 2 * 2K * u * sum |terms|.
    up = np.concatenate([_np(st) if with_state else
                         np.zeros((2, K_CONV - 1, 64)), _np(ut)], axis=1)
    terms = sum(np.abs(up[:, i:i + 24] * w[i]) for i in range(K_CONV))
    u32 = float(np.finfo(np.float32).eps) / 2
    bound = 4 * K_CONV * u32 * (terms + np.abs(b))
    assert (np.abs(_np(got) - ref) <= bound).all()


def test_discretize_matches(precision):
    params, mod = _mamba(precision)
    uj, ut = _inputs((2, 8, EXPAND * D), precision, seed=7)
    ref = jax.jit(ref_ssm._discretize)(params, uj)
    got = port_ssm.discretize(mod, ut)
    d_in, rank = EXPAND * D, max(D // 16, 1)
    # bf16: x_proj and dt_proj round; fp32: x_proj's and dt_proj's
    # reductions, softplus, dt * A, exp, dt * u, the product with B.
    stages = 2 if precision == "bf16" else d_in + rank + 5
    for name, g, r in zip(("dA", "dBu", "C"), got, ref):
        assert g.dtype == torch.float32
        _close(g, r, stages, DTYPES[precision][1], f"discretize {name}",
               flat=2 if name != "C" else 1)


def _mamba_stages(precision, ch, chunks) -> int:
    """Roundings of ``mamba_forward`` on its input: at bf16 the layer's
    count less its norm and residual; at fp32 in_proj's reduction (D), the
    conv (8), silu, discretize's, the scan, the einsum over N, u * D and
    its sum, silu(z) and its product, out_proj's reduction."""
    if precision == "bf16":
        return port_model.SSM_ROUNDINGS_PER_LAYER - 2
    d_in = EXPAND * D
    return (D + 2 * K_CONV + 1 + d_in + max(D // 16, 1) + 5 +
            _scan_stages(ch, chunks) + N_STATE + 4 + d_in)


@pytest.mark.parametrize("seq,chunk", [(32, 8), (32, 256)],
                         ids=["four chunks", "S = ch"])
def test_mamba_forward_matches(seq, chunk, precision, monkeypatch):
    params, mod = _mamba(precision)
    xj, xt = _inputs((2, seq, D), precision, seed=8)
    ref = jax.jit(lambda p, x: ref_ssm.mamba_forward(p, x, chunk=chunk))(
        params, xj)
    got = port_ssm.mamba_forward(mod, xt, chunk=chunk)
    assert got.dtype == xt.dtype
    ch = min(chunk, seq)
    stages = _mamba_stages(precision, ch, seq // ch)
    dtype = DTYPES[precision][1]
    _close(got, ref, stages, dtype, f"mamba_forward S={seq} chunk={chunk}")
    if seq > ch:
        # A planted fault: the scan drops the carry at each chunk boundary.
        monkeypatch.setattr(port_ssm, "fold_carry", lambda a, b, h: b)
        dropped = port_ssm.mamba_forward(mod, xt, chunk=chunk)
        assert _ratio(dropped, ref, stages, dtype) > 1


def test_mamba_forward_needs_whole_chunks():
    _, mod = _mamba("fp32")
    with pytest.raises(AssertionError):
        port_ssm.mamba_forward(mod, torch.zeros(1, 12, D), chunk=8)


def test_mamba_decode_matches_every_step(precision):
    params, mod = _mamba(precision)
    jd, td = DTYPES[precision]
    steps = 32
    xj, xt = _inputs((2, steps, D), precision, seed=9)
    cache_r = {"conv": jnp.zeros((2, K_CONV - 1, EXPAND * D), jd),
               "h": jnp.zeros((2, EXPAND * D, N_STATE), jnp.float32)}
    cache_p = port_ssm.init_mamba_cache(mod, 2, td)
    assert cache_p["conv"].dtype == td and cache_p["h"].dtype == torch.float32
    step = jax.jit(ref_ssm.mamba_decode)
    # Per step: in_proj, the conv, silu, discretize, the state's product
    # and sum (fp32); bf16 rounds in_proj, the conv, silu, x_proj, dt_proj.
    per_step = 11 if precision == "bf16" else \
        D + 2 * K_CONV + 1 + EXPAND * D + max(D // 16, 1) + 5 + 2
    conv_stages = 1 if precision == "bf16" else D
    for t in range(steps):
        out_r, cache_r = step(params, cache_r, xj[:, t:t + 1])
        out_p, new = port_ssm.mamba_decode(mod, cache_p, xt[:, t:t + 1])
        cache_p = new
        _close(new["conv"], cache_r["conv"], conv_stages, td, f"conv {t}")
        _close(new["h"], cache_r["h"], per_step * (t + 1), td, f"h {t}",
               flat=2)
        _close(out_p, out_r, per_step * (t + 1) + 7, td, f"out {t}")


@pytest.mark.parametrize("bf16", [False, True])
def test_block_diag_and_gates_match(bf16):
    precision = "bf16" if bf16 else "fp32"
    params, mod = _rglru(precision)
    td = DTYPES[precision][1]
    xj, xt = _inputs((2, 8, RW), precision, seed=10)
    bs = RW // port_rglru.NUM_GATE_BLOCKS
    assert port_rglru.NUM_GATE_BLOCKS == ref_rglru.NUM_GATE_BLOCKS
    assert port_rglru._C == ref_rglru._C
    got = port_rglru.block_diag(mod.w_r, xt)
    assert got.dtype == td
    _close(got, jax.jit(ref_rglru._block_diag)(params["w_r"], xj),
           1 if bf16 else bs,
           td, "block_diag")
    # bf16: the block products round; the gates are fp32 after them.
    # fp32: the block reduction, sigmoid, softplus, the two products, exp,
    # 1 - a^2, sqrt, and the products with i and x.
    stages = 1 if bf16 else bs + 9
    for name, g, r in zip(("a", "gated"), port_rglru.gates(mod, xt),
                          jax.jit(ref_rglru._gates)(params, xj)):
        assert g.dtype == torch.float32
        _close(g, r, stages, td, f"gates {name}")


def _rglru_stages(precision, ch, chunks) -> int:
    """bf16: the layer's mixer roundings (its count less the norm, the
    residual and the FFN's six); fp32: wx's reduction, the conv, the gates
    (as above), the scan, wy's reduction and the gelu, the product with
    it, out's reduction."""
    if precision == "bf16":
        return port_model.RGLRU_ROUNDINGS_PER_LAYER - 8
    bs = RW // port_rglru.NUM_GATE_BLOCKS
    return (D + 2 * K_CONV + bs + 9 + _scan_stages(ch, chunks) + D + 1 +
            1 + RW)


@pytest.mark.parametrize("seq,chunk", [(32, 8), (13, 8)],
                         ids=["four chunks", "odd length: one chunk"])
def test_rglru_forward_matches(seq, chunk, precision, monkeypatch):
    params, mod = _rglru(precision)
    xj, xt = _inputs((2, seq, D), precision, seed=11)
    ref = jax.jit(lambda p, x: ref_rglru.rglru_forward(p, x, chunk=chunk))(
        params, xj)
    got = port_rglru.rglru_forward(mod, xt, chunk=chunk)
    assert got.dtype == xt.dtype
    ch = chunk if seq % chunk == 0 else seq
    stages = _rglru_stages(precision, ch, seq // ch)
    td = DTYPES[precision][1]
    _close(got, ref, stages, td, f"rglru_forward S={seq} chunk={chunk}")
    if seq > ch:
        monkeypatch.setattr(port_ssm, "fold_carry", lambda a, b, h: b)
        dropped = port_rglru.rglru_forward(mod, xt, chunk=chunk)
        assert _ratio(dropped, ref, stages, td) > 1


def test_rglru_decode_matches_every_step(precision):
    params, mod = _rglru(precision)
    jd, td = DTYPES[precision]
    steps = 32
    xj, xt = _inputs((2, steps, D), precision, seed=12)
    cache_r = {"conv": jnp.zeros((2, K_CONV - 1, RW), jd),
               "h": jnp.zeros((2, RW), jnp.float32)}
    cache_p = port_rglru.init_rglru_cache(mod, 2, td)
    step = jax.jit(ref_rglru.rglru_decode)
    bs = RW // port_rglru.NUM_GATE_BLOCKS
    # Per step: bf16 rounds wx, the conv and the gate blocks; fp32 adds
    # the reductions and the gates' elementwise ops and the state's
    # product and sum.
    per_step = 10 if precision == "bf16" else D + 2 * K_CONV + bs + 9 + 2
    conv_stages = 1 if precision == "bf16" else D
    for t in range(steps):
        out_r, cache_r = step(params, cache_r, xj[:, t:t + 1])
        out_p, cache_p = port_rglru.rglru_decode(mod, cache_p,
                                                 xt[:, t:t + 1])
        _close(cache_p["conv"], cache_r["conv"], conv_stages, td,
               f"conv {t}")
        _close(cache_p["h"], cache_r["h"], per_step * (t + 1), td, f"h {t}")
        _close(out_p, out_r, per_step * (t + 1) + D + 4 + RW, td,
               f"out {t}")


# ---------------------------------------------------------------------- #
# Full-size parameter counts (the arch-level comparisons with the
# reference are in tests/test_torch_recurrent_archs.py).
# ---------------------------------------------------------------------- #

def _tokens(arch, seq, batch) -> np.ndarray:
    return Pipeline(port_config(arch).reduced(),
                    ShapeConfig("t", seq, batch, "train"),
                    DataConfig(seed=0)).batch_for_step(0)["tokens"]


@pytest.mark.parametrize("arch,extra,rounds", [
    # The final norm, and per layer conv_b and dt_proj's bias (2 * d_in)
    # that the count leaves out and the second norm it counts (d).
    ("falcon-mamba-7b", 64 * (2 * 8192 - 4096) + 4096, 64 * 20 + 2),
    # The final norm.
    ("recurrentgemma-9b", 4096, 26 * 23 + 12 * 15 + 2),
])
def test_full_size_model_holds_the_configs_parameters(arch, extra, rounds):
    cfg = port_config(arch)
    model = port_model.init_params(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + extra
    kinds = port_model.layer_kinds(cfg)
    assert len(model.layers) == cfg.num_layers == len(kinds)
    assert port_model.roundings(cfg) == rounds
    if arch == "falcon-mamba-7b":
        assert cfg.num_heads == cfg.head_dim == 0
        assert all(isinstance(b, port_model.MambaBlock)
                   for b in model.layers)
        assert port_model.unshared_roundings(cfg) == 0
    else:
        assert kinds.count("rglru") == 26 and kinds.count("local") == 12
        assert port_model.unshared_roundings(cfg) == 12
    assert model.grouped_launches_per_step() == 0


# ---------------------------------------------------------------------- #
# The port's decode against its forward, and planted faults.
# ---------------------------------------------------------------------- #

#: Decode-check models and lengths: falcon-mamba's two reduced layers over
#: two chunks of 256; recurrentgemma cut to one (rglru, rglru, local)
#: period over two RG-LRU chunks of 512 (its 32-slot ring wraps).
CHECK = {"falcon-mamba-7b": (None, 512),
         "recurrentgemma-9b": (("rglru", "rglru", "local"), 1024)}
FAULT_STEPS = 64


#: Each arch's check model and its honest traces, made once per module.
_CHECKS: dict = {}


def _check_traces(arch):
    """The check model, its tokens and its honest forward and decode
    traces."""
    if arch not in _CHECKS:
        lm, toks = _check_model(arch)
        _CHECKS[arch] = (lm, toks, decode_check.forward_trace(lm, toks),
                         decode_check.decode_trace(lm, toks, toks.shape[1]))
    return _CHECKS[arch]


def _check_model(arch):
    pattern, seq = CHECK[arch]
    cfg = port_config(arch).reduced()
    if pattern:
        cfg = dataclasses.replace(cfg, layer_pattern=pattern,
                                  num_layers=len(pattern))
    lm = port_model.LM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    return lm, torch.from_numpy(_tokens(arch, seq, 1))


def stores_activated_input(p, cache, x, _orig=port_ssm.mamba_decode):
    """A planted fault: decode's conv cache keeps silu(conv(u)), not u."""
    out, new = _orig(p, cache, x)
    u = torch.chunk(p.in_proj(x), 2, dim=-1)[0]
    act = F.silu(port_ssm.causal_conv(u, p.conv_w, p.conv_b,
                                      state=cache["conv"]))
    new["conv"] = torch.cat([new["conv"][:, :-1],
                             act.to(new["conv"].dtype)], dim=1)
    return out, new


def no_decay(p, xb, _orig=port_rglru.gates):
    """A planted fault: ``rglru_decode`` without the ``a * h`` term."""
    a, gated = _orig(p, xb)
    return torch.zeros_like(a), gated


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_ports_forward(arch):
    lm, _, fwd, dec = _check_traces(arch)
    got = decode_check.compare(lm, fwd, dec)
    assert got["ok"] and got["mixer_layer"] is not None, got
    kinds = port_model.layer_kinds(lm.cfg)
    mixers = {f"{i}.{'mamba' if k == 'ssm' else 'rglru'}"
              for i, k in enumerate(kinds) if k != "local"}
    assert {k for k in dec["outputs"] if not k.endswith((".in", ".attn"))} \
        == mixers


@pytest.mark.parametrize("arch,fault", [
    ("falcon-mamba-7b", "dropped carry"),
    ("falcon-mamba-7b", "activated conv cache"),
    ("recurrentgemma-9b", "dropped carry"),
    ("recurrentgemma-9b", "no decay")])
def test_decode_check_rejects_recurrent_faults(arch, fault, monkeypatch):
    lm, toks, fwd, dec = _check_traces(arch)
    if fault == "dropped carry":
        # A forward fault stays in place while ``compare`` runs each
        # recurrent layer's forward.
        monkeypatch.setattr(port_ssm, "fold_carry", lambda a, b, h: b)
        fwd = decode_check.forward_trace(lm, toks)
    else:
        # A decode fault shows from its first steps, and is lifted before
        # ``compare`` runs the honest forward of each layer.
        with monkeypatch.context() as m:
            if fault == "no decay":
                m.setattr(port_rglru, "gates", no_decay)
            else:
                m.setattr(port_ssm, "mamba_decode", stores_activated_input)
            dec = decode_check.decode_trace(lm, toks[:, :FAULT_STEPS],
                                            FAULT_STEPS)
    got = decode_check.compare(lm, fwd, dec)
    assert not got["ok"] and got["mixer"] > 1, got


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_arch_runs_on_the_cpu(arch, capsys):
    args = port_serve.parser().parse_args(
        ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
         "--prompt-len", "5", "--gen", "3"])
    rec = port_serve.serve_lm(args)
    out = rec["generation"]
    assert out.tokens.shape == (2, 3) and len(out.step_ms) == 4 + 3
    assert ((out.tokens >= 0) & (out.tokens < 256)).all()
    assert rec["launches"] == rec["planned_launches"] == 0
    assert "tok/s" in capsys.readouterr().out
