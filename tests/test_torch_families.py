"""The port's ``local``, ``vlm`` and ``encdec`` families against the
reference, on the CPU: gemma3-12b (five sliding-window layers to one
global), qwen2-vl-7b (M-RoPE, projected patch embeddings) and
whisper-base (an encoder and cross-attention), at their reduced configs.

The same inputs, drawn from numpy with a seed, go through the reference
(``repro.models``) and the port (``repro_torch.models``).  Weights are the
reference's ``init_params`` with every norm scale and bias moved off its
init by seeded noise, sent to the port through
``interop.params_from_numpy``.  The reference's paths here reach no
Pallas kernel.

* Units: ``local_attention`` (windows 8 and 32, S 64 and 96, q blocks of
  16), ``apply_mrope`` with distinct streams, ``sinusoidal_positions``
  and ``layernorm``: fp32 within ``1e-5`` relative (angles of RoPE and
  the sinusoids: a few ulps of the angle); bf16 within
  ``models.model.rounding_tolerance`` of the roundings each does.
* Each arch through ``forward`` (gemma3 at S = 64 > its window of 32, so
  its local layers take ``local_attention``; qwen2-vl with the pipeline's
  ``mm_embeds`` and ``positions_3d``; whisper with ``frames``), through
  48 teacher-forced ``decode_step`` calls (gemma3's 32-slot rings wrap;
  qwen2-vl with ``positions_3d`` as the reference's ``make_serve_step``
  builds them; whisper after ``encode`` and ``prime_cross_cache``) and
  through ``generate`` (the reference's serve meaning: 1-D RoPE for
  qwen2-vl, zero cross K/V for whisper): fp32 (``use_fp32``) within
  ``1e-4`` of each row's largest |logit|; bf16 within
  ``models.model.logit_tolerance``, whose roundings are counted per family
  (``models.model.roundings``).  A greedy token may differ only where the
  reference's top-2 margin is within twice that bound.
* The port's own ``decode_step`` against its ``forward``
  (``models.decode_check``) at bf16 (qwen2-vl with the pipeline's
  distinct M-RoPE streams), and three planted ring and window faults, two
  encoder faults and two M-RoPE stream faults that the check must
  reject.
* ``interop``'s round trip (exact), the full-size parameter counts on the
  ``meta`` device, and ``serve --arch`` of each arch on the CPU.

Seconds in the suite's six-worker run are in ``CHANGES.md`` (PR 21).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_helpers import one_torch_thread, use_fp32  # noqa: F401
from repro.configs.base import get_config as ref_config
from repro.launch import serve as ref_serve
from repro.models import attention as ref_attn
from repro.models import layers as ref_layers
from repro.models import model as ref_model
from repro_torch import interop
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch import serve as port_serve
from repro_torch.models import attention as port_attn
from repro_torch.models import decode_check
from repro_torch.models import layers as port_layers
from repro_torch.models import model as port_model

ARCHS = ("gemma3-12b", "qwen2-vl-7b", "whisper-base")
BATCH, SEQ, STEPS, GEN = 2, 64, 48, 8
RTOL32 = 1e-4
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(params=["fp32", "bf16"])
def precision(request, monkeypatch):
    if request.param == "fp32":
        use_fp32(monkeypatch)
    return request.param


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, dtype=np.float32)).astype(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close32(got, ref, what, rtol=1e-5):
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, what
    err = float(np.abs(g - r).max())
    scale = max(float(np.abs(r).max()), 1e-30)
    assert err <= rtol * scale, f"{what}: {err:.3e} > {rtol} * {scale:.3e}"


def _close_bf16(got, ref, stages, what):
    """Within ``rounding_tolerance`` of ``stages`` bf16 roundings, relative
    to each row's rms (last axis)."""
    g, r = _np(got), _np(ref)
    assert g.shape == r.shape, what
    rms = np.sqrt((r.astype(np.float64) ** 2).mean(axis=-1, keepdims=True))
    bound = port_model.rounding_tolerance(stages, torch.from_numpy(rms),
                                          r.size).numpy()
    excess = float((np.abs(g - r) - bound).max())
    assert excess <= 0, f"{what}: exceeds the bf16 bound by {excess:.3e}"


# ---------------------------------------------------------------------- #
# Units.
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("window", [8, 32])
@pytest.mark.parametrize("s", [64, 96])
def test_local_attention_matches(window, s):
    rng = np.random.default_rng(window + s)
    q = rng.normal(size=(2, s, 4, 16))
    k, v = rng.normal(size=(2, s, 2, 16)), rng.normal(size=(2, s, 2, 16))
    ref = ref_attn.local_attention(_j(q), _j(k), _j(v), window=window,
                                   q_block=16)
    got = port_attn.local_attention(_t(q), _t(k), _t(v), window=window,
                                    q_block=16)
    _close32(got, ref, f"local_attention w={window} S={s}")
    refb = ref_attn.local_attention(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                    _j(v, jnp.bfloat16), window=window,
                                    q_block=16)
    gotb = port_attn.local_attention(
        _t(q, torch.bfloat16), _t(k, torch.bfloat16), _t(v, torch.bfloat16),
        window=window, q_block=16)
    assert gotb.dtype == torch.bfloat16
    # q's scale, the probabilities and the output are rounded to bf16.
    _close_bf16(gotb, refb, 3, f"local_attention bf16 w={window} S={s}")


def test_local_attention_is_the_window_of_causal_attention():
    """A naive oracle: query i sees keys i - window < j <= i."""
    rng = np.random.default_rng(5)
    s, window = 64, 8
    q = rng.normal(size=(1, s, 2, 8))
    k, v = rng.normal(size=(1, s, 2, 8)), rng.normal(size=(1, s, 2, 8))
    got = port_attn.local_attention(_t(q), _t(k), _t(v), window=window,
                                    q_block=16)
    logits = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(8)
    i, j = np.arange(s)[:, None], np.arange(s)[None, :]
    logits = np.where((j <= i) & (i - j < window), logits, -np.inf)
    p = np.exp(logits - logits.max(-1, keepdims=True))
    want = np.einsum("bhqk,bkhd->bqhd", p / p.sum(-1, keepdims=True), v)
    _close32(got, want, "local_attention vs the naive window")


@pytest.mark.parametrize("bf16", [False, True])
def test_apply_mrope_matches_with_distinct_streams(bf16):
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 7, 3, 32))
    pos = rng.integers(0, 4096, size=(3, 2, 7))
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    ref = ref_layers.apply_mrope(_j(x, jd), jnp.asarray(pos, jnp.int32),
                                 1e6)
    got = port_layers.apply_mrope(_t(x, td), torch.from_numpy(pos), 1e6)
    assert got.dtype == td
    if bf16:
        _close_bf16(got, ref, 1, "mrope bf16")
    else:
        # Angles up to ~4096 rad: fp32 sin/cos of two libraries differ by
        # a few ulps of the angle.
        _close32(got, ref, "mrope", rtol=4096 * 4 * EPS32)
    # Each section turns by its own stream: the temporal stream moves only
    # the first quarter of the frequency slots.
    moved = pos.copy()
    moved[0] += 1
    other = port_layers.apply_mrope(_t(x), torch.from_numpy(moved), 1e6)
    base = port_layers.apply_mrope(_t(x), torch.from_numpy(pos), 1e6)
    changed = (other - base).abs().amax(dim=(0, 1, 2)) > 0
    half = np.arange(16)
    want = np.concatenate([half < 4, half < 4])
    assert np.array_equal(changed.numpy(), want)


def test_sinusoidal_positions_match():
    ref = ref_layers.sinusoidal_positions(1500, 512)
    got = port_layers.sinusoidal_positions(1500, 512)
    assert got.shape == (1500, 512) and got.dtype == torch.float32
    # Angles up to 1499 rad: a few ulps of the angle.
    _close32(got, ref, "sinusoidal_positions", rtol=1500 * 4 * EPS32)


@pytest.mark.parametrize("bf16", [False, True])
def test_layernorm_matches(bf16):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 64)) * 3.0 + 1.0
    scale, bias = 1 + rng.normal(size=64) * 0.1, rng.normal(size=64) * 0.1
    jd, td = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    ref = ref_layers.layernorm({"scale": _j(scale), "bias": _j(bias)},
                               _j(x, jd))
    norm = port_layers.LayerNorm(64, device=torch.device("cpu"))
    with torch.no_grad():
        norm.scale.copy_(_t(scale))
        norm.bias.copy_(_t(bias))
    got = norm(_t(x, td))
    assert got.dtype == td and norm.eps == 1e-5
    if bf16:
        _close_bf16(got, ref, 1, "layernorm bf16")
    else:
        _close32(got, ref, "layernorm")


# ---------------------------------------------------------------------- #
# The three archs against the reference.
# ---------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def trees():
    """Each arch's reference weights as numpy, made once for the file."""
    return {}


def _weights(cfg) -> dict:
    """The reference's ``init_params``, each norm scale and bias moved off
    its init (ones or zeros) by ``N(0, 0.1**2)`` / ``N(0, 0.02**2)``."""
    tree = jax.tree.map(np.asarray,
                        ref_model.init_params(cfg, jax.random.PRNGKey(0)))
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
        trees[arch] = _weights(cfg)
    tree = trees[arch]
    model = interop.params_from_numpy(port_config(arch).reduced(), tree)
    return cfg, jax.tree.map(jnp.asarray, tree), model


def _batch(arch, seq=SEQ, seed=0) -> dict:
    """Tokens and the data pipeline's modality stubs (whisper's frames,
    qwen2-vl's patch embeddings on a grid and its 3-D positions)."""
    pipe = Pipeline(port_config(arch).reduced(),
                    ShapeConfig("t", seq, BATCH, "train"),
                    DataConfig(seed=seed))
    batch = pipe.batch_for_step(0)
    del batch["labels"]
    return batch


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
def test_forward_matches(arch, precision, trees, monkeypatch):
    cfg, params, model = _models(arch, trees)
    batch = _batch(arch)
    calls = []
    local = port_attn.local_attention
    monkeypatch.setattr(port_attn, "local_attention",
                        lambda *a, **kw: calls.append(1) or local(*a, **kw))
    ref = np.asarray(jax.jit(lambda p, b: ref_model.forward(cfg, p, b))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))
    got = model(torch.from_numpy(batch["tokens"]),
                **{k: torch.from_numpy(v) for k, v in batch.items()
                   if k != "tokens"}).numpy()
    assert got.dtype == np.float32
    # gemma3's five local layers at S = 64 > window 32 take the band.
    assert len(calls) == (5 if arch == "gemma3-12b" else 0)
    _check_logits(cfg, got, ref, precision, f"{arch} forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_matches_teacher_forced(arch, precision, trees):
    cfg, params, model = _models(arch, trees)
    batch = _batch(arch)
    toks = batch["tokens"]

    def ref_step(p, c, t, pos):
        extras = {"positions_3d": jnp.broadcast_to(
            pos, (3, t.shape[0], 1)).astype(jnp.int32)} if cfg.mrope \
            else None
        return ref_model.decode_step(cfg, p, c, t, pos, batch_extras=extras)
    step = jax.jit(ref_step)
    cache_r = ref_model.init_cache(cfg, BATCH, STEPS)
    cache_p = model.init_cache(BATCH, STEPS)
    if cfg.family == "encdec":
        enc = ref_model._run_encoder(cfg, params, jnp.asarray(batch["frames"]),
                                     None)
        cache_r = ref_model.prime_cross_cache(cfg, params, cache_r, enc)
        model.prime_cross_cache(
            cache_p, model.encode(torch.from_numpy(batch["frames"])))
    if cfg.name.startswith("gemma3"):
        # The local layers' rings hold the 32-slot window: 48 steps wrap.
        assert [c["k"].shape[1] for c in cache_p[:6]] == [32] * 5 + [STEPS]
    ref, got = [], []
    with torch.inference_mode():
        for t in range(STEPS):
            logits, cache_r = step(params, cache_r, jnp.asarray(toks[:, t]),
                                   jnp.int32(t))
            ref.append(np.asarray(logits))
            p3 = torch.full((3, BATCH, 1), t) if cfg.mrope else None
            got.append(model.decode_step(cache_p, torch.from_numpy(toks[:, t]),
                                         t, positions_3d=p3).numpy())
    _check_logits(cfg, np.stack(got), np.stack(ref), precision,
                  f"{arch} decode")


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches(arch, trees, monkeypatch):
    """At bf16, the serving dtype: greedy tokens equal the reference's
    ``generate`` (1-D RoPE for qwen2-vl, zero cross K/V for whisper)."""
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


def test_encdec_forward_needs_frames(trees):
    _, _, model = _models("whisper-base", trees)
    with pytest.raises(ValueError, match="frames"):
        model(torch.zeros(1, 4, dtype=torch.int64))


@pytest.mark.parametrize("arch", ARCHS)
def test_interop_round_trip_is_exact(arch, trees):
    cfg, _, _ = _models(arch, trees)
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


@pytest.mark.parametrize("arch,extra", [
    # The final norm.
    ("gemma3-12b", 3840),
    # The final norm and mm_proj, which the config's count leaves out.
    ("qwen2-vl-7b", 3584 + 3584 ** 2),
    # 103 padded vocab rows; LayerNorm biases the count leaves out (ln1,
    # ln2, ln_cross per decoder layer, ln1, ln2 per encoder layer); the
    # final norm's and the encoder norm's scale and bias.
    ("whisper-base", 103 * 512 + 6 * 3 * 512 + 6 * 2 * 512 + 2 * 2 * 512),
])
def test_full_size_model_holds_the_configs_parameters(arch, extra):
    cfg = port_config(arch)
    model = port_model.init_params(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == \
        cfg.param_count() + extra
    assert len(model.layers) == cfg.num_layers
    kinds = [b.attn.kind for b in model.layers]
    assert kinds == port_model.layer_kinds(cfg)
    if arch == "gemma3-12b":
        assert kinds[:6] == ["local"] * 5 + ["global"] and \
            kinds.count("global") == 8
        assert cfg.param_count() + extra == 11_765_395_200
    if arch == "whisper-base":
        assert len(model.encoder.layers) == cfg.encoder_layers


# ---------------------------------------------------------------------- #
# The port's decode against its forward, and planted faults.
# ---------------------------------------------------------------------- #

def _traces(arch, seq):
    cfg = port_config(arch).reduced()
    lm = port_model.LM(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    batch = _batch(arch, seq=seq)
    toks = torch.from_numpy(batch["tokens"])
    kw, enc = {}, None
    if cfg.family == "encdec":
        kw["frames"] = torch.from_numpy(batch["frames"])
        with torch.inference_mode():
            enc = lm.encode(kw["frames"])
    if cfg.mrope:
        kw["positions_3d"] = torch.from_numpy(batch["positions_3d"])
    return lm, toks, kw, enc


#: Decode-check lengths: gemma3's 32-slot rings wrap twice; qwen2-vl's
#: pipeline stubs put 64 patch tokens on an 8 x 8 grid, whose distinct
#: height and width streams an M-RoPE fault must move.
CHECK_SEQ = {"gemma3-12b": 96, "qwen2-vl-7b": 256, "whisper-base": 48}


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_the_ports_forward(arch):
    lm, toks, kw, enc = _traces(arch, CHECK_SEQ[arch])
    fwd = decode_check.forward_trace(lm, toks, **kw)
    dec = decode_check.decode_trace(lm, toks, toks.shape[1], enc_out=enc,
                                    positions_3d=kw.get("positions_3d"))
    got = decode_check.compare(lm, fwd, dec)
    assert got["ok"], got


def _ring_slot_one_off(kind, pos, s_c, _orig=port_model.cache_slot):
    return (pos + 1) % s_c if kind == "local" else _orig(kind, pos, s_c)


def _ring_full_from_the_start(kind, pos, s_c, device,
                              _orig=port_model.cache_mask):
    if kind == "local":
        return torch.ones(s_c, dtype=torch.bool, device=device)
    return _orig(kind, pos, s_c, device)


@pytest.mark.parametrize("fault", ["slot", "mask", "window"])
def test_decode_check_rejects_ring_faults(fault, monkeypatch):
    lm, toks, _, _ = _traces("gemma3-12b", 96)
    if fault == "window":
        monkeypatch.setattr(
            port_attn, "local_attention",
            lambda q, k, v, window, q_block=512:
            port_attn.chunked_attention(q, k, v, causal=True))
    fwd = decode_check.forward_trace(lm, toks)
    if fault == "slot":
        monkeypatch.setattr(port_model, "cache_slot", _ring_slot_one_off)
    if fault == "mask":
        monkeypatch.setattr(port_model, "cache_mask",
                            _ring_full_from_the_start)
    dec = decode_check.decode_trace(lm, toks, 96)
    got = decode_check.compare(lm, fwd, dec)
    assert not got["ok"] and got["attn"] > 1, got


@pytest.mark.parametrize("fault", ["zero cross", "no encoder positions"])
def test_decode_check_rejects_encoder_faults(fault):
    lm, toks, kw, enc = _traces("whisper-base", 48)
    fwd = decode_check.forward_trace(lm, toks, **kw)
    if fault == "zero cross":
        enc = None
    else:
        with torch.inference_mode():
            x = kw["frames"].to(lm.dtype)
            for block in lm.encoder.layers:
                x = block(x, None)
            enc = lm.encoder.norm(x)
    got = decode_check.compare(lm, fwd, decode_check.decode_trace(
        lm, toks, 48, enc_out=enc))
    assert not got["ok"] and got["attn"] > 1, got


@pytest.mark.parametrize("streams", [(0, 2, 1), (0, 0, 0)],
                         ids=["height and width swapped", "all temporal"])
def test_decode_check_rejects_mrope_faults(streams, monkeypatch):
    lm, toks, kw, _ = _traces("qwen2-vl-7b", CHECK_SEQ["qwen2-vl-7b"])
    p3 = kw["positions_3d"]
    fwd = decode_check.forward_trace(lm, toks, **kw)
    mrope = port_layers.apply_mrope
    monkeypatch.setattr(port_layers, "apply_mrope",
                        lambda x, p, theta: mrope(x, p[list(streams)], theta))
    n_mm = int((p3[1, 0] != p3[0, 0]).nonzero().max()) + 1
    got = decode_check.compare(lm, fwd, decode_check.decode_trace(
        lm, toks, n_mm, cache_len=toks.shape[1], positions_3d=p3))
    assert not got["ok"] and got["attn"] > 1, got


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
