"""The port's optimiser (``repro_torch.optim``) against the reference's
``repro.optim`` on the CPU: the learning-rate schedule, AdamW and the int8
gradient compression.

Inputs (parameter trees, gradients, values) come from numpy with a seed
and go to both packages.  The reference's own optimiser tests are ported
beside the comparisons.

Bounds:
* schedule: ``4 * eps_f32`` relative (the two packages' ``cos`` differ in
  the last bits);
* AdamW after 3 steps, both fed the same gradients: ``grad_norm`` within
  ``4 * eps_f32`` relative; ``mu`` and ``nu`` within ``8 * eps`` relative
  of the state dtype's eps (fp32: a few roundings in another order or
  fused; bf16: one storage rounding that may fall the other way), of
  ``mu``'s magnitude sum ``b1 * |mu| + (1 - b1) * |g|`` (mu cancels); each
  parameter within ``8 * eps_f32 * |p|`` plus ``UPDATE_RTOL`` of the
  learning rate summed over the steps, ``UPDATE_RTOL = 16 * eps`` of the
  state dtype (the update ``mu / (sqrt(nu) + eps)`` inherits the state's
  relative error, about twice over);
* compression: q exactly equal, scales within one fp32 ulp.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:      # declared dev dep; CI installs the real one
    from _hypothesis_stub import given, settings, st

from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro.optim.schedule import cosine_with_warmup as ref_schedule
from repro_torch.core.tree import leaves
from repro_torch.optim import adamw, compression
from repro_torch.optim.schedule import cosine_with_warmup

EPS32 = float(np.finfo(np.float32).eps)
STEPS = 3


def _eps(dtype: str) -> float:
    return float(torch.finfo(getattr(torch, dtype)).eps)


# ---------------------------------------------------------------------- #
# Schedule.
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("kwargs", [
    {}, {"warmup_steps": 10, "total_steps": 100},
    {"warmup_steps": 2, "total_steps": 8, "min_ratio": 0.0},
    {"warmup_steps": 0, "total_steps": 50, "min_ratio": 0.3},
    {"warmup_steps": 20, "total_steps": 20}])
def test_schedule_matches_reference(kwargs):
    for step in list(range(0, 40)) + [99, 100, 101, 499, 500, 501, 10**5]:
        want = float(ref_schedule(step, **kwargs))
        got = cosine_with_warmup(step, **kwargs)
        assert isinstance(got, float)
        assert abs(got - want) <= 4 * EPS32 * abs(want), (step, got, want)
        t = cosine_with_warmup(torch.tensor(step), **kwargs)
        assert t.dtype == torch.float32 and t.shape == () and \
            float(t) == got


def test_schedule_shape():
    assert cosine_with_warmup(0) == 0.0      # default warmup 500
    assert cosine_with_warmup(0, warmup_steps=10) == 0.0
    assert cosine_with_warmup(10, warmup_steps=10) == \
        pytest.approx(1.0, abs=0.01)
    end = cosine_with_warmup(100000, warmup_steps=10, total_steps=100000,
                             min_ratio=0.1)
    assert end == pytest.approx(0.1, abs=0.01)


# ---------------------------------------------------------------------- #
# AdamW.
# ---------------------------------------------------------------------- #

SHAPES = {"embed": {"table": (16, 8)}, "final_norm": {"scale": (8,)},
          "layers": {"w": (3, 8, 5), "b": (5,), "moe": {"router": (8, 4)}}}


def _tree(rng, scale=1.0, shapes=SHAPES):
    return {k: _tree(rng, scale, v) if isinstance(v, dict) else
            (rng.normal(size=v) * scale).astype(np.float32)
            for k, v in shapes.items()}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else
            torch.from_numpy(v.copy()) for k, v in tree.items()}


def _flat(tree):
    """``{path: numpy array}`` of a nested dict of arrays or tensors."""
    return {k: np.asarray(v.float() if isinstance(v, torch.Tensor) else
                          jnp.asarray(v, jnp.float32))
            for k, v in leaves(tree)}


def _run_both(cfg, grad_scale, seed=0, lr_scales=(0.5, 1.0, 0.9)):
    """STEPS updates of the same random tree with the same random
    gradients in both packages; returns their params, states and
    metrics."""
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng, grad_scale) for _ in range(STEPS)]
    ref_cfg = ref_adamw.AdamWConfig(**vars(cfg))
    r_p = jax.tree.map(jnp.asarray, params)
    r_s = ref_adamw.init_state(r_p, ref_cfg)
    p_p = _torch_tree(params)
    p_s = adamw.init_state(p_p, cfg)
    r_m, p_m = [], []
    for g, lr_scale in zip(grads, lr_scales):
        r_p, r_s, m = ref_adamw.apply_updates(
            r_p, jax.tree.map(jnp.asarray, g), r_s, ref_cfg,
            jnp.float32(lr_scale))
        r_m.append(float(m["grad_norm"]))
        p_m.append(float(adamw.apply_updates(p_p, _torch_tree(g), p_s, cfg,
                                             lr_scale)["grad_norm"]))
    mu_abs = {k: np.zeros_like(v) for k, v in _flat(params).items()}
    for g in grads:
        for k, v in _flat(g).items():
            mu_abs[k] = cfg.b1 * mu_abs[k] + (1 - cfg.b1) * np.abs(v)
    return (r_p, r_s, r_m), (p_p, p_s, p_m), sum(lr_scales), mu_abs


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale,clipped", [(0.05, False),
                                                (10.0, True)])
@pytest.mark.parametrize("weight_decay", [0.1, 0.0])
def test_adamw_matches_reference(state_dtype, grad_scale, clipped,
                                 weight_decay):
    cfg = adamw.AdamWConfig(lr=1e-2, weight_decay=weight_decay,
                            state_dtype=state_dtype)
    (r_p, r_s, r_m), (p_p, p_s, p_m), lr_sum, mu_abs = _run_both(
        cfg, grad_scale)
    assert all((m > cfg.grad_clip) == clipped for m in r_m)
    np.testing.assert_allclose(p_m, r_m, rtol=4 * EPS32)
    assert int(p_s["count"]) == int(r_s["count"]) == STEPS
    assert p_s["count"].dtype == torch.int32
    eps = _eps(state_dtype)
    for which in ("mu", "nu"):
        got, want = _flat(p_s[which]), _flat(r_s[which])
        assert set(got) == set(want)
        for k in want:
            assert next(v for n, v in leaves(p_s[which])
                        if n == k).dtype == getattr(torch, state_dtype)
            scale = mu_abs[k] if which == "mu" else np.abs(want[k])
            excess = np.abs(got[k] - want[k]) - 8 * eps * scale
            assert excess.max() <= 0, f"{which}/{k}: by {excess.max()}"
    got, want = _flat(p_p), _flat(r_p)
    for k in want:
        bound = 8 * EPS32 * np.abs(want[k]) + 16 * eps * cfg.lr * lr_sum
        excess = np.abs(got[k] - want[k]) - bound
        assert excess.max() <= 0, f"{k}: exceeds by {excess.max():.3e}"


def test_global_norm_matches_reference():
    rng = np.random.default_rng(3)
    tree = _tree(rng, 2.0)
    want = float(ref_adamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    got = adamw.global_norm(_torch_tree(tree))
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 4 * EPS32 * want


def test_adamw_descends_quadratic():
    params = {"w": torch.tensor([3.0, -2.0, 5.0], requires_grad=True)}
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    state = adamw.init_state(params, cfg)
    losses = []
    for _ in range(100):
        loss = (params["w"] ** 2).sum()
        g, = torch.autograd.grad(loss, [params["w"]])
        m = adamw.apply_updates(params, {"w": g}, state, cfg)
        losses.append(float((params["w"].detach() ** 2).sum()))
    assert losses[-1] < 1e-2 * losses[0]
    assert float(m["grad_norm"]) > 0


def test_grad_clip_bounds_update():
    params = {"w": torch.zeros(3)}
    cfg = adamw.AdamWConfig(lr=1.0, grad_clip=1.0, weight_decay=0.0)
    state = adamw.init_state(params, cfg)
    m = adamw.apply_updates(params, {"w": torch.tensor([1e6, 0.0, 0.0])},
                            state, cfg)
    assert float(m["grad_norm"]) == pytest.approx(1e6)
    assert bool((params["w"].abs() < 10).all())


def test_state_dtype_bf16():
    params = {"w": torch.zeros(4)}
    cfg = adamw.AdamWConfig(state_dtype="bfloat16")
    state = adamw.init_state(params, cfg)
    assert state["mu"]["w"].dtype == torch.bfloat16
    adamw.apply_updates(params, {"w": torch.ones(4)}, state, cfg)
    assert state["mu"]["w"].dtype == torch.bfloat16
    assert state["nu"]["w"].dtype == torch.bfloat16


def test_apply_updates_refuses_other_keys():
    params = {"w": torch.zeros(2)}
    state = adamw.init_state(params, adamw.AdamWConfig())
    with pytest.raises(ValueError):
        adamw.apply_updates(params, {"v": torch.ones(2)}, state,
                            adamw.AdamWConfig())


# ---------------------------------------------------------------------- #
# Compression.
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("seed,scale", [(0, 1.0), (1, 1e-3), (2, 300.0),
                                        (3, 0.0)])
def test_quantize_matches_reference(seed, scale):
    x = (np.random.default_rng(seed).normal(size=(7, 13)) * scale) \
        .astype(np.float32)
    q_r, s_r = ref_comp.quantize_int8(jnp.asarray(x))
    q_p, s_p = compression.quantize_int8(torch.from_numpy(x))
    assert q_p.dtype == torch.int8 and s_p.dtype == torch.float32
    np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
    assert abs(float(s_p) - float(s_r)) <= EPS32 * float(s_r)
    np.testing.assert_allclose(
        compression.dequantize_int8(q_p, s_p).numpy(),
        np.asarray(ref_comp.dequantize_int8(q_r, s_r)),
        rtol=2 * EPS32, atol=0)


def test_compress_grad_with_error_feedback_matches_reference():
    rng = np.random.default_rng(5)
    res_r = jnp.zeros(64)
    res_p = compression.init_residuals({"g": torch.zeros(64)})["g"]
    for _ in range(5):
        g = rng.normal(size=64).astype(np.float32)
        q_r, s_r, res_r = ref_comp.compress_grad(jnp.asarray(g), res_r)
        q_p, s_p, res_p = compression.compress_grad(torch.from_numpy(g),
                                                    res_p)
        np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_r))
        np.testing.assert_allclose(res_p.numpy(), np.asarray(res_r),
                                   rtol=0, atol=4 * EPS32 * float(s_r))


@given(st.lists(st.floats(min_value=-100, max_value=100,
                          allow_nan=False), min_size=1, max_size=64))
@settings(max_examples=50, deadline=None)
def test_quantize_error_bound(vals):
    x = torch.tensor(vals, dtype=torch.float32)
    q, scale = compression.quantize_int8(x)
    err = (compression.dequantize_int8(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_is_unbiased_over_steps():
    rng = np.random.default_rng(0)
    residual = torch.zeros(32)
    sent, true = np.zeros(32), np.zeros(32)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=32).astype(np.float32))
        q, scale, residual = compression.compress_grad(g, residual)
        sent += compression.dequantize_int8(q, scale).numpy()
        true += g.numpy()
    np.testing.assert_allclose(sent + residual.numpy(), true, rtol=1e-4,
                               atol=1e-4)


def test_init_residuals_shapes():
    res = compression.init_residuals({"a": torch.ones(2, 3),
                                      "b": {"c": torch.ones(4,
                                                            dtype=torch.bfloat16)}})
    assert res["a"].shape == (2, 3) and res["b"]["c"].dtype == torch.float32
    assert not bool(res["a"].any())


def test_compressed_psum_needs_several_cards():
    """It reduces over an axis of a process mesh: with none given or
    entered it raises (the multi-rank cases are in
    ``tests/test_torch_multicard_optim.py``)."""
    with pytest.raises(RuntimeError, match="no process mesh"):
        compression.compressed_psum(torch.ones(2), torch.zeros(2), "pod")
