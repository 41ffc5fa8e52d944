"""Fused projections, the triangle causal attention, and the prefill and
serve step factories, against the reference (``tests/test_train_extras.py``
for the port).

The reference's ``init_params`` weights go to the port through
``interop.params_from_numpy`` (a fused reference model, with ``wqkv`` and
``wi_fused``, loads into a fused port model under the same names).  Both
packages run at fp32 (``COMPUTE_DTYPE`` monkeypatched), and logits are held
within ``RTOL32`` of each row's largest |logit|, the fp32 bound of
``tests/test_torch_lm.py``.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.configs.base import ShapeConfig as RefShape
from repro.configs.base import get_config as ref_config
from repro.models import attention as ref_att
from repro.models import model as ref_model
from repro.train import train_step as ref_ts
from repro_torch import interop
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import mesh as MS
from repro_torch.models import attention as port_att
from repro_torch.models import model as port_model
from repro_torch.models.sharding_ctx import NO_SHARDING
from repro_torch.train import train_step as port_ts

RTOL32 = 1e-4
ARCH = "llama3.2-1b"


@pytest.fixture
def fp32(monkeypatch):
    monkeypatch.setattr(ref_model, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(port_model, "COMPUTE_DTYPE", torch.float32)


@pytest.fixture
def switches():
    yield
    ref_model.set_fused_projections(False)
    port_model.set_fused_projections(False)
    ref_att.set_causal_impl("masked")
    port_att.set_causal_impl("masked")


def _models(fused: bool, seed: int = 0):
    ref_model.set_fused_projections(fused)
    port_model.set_fused_projections(fused)
    rcfg, pcfg = ref_config(ARCH).reduced(), port_config(ARCH).reduced()
    params = ref_model.init_params(rcfg, jax.random.PRNGKey(seed))
    tree = jax.tree.map(np.asarray, params)
    return rcfg, params, interop.params_from_numpy(pcfg, tree)


def _tokens(cfg, b, s):
    return np.random.default_rng(1).integers(
        2, cfg.vocab_size - 1, size=(b, s)).astype(np.int32)


def _check(got, ref, what):
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    bound = RTOL32 * np.abs(ref).max(axis=-1, keepdims=True)
    worst = float((np.abs(got - ref) - bound).max())
    assert worst <= 0, f"{what}: exceeds the fp32 bound by {worst:.3e}"


@pytest.mark.parametrize("fused", [False, True])
def test_fused_projections_match_reference(fused, fp32, switches):
    rcfg, params, model = _models(fused)
    names = dict(model.named_parameters())
    assert ("layers.0.attn.wqkv.kernel" in names) is fused
    assert ("layers.0.mlp.wi_fused.kernel" in names) is fused
    toks = _tokens(rcfg, 2, 64)
    ref = np.asarray(ref_model.forward(rcfg, params,
                                       {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    _check(got, ref, f"fused={fused}")
    # The fused tree comes back out under the reference's names.
    back = interop.params_to_numpy(model)
    np.testing.assert_array_equal(
        back["layers"]["p0"]["attn"]["wqkv" if fused else "wq"]["kernel"],
        np.asarray(params["layers"]["p0"]["attn"]["wqkv" if fused
                                                  else "wq"]["kernel"]))


def test_fused_equals_unfused_on_the_same_weights(fp32, switches):
    rcfg, params, unfused = _models(False)
    toks = torch.from_numpy(_tokens(rcfg, 2, 64))
    port_model.set_fused_projections(True)
    fused = port_model.LM(port_config(ARCH).reduced(), device="cpu")
    own = dict(unfused.named_parameters())
    state = {}
    for name, p in fused.named_parameters():
        if name.endswith("attn.wqkv.kernel"):
            pre = name[:-len("wqkv.kernel")]
            p = torch.cat([own[pre + w + ".kernel"]
                           for w in ("wq", "wk", "wv")], dim=1)
        elif name.endswith("mlp.wi_fused.kernel"):
            pre = name[:-len("wi_fused.kernel")]
            p = torch.cat([own[pre + "wi_gate.kernel"],
                           own[pre + "wi_up.kernel"]], dim=1)
        else:
            p = own[name]
        state[name] = p.detach().clone()
    fused.load_state_dict(state, strict=True)
    with torch.no_grad():
        a, b = unfused(toks).numpy(), fused(toks).numpy()
    _check(b, a, "fused vs unfused")


@pytest.mark.parametrize("seq", [1024, 2048])
def test_triangle_matches_reference(seq, fp32, switches):
    rcfg, params, model = _models(False)
    toks = _tokens(rcfg, 1, seq)
    masked = np.asarray(ref_model.forward(rcfg, params,
                                          {"tokens": jnp.asarray(toks)}))
    ref_att.set_causal_impl("triangle")
    port_att.set_causal_impl("triangle")
    ref = np.asarray(ref_model.forward(rcfg, params,
                                       {"tokens": jnp.asarray(toks)}))
    with torch.no_grad():
        got = model(torch.from_numpy(toks)).numpy()
    _check(got, ref, f"triangle S={seq}")
    _check(got, masked, f"triangle vs masked S={seq}")


def test_set_causal_impl_rejects_unknown(switches):
    with pytest.raises(ValueError):
        port_att.set_causal_impl("bogus")
    assert port_att.CAUSAL_IMPL == "masked"


def test_prefill_and_serve_steps_match_reference(fp32, switches):
    rcfg, params, model = _models(False)
    pcfg = port_config(ARCH).reduced()
    toks = _tokens(rcfg, 2, 32)
    shape = ShapeConfig("p", 32, 2, "prefill")
    prefill, none = port_ts.make_prefill_step(pcfg, shape)
    assert none is None
    ref_prefill, _ = ref_ts.make_prefill_step(rcfg, RefShape("p", 32, 2,
                                                             "prefill"))
    _check(prefill(model, {"tokens": torch.from_numpy(toks)}).numpy(),
           np.asarray(ref_prefill(params, {"tokens": jnp.asarray(toks)})),
           "prefill")
    serve, _ = port_ts.make_serve_step(pcfg, ShapeConfig("d", 8, 2,
                                                         "decode"))
    ref_serve, _ = ref_ts.make_serve_step(rcfg, RefShape("d", 8, 2,
                                                         "decode"))
    cache = model.init_cache(2, 8)
    rcache = ref_model.init_cache(rcfg, 2, 8)
    for t in range(3):
        got = serve(model, cache, torch.from_numpy(toks[:, t]), t).numpy()
        ref, rcache = ref_serve(params, rcache, jnp.asarray(toks[:, t]),
                                jnp.int32(t))
        _check(got, np.asarray(ref), f"serve step {t}")


def test_step_factories_refuse_a_mesh():
    cfg = port_config(ARCH).reduced()
    mesh = MS.abstract_mesh((2, 2), ("data", "model"))
    shape = ShapeConfig("p", 32, 4, "prefill")
    # The train, prefill and serve steps run on a process mesh only (one
    # rank per process), not on the dry run's abstract mesh.
    for make in (port_ts.make_prefill_step, port_ts.make_train_step,
                 port_ts.make_serve_step):
        with pytest.raises(TypeError, match="ProcessMesh"):
            make(cfg, shape, mesh)
    # On a process mesh (one rank per process) each is made, with the
    # policy's specs; here rank (0, 1) of (2, 2).
    rank = MS.ProcessMesh(axis_names=("data", "model"),
                          shape={"data": 2, "model": 2},
                          coords={"data": 0, "model": 1}, rank=1,
                          device=torch.device("cpu"), backend="gloo",
                          groups={}, group_ranks={}, log=None)
    _, specs = port_ts.make_prefill_step(cfg, shape, rank)
    assert specs["logits"] == ("data", None, "model")
    _, specs = port_ts.make_train_step(cfg, ShapeConfig("t", 32, 4, "train"),
                                       rank)
    assert specs["batch"]["labels"] == ("data", None)
    assert port_ts.make_ctx(cfg, None, shape) is NO_SHARDING
    ctx = port_ts.make_ctx(cfg, mesh, shape)
    assert ctx.rules["tokens_bse"] == ("data", "model", None)
    x = torch.zeros(2, 3)
    assert ctx.constrain(x, "tokens_bse") is x
