"""The port's training path against the reference's, on the CPU at fp32:
the grouped matmul's autograd (``GroupedMatmulFn``), the MoE layer's
gradient, the chunked loss, and one train step of each of the five archs
(``repro_torch.train.train_step`` against
``repro.train.train_step.make_train_step(..., mesh=None)``); three steps
and the step's variants are in ``tests/test_torch_train_steps.py``.  The
inputs, runs and bounds both files share are in
``tests/_torch_train_helpers.py``.

Both packages' ``COMPUTE_DTYPE`` are monkeypatched to fp32.  Weights are
the reference's ``init_params`` (norm scales and biases redrawn from a
seed so that they are not the identity), sent to the port through
``interop.params_from_numpy(masters=True)``; gradients and updated weights
come back through ``interop.tree_to_numpy``.  Token batches come from
numpy with a seed.

Bounds:
* gradients: each leaf within ``GRAD_RTOL`` of its largest |gradient| (two
  fp32 computations of the same sums in another order; measured worst
  1.7e-6);
* loss within ``4 * eps_f32`` relative, ``grad_norm`` within
  ``GRAD_RTOL`` relative;
* updated weights, with the element rule: AdamW's ``m / (sqrt(v) + eps)``
  normalises each element, so an element whose gradient is at the level
  of the gradients' error bound may move by up to the learning rate in
  either package.  An element is compared where its gradient is at least
  ``RESOLVED`` times the bound ``GRAD_RTOL * max|g|`` at every step (its
  update direction then differs by at most about ``2 / RESOLVED``), or
  exactly zero at every step (pure decay): ``|p - p_ref| <= 4 / RESOLVED
  * lr * sum(lr_scale) + 8 * eps_f32 * |p_ref|``.  The rest are counted,
  and must be at most ``MAX_UNRESOLVED`` of all elements (measured: 2-6 %
  after one step, up to 13.5 % after three, where an element is left out
  if any step's gradient is small).
* routing: a near-tie could flip an expert between the packages.  Every
  router call of the port is recorded; each token's top-k margin (k-th
  minus (k+1)-th logit) must exceed ``2 * GRAD_RTOL`` of the row's largest
  |logit| (ten times the two packages' logit agreement), so that both
  route alike.  A near-tie fails the test; it is never hidden.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_helpers import (ARCHS, EPS32, PortRoutes, _batch,
                                  _check_grads, _check_metrics,
                                  _check_params, _paths, _run_steps,
                                  _weights, use_fp32)
from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.configs.base import get_config as ref_config
from repro.models import model as ref_model
from repro.models import moe as ref_moe
from repro.train import train_step as ref_ts
from repro_torch import interop
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ShapeConfig as PortShape
from repro_torch.kernels.grouped_matmul import (GroupedMatmulFn,
                                                grouped_matmul,
                                                grouped_matmul_plain)
from repro_torch.models import model as port_model
from repro_torch.models import moe as port_moe
from repro_torch.train import train_step


@pytest.fixture(autouse=True)
def fp32(monkeypatch):
    use_fp32(monkeypatch)


# ---------------------------------------------------------------------- #
# GroupedMatmulFn.
# ---------------------------------------------------------------------- #

def _ffn_case(seed=0, e=4, c=20, d=32, f=48):
    rng = np.random.default_rng(seed)
    return {"buf": rng.normal(size=(e, c, d)).astype(np.float32),
            "w_gate": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(
                np.float32),
            "w_up": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(
                np.float32),
            "w_down": (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(
                np.float32),
            "cot": rng.normal(size=(e, c, d)).astype(np.float32)}


def test_grouped_autograd_matches_reference_expert_ffn():
    """``MoE.expert_ffn`` on the padded capacity buffer (two grouped
    products through ``GroupedMatmulFn``) against ``jax.grad`` of the
    reference's ``_expert_ffn`` (its einsums) on the unpadded buffer."""
    case = _ffn_case()
    e, c, d = case["buf"].shape
    f = case["w_gate"].shape[2]

    def ref_loss(wg, wu, wd, buf):
        return jnp.sum(ref_moe._expert_ffn(wg, wu, wd, buf) * case["cot"])

    want = jax.grad(ref_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(case[k]) for k in ("w_gate", "w_up", "w_down", "buf")))
    moe = port_moe.MoE(d, f, e, 2, 1.25, dtype=torch.float32,
                       device=torch.device("cpu"), generator=None,
                       trainable=True)
    with torch.no_grad():
        moe.w_gate_up.copy_(torch.from_numpy(
            np.concatenate([case["w_gate"], case["w_up"]], axis=2)))
        moe.w_down.copy_(torch.from_numpy(case["w_down"]))
    rows = port_moe.padded_capacity(c)
    buf = torch.zeros(e, rows, d)
    buf[:, :c] = torch.from_numpy(case["buf"])
    buf.requires_grad_()
    cot = torch.zeros(e, rows, d)
    cot[:, :c] = torch.from_numpy(case["cot"])
    (moe.expert_ffn(buf) * cot).sum().backward()
    gu = moe.w_gate_up.grad.numpy()
    got = {"w_gate": gu[..., :f], "w_up": gu[..., f:],
           "w_down": moe.w_down.grad.numpy(),
           "buf": buf.grad[:, :c].numpy()}
    _check_grads(got, dict(zip(("w_gate", "w_up", "w_down", "buf"),
                               map(np.asarray, want))), "expert_ffn")
    assert not bool(buf.grad[:, c:].any())


@pytest.mark.parametrize("bm", [64, 128])
def test_grouped_autograd_matches_autograd_of_plain(bm):
    """``dx`` and ``dw`` of ``GroupedMatmulFn`` against autograd through
    ``grouped_matmul_plain`` on expert-major blocks (fp32: the same
    products in another order)."""
    rng = np.random.default_rng(bm)
    e, runs, k, n = 3, 2, 64, 128
    x = torch.from_numpy(rng.normal(size=(e * runs * bm, k)).astype(
        np.float32))
    w = torch.from_numpy(rng.normal(size=(e, k, n)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(e * runs * bm, n)).astype(
        np.float32))
    gids = torch.arange(e, dtype=torch.int32).repeat_interleave(runs)
    grads = {}
    for name, fn in (("fn", grouped_matmul), ("plain", grouped_matmul_plain)):
        xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
        out = fn(xg, wg, gids, bm=bm, bk=64, bn=128,
                 expert_rows=runs * bm)
        assert (out.grad_fn.name() == "GroupedMatmulFnBackward") == \
            (name == "fn")
        out.backward(dout)
        grads[name] = {"dx": xg.grad.numpy(), "dw": wg.grad.numpy()}
    _check_grads(grads["fn"], grads["plain"], "GroupedMatmulFn")


def test_padding_rows_share_of_dw_is_exactly_zero():
    """Zero rows of x contribute exactly nothing to ``dw``, whatever the
    gradient on them: ``dw`` is bit for bit the same with garbage or zeros
    in ``dout``'s padding rows."""
    rng = np.random.default_rng(7)
    e, bm, k, n = 4, 64, 32, 48
    x = rng.normal(size=(e, bm, k)).astype(np.float32)
    x[:, 40:] = 0
    w = torch.from_numpy(rng.normal(size=(e, k, n)).astype(np.float32))
    gids = torch.arange(e, dtype=torch.int32)
    dout = rng.normal(size=(e, bm, n)).astype(np.float32)
    clean = dout.copy()
    clean[:, 40:] = 0
    dws = []
    for d in (dout, clean):
        wg = w.clone().requires_grad_()
        out = grouped_matmul(torch.from_numpy(x.reshape(-1, k)), wg, gids,
                             bm=bm, bk=32, bn=48, expert_rows=bm)
        out.backward(torch.from_numpy(d.reshape(-1, n)))
        dws.append(wg.grad)
    assert torch.equal(dws[0], dws[1])


def test_weight_gradient_refuses_another_layout():
    """The weight gradient needs the layout stated (``expert_rows``), and
    a stated layout that the shapes do not fit raises at once; ``dx``
    alone takes any layout."""
    x = torch.randn(4 * 64, 32, requires_grad=True)
    w = torch.randn(2, 32, 64, requires_grad=True)
    gids = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    out = GroupedMatmulFn.apply(x, w, gids, 64, 32, 64, None)
    with pytest.raises(ValueError, match="expert-major"):
        out.sum().backward()
    for rows in (64, 96, 0):
        with pytest.raises(ValueError, match="expert_rows"):
            grouped_matmul(x, w, gids, bm=64, bk=32, bn=64,
                           expert_rows=rows)
        with pytest.raises(ValueError, match="expert_rows"):
            grouped_matmul_plain(x, w, gids, bm=64, expert_rows=rows)
    xd = x.detach().requires_grad_()
    GroupedMatmulFn.apply(xd, w.detach(), gids, 64, 32, 64,
                          None).sum().backward()
    assert xd.grad is not None          # dx alone takes any layout


# ---------------------------------------------------------------------- #
# The MoE layer.
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("tokens,capacity_factor", [(6, 1.25), (48, 1.25),
                                                    (48, 0.5)])
def test_moe_layer_gradient_matches_reference(tokens, capacity_factor,
                                              monkeypatch):
    """``MoE.forward`` against ``jax.grad`` of ``repro.models.moe.moe_ffn``
    with respect to x and every weight; 48 tokens at capacity factor 0.5
    drop slots (checked), so the dropped-slot path is differentiated."""
    routes = PortRoutes(monkeypatch)
    rng = np.random.default_rng(tokens)
    e, k, d, f = 8, 2, 32, 48
    params = {"router": {"kernel": (rng.normal(size=(d, e)) / np.sqrt(d))
                         .astype(np.float32)},
              "w_gate": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(
                  np.float32),
              "w_up": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(
                  np.float32),
              "w_down": (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(
                  np.float32)}
    x = rng.normal(size=(2, tokens // 2, d)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)

    def ref_loss(p, x):
        return jnp.sum(ref_moe.moe_ffn(p, x, k=k, num_experts=e,
                                       capacity_factor=capacity_factor)
                       * cot)

    g_p, g_x = jax.grad(ref_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    moe = port_moe.MoE(d, f, e, k, capacity_factor, dtype=torch.float32,
                       device=torch.device("cpu"), generator=None,
                       trainable=True)
    with torch.no_grad():
        moe.router.copy_(torch.from_numpy(params["router"]["kernel"]))
        moe.w_gate_up.copy_(torch.from_numpy(
            np.concatenate([params["w_gate"], params["w_up"]], axis=2)))
        moe.w_down.copy_(torch.from_numpy(params["w_down"]))
    xt = torch.from_numpy(x).requires_grad_()
    (moe(xt) * torch.from_numpy(cot)).sum().backward()
    routes.check(k)
    cap = port_moe.capacity(tokens, k, e, capacity_factor)
    _, ids = port_moe.router(torch.from_numpy(x.reshape(-1, d)), moe.router,
                             k)
    dropped = int(torch.clamp(torch.bincount(ids.flatten(), minlength=e)
                              - cap, min=0).sum())
    assert dropped > 0 or capacity_factor >= 1
    gu = moe.w_gate_up.grad.numpy()
    got = {"router": moe.router.grad.numpy(), "w_gate": gu[..., :f],
           "w_up": gu[..., f:], "w_down": moe.w_down.grad.numpy(),
           "x": xt.grad.numpy()}
    want = {"router": np.asarray(g_p["router"]["kernel"]),
            "w_gate": np.asarray(g_p["w_gate"]),
            "w_up": np.asarray(g_p["w_up"]),
            "w_down": np.asarray(g_p["w_down"]), "x": np.asarray(g_x)}
    _check_grads(got, want, f"moe T={tokens} cf={capacity_factor}")


# ---------------------------------------------------------------------- #
# Train steps.
# ---------------------------------------------------------------------- #

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, monkeypatch):
    """One step: loss, lr scale, grad_norm, every gradient leaf (against
    ``jax.grad`` of the reference's loss), the updated weights."""
    cfg = ref_config(arch).reduced()
    batch = _batch(cfg)

    def ref_loss(p, b):
        logits = ref_model.forward(cfg, p, b, remat=True)
        return ref_ts.softmax_xent(logits, b["labels"], cfg.vocab_size)

    _, g_ref = jax.jit(jax.value_and_grad(ref_loss))(
        jax.tree.map(jnp.asarray, _weights(cfg)),
        jax.tree.map(jnp.asarray, batch))
    m_r, m_p, want, got, grads, lr_scales = _run_steps(arch, 1, monkeypatch)
    _check_metrics(m_r, m_p)
    _check_grads(grads[0], _paths(g_ref), f"{arch} gradients")
    _check_params(want, got, grads, lr_scales)


def test_chunked_xent_over_several_chunks_matches_reference():
    """``chunked_xent`` with 4 chunks against the reference's (loss and
    the gradients of the hidden states and the table)."""
    arch = "olmoe-1b-7b"
    cfg, pcfg = ref_config(arch).reduced(), port_config(arch).reduced()
    tree = _weights(cfg)
    rng = np.random.default_rng(3)
    hidden = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=(2, 32)).astype(np.int32)
    from repro.models.sharding_ctx import NO_SHARDING

    def ref_loss(p, h):
        return ref_ts.chunked_xent(cfg, p, h, jnp.asarray(labels),
                                   NO_SHARDING, chunk=8)

    loss_r, (g_p, g_h) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(hidden))
    model = interop.params_from_numpy(pcfg, tree, masters=True)
    h = torch.from_numpy(hidden).requires_grad_()
    loss = train_step.chunked_xent(model, h, torch.from_numpy(labels),
                                   chunk=8)
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_r)) <= \
        4 * EPS32 * float(loss_r)
    _check_grads({"h": h.grad.numpy(),
                  "table": model.lm_head.kernel.grad.numpy()},
                 {"h": np.asarray(g_h),
                  "table": np.asarray(g_p["lm_head"]["kernel"])},
                 "chunked_xent")


def test_grouped_launch_plan_counts():
    cfg = port_config("olmoe-1b-7b").reduced()
    model = port_model.LM(cfg, device="meta", masters=True)
    assert model.grouped_launches_per_step() == 2 * cfg.num_layers
    assert model.grouped_launches_per_step(train=True) == 6 * cfg.num_layers
    assert model.grouped_launches_per_step(train=True, remat=False) == \
        4 * cfg.num_layers
    dense = port_model.LM(port_config("llama3.2-1b").reduced(),
                          device="meta")
    assert dense.grouped_launches_per_step(train=True) == 0


def test_mesh_is_not_ported():
    # The partitioned step runs every arch on a ProcessMesh
    # (tests/test_torch_gspmd_train*.py): on recurrentgemma-9b it is made
    # with the policy's specs; a mesh that is not a ProcessMesh is refused.
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.mesh import ProcessMesh
    cfg = port_config("recurrentgemma-9b").reduced()
    shape = PortShape("t", 8, 2, "train")
    mesh = ProcessMesh(axis_names=("data", "model"),
                       shape={"data": 2, "model": 2},
                       coords={"data": 0, "model": 1}, rank=1,
                       device=torch.device("cpu"), backend="gloo",
                       groups={}, group_ranks={}, log=None)
    step, specs = train_step.make_train_step(cfg, shape, mesh)
    named = dict(port_model.LM(cfg, device="meta",
                               masters=True).named_parameters())
    assert callable(step)
    assert specs["params"] == SH.param_pspecs(cfg, named, mesh)
    assert specs["params"]["layers.0.rglru.w_r"] == ("model", None, None)
    assert specs["batch"] == {"tokens": ("data", None),
                              "labels": ("data", None)}
    for arch in ("recurrentgemma-9b", "llama3.2-1b"):
        with pytest.raises(TypeError, match="ProcessMesh"):
            train_step.make_train_step(port_config(arch).reduced(), shape,
                                       mesh=object())
