"""Shared inputs, runs and bounds of ``tests/test_torch_train.py`` and
``tests/test_torch_train_steps.py``: the port's training path against the
reference's, on the CPU at fp32 (the grouped matmul's autograd, the MoE
layer's gradient, whole train steps against
``repro.train.train_step.make_train_step(..., mesh=None)``).

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

from repro.configs.base import ShapeConfig as RefShape
from repro.configs.base import get_config as ref_config
from repro.models import model as ref_model
from repro.optim import adamw as ref_adamw
from repro.train import train_step as ref_ts
from repro_torch import interop
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ShapeConfig as PortShape
from repro_torch.models import model as port_model
from repro_torch.models import moe as port_moe
from repro_torch.optim import adamw
from repro_torch.train import train_step

ARCHS = ("llama3.2-1b", "gemma-2b", "qwen2-72b", "olmoe-1b-7b",
         "qwen3-moe-235b-a22b")
BATCH, SEQ = 4, 32
LR = 3e-4
SCHEDULE = {"warmup_steps": 2, "total_steps": 10}
EPS32 = float(np.finfo(np.float32).eps)
GRAD_RTOL = 1e-5
RESOLVED = 100
MAX_UNRESOLVED = 0.20


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread for a test module, restored after: the suite
    runs several pytest workers at once, and torch's default of a thread
    per core then oversubscribes the cores (a tiny model's trainer test
    took 29 s instead of 0.5 s beside five busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def use_fp32(monkeypatch) -> None:
    """Both packages' compute dtype set to fp32 for one test."""
    monkeypatch.setattr(ref_model, "COMPUTE_DTYPE", jnp.float32)
    monkeypatch.setattr(port_model, "COMPUTE_DTYPE", torch.float32)


class PortRoutes:
    """Records each call of the port's router: its logits (fp32)."""

    def __init__(self, monkeypatch):
        self.logits = []
        orig = port_moe.router

        def recording(x, kernel, k):
            self.logits.append((x.float() @ kernel.float()).detach().numpy())
            return orig(x, kernel, k)
        monkeypatch.setattr(port_moe, "router", recording)

    def check(self, k: int):
        """Every token's top-k margin clears the routers' agreement."""
        for i, z in enumerate(self.logits):
            zs = -np.sort(-z, axis=-1)
            margin = zs[:, k - 1] - zs[:, k]
            bound = 2 * GRAD_RTOL * np.abs(z).max(axis=-1)
            assert np.all(margin > bound), \
                f"router call {i}: a routing near-tie (margin " \
                f"{margin.min():.3e}) could flip an expert between packages"


def _weights(cfg) -> dict:
    """The reference's ``init_params``, each norm scale and bias moved off
    its init (zeros, or a LayerNorm scale's ones) by ``N(0, 0.1**2)`` /
    ``N(0, 0.02**2)``."""
    tree = jax.tree.map(np.asarray,
                        ref_model.init_params(cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)

    def redraw(node):
        for key, value in node.items():
            if isinstance(value, dict):
                redraw(value)
            elif key in ("scale", "bias"):
                std = 0.1 if key == "scale" else 0.02
                node[key] = value + rng.normal(size=value.shape).astype(
                    np.float32) * std
    redraw(tree)
    return tree


def _batch(cfg, batch=BATCH, seq=SEQ, seed=0) -> dict:
    seqs = np.random.default_rng(seed).integers(
        2, cfg.vocab_size - 1, size=(batch, seq + 1)).astype(np.int32)
    return {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def _paths(tree) -> dict:
    return {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _check_grads(got: dict, want: dict, what: str,
                 rtol: float = GRAD_RTOL) -> None:
    assert set(got) == set(want), what
    for k in want:
        g, r = got[k], want[k]
        assert g.shape == r.shape and np.isfinite(g).all(), f"{what} {k}"
        bound = rtol * max(float(np.abs(r).max()), 1e-30)
        worst = float(np.abs(g - r).max())
        assert worst <= bound, f"{what} {k}: {worst:.3e} > {bound:.3e}"


#: (arch, remat, grad_accum, chunked) -> the reference's jitted step.
_REF_STEPS: dict = {}


def _ref_step(arch, remat=True, grad_accum=1, chunked=False):
    key = (arch, remat, grad_accum, chunked)
    if key not in _REF_STEPS:
        cfg = ref_config(arch).reduced()
        _REF_STEPS[key], _ = ref_ts.make_train_step(
            cfg, RefShape("t", SEQ, BATCH, "train"),
            opt_cfg=ref_adamw.AdamWConfig(lr=LR), remat=remat,
            grad_accum=grad_accum, chunked_loss=chunked,
            schedule_kwargs=SCHEDULE)
    return _REF_STEPS[key]


def _run_steps(arch, steps, monkeypatch, remat=True, grad_accum=1,
               chunked=False, make_batch=_batch):
    """``steps`` train steps of both packages from the same weights and
    batches (``make_batch(cfg, seed=step)``; steps 1, 2, ... of the
    schedule).  Returns the reference's and
    the port's metrics, final weights (the reference's tree layout), the
    port's gradient at every step, and the lr scales."""
    routes = PortRoutes(monkeypatch)
    cfg = ref_config(arch).reduced()
    pcfg = port_config(arch).reduced()
    tree = _weights(cfg)
    step_r = _ref_step(arch, remat, grad_accum, chunked)
    params = jax.tree.map(jnp.asarray, tree)
    opt = ref_adamw.init_state(params, ref_adamw.AdamWConfig(lr=LR))
    model = interop.params_from_numpy(pcfg, tree, masters=True)
    step_p = train_step.make_train_step(
        pcfg, PortShape("t", SEQ, BATCH, "train"),
        opt_cfg=adamw.AdamWConfig(lr=LR), remat=remat,
        grad_accum=grad_accum, chunked_loss=chunked,
        schedule_kwargs=SCHEDULE)
    opt_p = adamw.init_state(dict(model.named_parameters()),
                             adamw.AdamWConfig(lr=LR))
    grads = []
    apply = adamw.apply_updates

    def recording(params, g, state, cfg, lr_scale=1.0):
        grads.append(_paths(interop.tree_to_numpy(pcfg, g)))
        return apply(params, g, state, cfg, lr_scale)
    monkeypatch.setattr(adamw, "apply_updates", recording)
    m_r, m_p = [], []
    for s in range(steps):
        batch = make_batch(cfg, seed=s)
        params, opt, m = step_r(params, opt, jax.tree.map(jnp.asarray, batch),
                                jnp.int32(s + 1))
        m_r.append({k: float(v) for k, v in m.items()})
        m = step_p(model, opt_p, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, s + 1)
        m_p.append({k: float(v) for k, v in m.items()})
    routes.check(pcfg.num_experts_per_token or 1) if pcfg.num_experts \
        else None
    assert int(opt_p["count"]) == int(opt["count"]) == steps
    return (m_r, m_p, _paths(params), _paths(interop.params_to_numpy(model)),
            grads, [m["lr_scale"] for m in m_r])


def _check_metrics(m_r, m_p):
    for r, p in zip(m_r, m_p):
        assert abs(p["loss"] - r["loss"]) <= 4 * EPS32 * abs(r["loss"])
        assert abs(p["grad_norm"] - r["grad_norm"]) <= \
            GRAD_RTOL * r["grad_norm"]
        assert abs(p["lr_scale"] - r["lr_scale"]) <= 4 * EPS32


def _check_params(want: dict, got: dict, grads: list, lr_scales) -> float:
    """The element rule (module docstring); returns the unresolved
    share."""
    counts = _check_elements(want, got, grads, lr_scales)
    total = sum(t for t, _ in counts.values())
    share = sum(u for _, u in counts.values()) / total
    assert share <= MAX_UNRESOLVED, f"unresolved share {share:.3f}"
    return share


def _check_elements(want: dict, got: dict, grads: list, lr_scales) -> dict:
    """The element rule's bound on every compared element; returns
    ``{leaf: (elements, unresolved elements)}``."""
    assert set(got) == set(want)
    counts = {}
    moved = LR * sum(lr_scales)
    for k in want:
        resolved = np.ones(want[k].shape, dtype=bool)
        zero = np.ones(want[k].shape, dtype=bool)
        for g in grads:
            bound = GRAD_RTOL * np.abs(g[k]).max()
            resolved &= np.abs(g[k]) >= RESOLVED * bound
            zero &= g[k] == 0
        compared = resolved | zero
        counts[k] = (compared.size, int((~compared).sum()))
        allowed = 4 / RESOLVED * moved + 8 * EPS32 * np.abs(want[k])
        excess = (np.abs(got[k] - want[k]) - allowed)[compared]
        assert excess.size == 0 or excess.max() <= 0, \
            f"{k}: exceeds the bound by {excess.max():.3e}"
    return counts
