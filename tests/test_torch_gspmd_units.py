"""Units of the partitioned steps.

* The vocab-parallel loss (``train_step._token_losses`` over ``"model"``)
  and the sharded ``optim.adamw.global_norm``, in one world of four gloo
  CPU ranks on ``(data=2, model=2)``, against their unsharded versions on
  the whole arrays: the losses within ``RTOL`` of their largest value,
  each rank's gradient block of the logits within ``RTOL`` of the whole
  gradient's largest, the norm within ``RTOL`` relative.  Two planted
  faults must break these bounds: the ``psum`` over ``"model"`` left out
  of the loss, and a replicated leaf counted twice in the norm.
* ``launch.sharding.batch_rows`` / ``batch_shard`` against the layout
  the reference's step gives each device: its ``batch_pspecs`` batch,
  reshaped into micro-batches as its ``make_train_step`` does and
  constrained as ``"tokens_bse"`` (one subprocess on four host devices).
* The shape check of ``ShardingCtx.constrain`` in a partitioned step, the
  refusals (``make_serve_step`` over a mesh, the families outside the
  global-attention ``dense`` / ``moe`` archs), ``local_block`` /
  ``local_shape``.
"""
from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _gspmd_ranks import UNIT_FAULTS, units_rank
from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.device import MULTI_CARD
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.launch.spawn import run_world
from repro_torch.models import model as port_model
from repro_torch.models.sharding_ctx import ShardingCtx, step_dims
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-5
VOCAB, V_PAD, B, S = 60, 64, 4, 8
GLOBAL_ARCHS = ("llama3.2-1b", "gemma-2b", "qwen2-72b", "olmoe-1b-7b",
                "qwen3-moe-235b-a22b")


def _fake_mesh(shape: dict, coords: dict) -> ProcessMesh:
    return ProcessMesh(axis_names=tuple(shape), shape=dict(shape),
                       coords=dict(coords), rank=0,
                       device=torch.device("cpu"), backend="gloo",
                       groups={}, group_ranks={}, log=None)


def _inputs():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((B, S, V_PAD)) * 3).astype(np.float32)
    labels = rng.integers(0, VOCAB, size=(B, S)).astype(np.int64)
    grads = {"kernel": rng.standard_normal((8, 6)).astype(np.float32),
             "bias": rng.standard_normal(5).astype(np.float32),
             "heads": rng.standard_normal(6).astype(np.float32)}
    specs = {"kernel": ("data", "model"), "bias": (None,),
             "heads": ("model",)}
    return logits, labels, grads, specs


@pytest.fixture(scope="module")
def world():
    logits, labels, grads, specs = _inputs()
    return run_world(units_rank, 4, logits, labels, VOCAB, grads, specs,
                     threads=1, timeout=300)


def _whole_loss():
    logits, labels, _, _ = _inputs()
    x = torch.from_numpy(logits).requires_grad_()
    losses = TS._token_losses(x, torch.from_numpy(labels), VOCAB)
    losses.mean().backward()
    return losses.detach().numpy(), x.grad.numpy()


def _xent_errors(results, key=None):
    want_l, want_g = _whole_loss()
    err_l = err_g = 0.0
    for r in results:
        got = r["faults"][key] if key else r["xent"]
        di, mi = r["coords"]["data"], r["coords"]["model"]
        rows = slice(di * B // 2, (di + 1) * B // 2)
        cols = slice(mi * V_PAD // 2, (mi + 1) * V_PAD // 2)
        err_l = max(err_l, float(np.abs(got["losses"] - want_l[rows]).max())
                    / float(np.abs(want_l).max()))
        err_g = max(err_g, float(np.abs(got["grad"] - want_g[rows, :, cols])
                                 .max()) / float(np.abs(want_g).max()))
    return err_l, err_g


def test_vocab_parallel_loss_matches_the_whole_one(world):
    err_l, err_g = _xent_errors(world)
    assert err_l <= RTOL and err_g <= RTOL, (err_l, err_g)


def test_loss_without_its_psum_is_rejected(world):
    err_l, _ = _xent_errors(world, "no psum")
    assert err_l > RTOL, err_l


def _whole_norm() -> float:
    _, _, grads, _ = _inputs()
    return float(adamw.global_norm([torch.from_numpy(v)
                                    for v in grads.values()]))


def test_sharded_norm_matches_the_whole_one(world):
    want = _whole_norm()
    for r in world:
        assert abs(r["norm"] - want) <= RTOL * want


def test_norm_counting_a_replicated_leaf_twice_is_rejected(world):
    want = _whole_norm()
    assert UNIT_FAULTS == ("no psum", "replicated counted twice")
    for r in world:
        assert abs(r["faults"]["replicated counted twice"] - want) > \
            RTOL * want


_LAYOUT_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding
from repro.configs.base import ShapeConfig, get_config
from repro.launch import sharding as SH
from repro.train.train_step import make_ctx

cfg = get_config("llama3.2-1b").reduced()
out = {}
for shape, axes, batch, accum in json.loads(sys.argv[1]):
    mesh = jax.make_mesh(tuple(shape), tuple(axes),
                         axis_types=(AxisType.Auto,) * len(axes))
    sh = ShapeConfig("t", 4, batch, "train")
    ctx = make_ctx(cfg, mesh, sh)
    rows = jnp.broadcast_to(jnp.arange(batch)[:, None], (batch, 4))
    rows = jax.device_put(rows, NamedSharding(
        mesh, SH.batch_pspecs(cfg, mesh, sh)["tokens"]))

    @jax.jit
    def micro(x):
        # As the reference's grads_for: [B, S] -> [a, B / a, S], then each
        # micro-batch's tokens reach the model as "tokens_bse".
        mb = x.reshape((accum, batch // accum) + x.shape[1:])
        return [ctx.constrain(mb[i][..., None] * jnp.ones(cfg.d_model,
                                                            jnp.int32),
                              "tokens_bse") for i in range(accum)]

    per = {}
    for i, arr in enumerate(micro(rows)):
        for s in arr.addressable_shards:
            pos = [int(p) for p in np.argwhere(mesh.devices == s.device)[0]]
            key = ",".join(map(str, pos))
            per.setdefault(key, []).append(
                sorted(set(np.asarray(s.data)[:, 0, 0].tolist())))
    out[f"{shape}/{batch}/{accum}"] = per
print(json.dumps(out))
"""

LAYOUTS = [((2, 2), ("data", "model"), 8, 2), ((4, 1), ("data", "model"),
                                                 8, 2),
           ((2, 1, 2), ("pod", "data", "model"), 8, 2),
           ((2, 2), ("data", "model"), 4, 1)]


@pytest.fixture(scope="module")
def reference_layouts(tmp_path_factory):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "HOME": str(tmp_path_factory.mktemp("h")),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}
    r = subprocess.run([sys.executable, "-c", _LAYOUT_SCRIPT,
                        json.dumps(LAYOUTS)], capture_output=True, text=True,
                       env=env, timeout=300, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: f"{l[0]}-{l[3]}")
def test_batch_rows_are_the_reference_micro_batch_layout(reference_layouts,
                                                         layout):
    shape, axes, batch, accum = layout
    per = reference_layouts[f"{list(shape)}/{batch}/{accum}"]
    cfg = get_config("llama3.2-1b").reduced()
    sh = ShapeConfig("t", 4, batch, "train")
    tokens = np.repeat(np.arange(batch)[:, None], 4, axis=1)
    for pos in np.ndindex(*shape):
        mesh = _fake_mesh(dict(zip(axes, shape)), dict(zip(axes, pos)))
        local = SH.batch_shard({"tokens": tokens, "labels": tokens}, cfg,
                               mesh, sh, accum)["tokens"][:, 0]
        mine = [sorted(m.tolist()) for m in local.reshape(accum, -1)]
        assert mine == per[",".join(map(str, pos))], (pos, mine)


def test_batch_rows_refuse_an_uneven_split():
    with pytest.raises(ValueError, match="does not split"):
        SH.batch_rows(6, 2, 0, 2)
    assert SH.batch_rows(8, 2, 1, 2).tolist() == [2, 3, 6, 7]


def test_local_blocks_follow_the_spec():
    mesh = _fake_mesh({"data": 2, "model": 2}, {"data": 1, "model": 0})
    x = torch.arange(32.0).reshape(4, 8)
    assert SH.local_shape(("data", "model"), (4, 8), mesh) == (2, 4)
    assert torch.equal(SH.local_block(x, ("data", "model"), mesh),
                       x[2:4, 0:4])
    assert torch.equal(SH.local_block(x, (None, "model"), mesh), x[:, :4])
    assert SH.replicated_axes(("data", None), mesh) == ("model",)


def test_constrain_checks_the_local_layout():
    cfg = get_config("llama3.2-1b").reduced()
    mesh = _fake_mesh({"data": 2, "model": 2}, {"data": 0, "model": 0})
    shape = ShapeConfig("t", 16, 4, "train")
    ctx = ShardingCtx(SH.activation_rules(cfg, mesh, shape), mesh,
                      dims=step_dims(cfg, 4, 16))
    assert ctx.process_mesh is mesh
    x = torch.zeros(2, 8, cfg.d_model)
    assert ctx.constrain(x, "tokens_bse") is x
    with pytest.raises(RuntimeError, match="tokens_bse"):
        ctx.constrain(torch.zeros(2, 16, cfg.d_model), "tokens_bse")
    assert ctx.parts("tokens_bse", 1) == 2 and ctx.parts("ffn_bsf", 2) == 2
    odd = ShardingCtx(ctx.rules, mesh, dims=step_dims(cfg, 4, 15))
    assert odd.parts("tokens_bse", 1) == 1
    assert ShardingCtx(ctx.rules, mesh).process_mesh is None


@pytest.mark.parametrize("arch", list_archs())
def test_the_mesh_runs_the_global_archs_and_refuses_the_rest(arch):
    cfg = get_config(arch).reduced()
    if arch in GLOBAL_ARCHS:
        port_model.check_mesh_supported(cfg)
        return
    with pytest.raises(NotImplementedError, match="part 3"):
        port_model.check_mesh_supported(cfg)
    mesh = _fake_mesh({"data": 2, "model": 2}, {"data": 0, "model": 0})
    shape = ShapeConfig("t", 16, 4, "train")
    for make in (TS.make_train_step, TS.make_prefill_step):
        with pytest.raises(NotImplementedError, match="part 3"):
            make(cfg, shape, mesh)


def test_serve_step_over_a_mesh_names_part_three():
    cfg = get_config("llama3.2-1b").reduced()
    mesh = _fake_mesh({"data": 2, "model": 2}, {"data": 0, "model": 0})
    with pytest.raises(NotImplementedError, match="part 3"):
        TS.make_serve_step(cfg, ShapeConfig("d", 16, 4, "decode"), mesh)
    assert "part 3" in MULTI_CARD
