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
  train and prefill steps of every arch made over a mesh with the
  reference's batch specs (a mesh that is not a ``ProcessMesh`` refused),
  ``local_block`` / ``local_shape``.
* The serve step over a mesh, in the same world: the distributed softmax
  (``attention.decode_attention_partial`` and ``combine``) over two and
  four blocks of a cache of which one block has no valid slot, against
  one-process ``decode_attention`` within ``RTOL`` of the largest output
  (no NaN), and a combine without the ``e^{m - m*}`` rescale rejected;
  ``launch.sharding.slot_owner`` across both block boundaries and the
  ring's wrap; reduced llama3.2-1b and falcon-mamba-7b decoding 12 steps
  against one process within ``RTOL32`` (logits and the mamba state's
  channel blocks), with two planted faults rejected: the new K/V written
  on every rank, not only the slot's owner, and mamba's ``u`` and ``z``
  taken from the contiguous ``in_proj`` block; the interop cache round
  trip, reference -> port -> reference, exact for every family.
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

from _gspmd_ranks import (COMBINE_AXES, SERVE_FAULTS, UNIT_FAULTS,
                          combine_inputs, units_rank)
from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config, list_archs
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.launch.spawn import run_world
from repro_torch.models import model as port_model
from repro_torch.models.sharding_ctx import ShardingCtx, step_dims
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-5
RTOL32 = 1e-4
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


def test_constrain_checks_a_decode_cache_block():
    # The serve step's context: one token per row, the cache's sequence
    # over "model" (B 4 on (2, 2)), or over ("data", "model") at B 1.
    cfg = get_config("gemma3-12b").reduced()
    mesh = _fake_mesh({"data": 2, "model": 2}, {"data": 0, "model": 1})
    ctx = TS.make_ctx(cfg, mesh, ShapeConfig("d", 32, 4, "decode"))
    assert ctx.dims["s"] == 1 and ctx.dims["c"] == 32
    hd, kv = cfg.head_dim, cfg.num_kv_heads
    block = torch.zeros(2, 16, kv, hd)
    assert ctx.constrain(block, "kv_cache", (4, 32, kv, hd)) is block
    ring = torch.zeros(2, 4, kv, hd)             # an 8-slot ring's block
    assert ctx.constrain(ring, "kv_cache", (4, 8, kv, hd)) is ring
    with pytest.raises(RuntimeError, match="kv_cache"):
        ctx.constrain(torch.zeros(2, 32, kv, hd), "kv_cache",
                      (4, 32, kv, hd))
    with pytest.raises(RuntimeError, match="tokens_bse"):
        ctx.constrain(torch.zeros(4, 1, cfg.d_model), "tokens_bse")
    one = TS.make_ctx(cfg, mesh, ShapeConfig("d", 32, 1, "decode"))
    assert one.rules["kv_cache"][1] == ("data", "model")
    assert one.parts("kv_cache", 1, (1, 32, kv, hd)) == 4
    assert one.parts("kv_cache", 1, (1, 6, kv, hd)) == 1


@pytest.mark.parametrize("arch", list_archs())
def test_the_mesh_runs_the_global_archs_and_refuses_the_rest(arch):
    # Every arch's train and prefill steps are made over a mesh, with the
    # reference's batch specs (the modality keys among them) and the
    # policy's parameter and logits specs; only a mesh that is not a
    # ProcessMesh is refused.
    from repro.configs.base import ShapeConfig as RefShape
    from repro.configs.base import get_config as ref_config
    from repro.launch import sharding as ref_sharding
    from repro_torch.launch.mesh import abstract_mesh
    cfg = get_config(arch).reduced()
    port_model.check_mesh_supported(cfg)
    mesh = _fake_mesh({"data": 2, "model": 2}, {"data": 0, "model": 0})
    named = dict(port_model.LM(cfg, device="meta",
                               masters=True).named_parameters())
    for kind, make in (("train", TS.make_train_step),
                       ("prefill", TS.make_prefill_step)):
        shape = ShapeConfig("t", 16, 4, kind)
        fn, specs = make(cfg, shape, mesh)
        assert callable(fn)
        assert specs["params"] == SH.param_pspecs(cfg, named, mesh)
        want = ref_sharding.batch_pspecs(
            ref_config(arch).reduced(),
            abstract_mesh((2, 2), ("data", "model")),
            RefShape("t", 16, 4, kind))
        assert specs["batch"] == {k: tuple(v) for k, v in want.items()}
        if kind == "prefill":
            assert specs["logits"] == ("data", None, "model")
        with pytest.raises(TypeError, match="ProcessMesh"):
            make(cfg, shape, object())


def test_serve_step_over_a_mesh_names_part_three():
    # Part 3 brought the serve step over a mesh: it is made for every arch
    # with the reference's specs.
    mesh = _fake_mesh({"data": 2, "model": 2}, {"data": 0, "model": 0})
    for arch in list_archs():
        cfg = get_config(arch).reduced()
        fn, specs = TS.make_serve_step(cfg, ShapeConfig("d", 16, 4,
                                                        "decode"), mesh)
        assert callable(fn) and specs["logits"] == ("data", "model")
        first = specs["cache"][0]
        if "k" in first:
            assert first["k"] == ("data", "model", None, None)
        else:
            assert first["conv"] == ("data", None, "model")
    _, one = TS.make_serve_step(get_config("llama3.2-1b").reduced(),
                                ShapeConfig("d", 16, 1, "decode"), mesh)
    assert one["cache"][0]["k"] == (None, ("data", "model"), None, None)
    assert one["logits"] == (None, "model")
    with pytest.raises(ValueError, match="decode shape"):
        TS.make_serve_step(get_config("llama3.2-1b").reduced(),
                           ShapeConfig("t", 16, 4, "train"), mesh)


# --------------------------------------------------------------------- #
# The serve step over a mesh.
# --------------------------------------------------------------------- #

def _combine_errors(world, key=None):
    """Worst |combined - one process| over the largest |output|, per
    sequence axes, and whether every output is finite."""
    from repro_torch.models.attention import decode_attention
    q, k, v, mask = combine_inputs()
    want = decode_attention(q, k, v, mask).numpy()
    out = {}
    for axes in COMBINE_AXES:
        got = [r["faults"]["no rescale"][axes] if key else r["combine"][axes]
               for r in world]
        out[axes] = (max(float(np.abs(g - want).max()) for g in got)
                     / float(np.abs(want).max()),
                     all(np.isfinite(g).all() for g in got))
    return out


@pytest.mark.parametrize("axes", COMBINE_AXES, ids="x".join)
def test_combine_matches_one_process_with_an_empty_block(world, axes):
    err, finite = _combine_errors(world)[axes]
    assert finite and err <= RTOL, err


@pytest.mark.parametrize("axes", COMBINE_AXES, ids="x".join)
def test_combine_without_the_rescale_is_rejected(world, axes):
    err, _ = _combine_errors(world, "no rescale")[axes]
    assert err > RTOL, err


def test_slot_owner_across_the_block_boundaries_and_the_ring_wrap():
    mesh = _fake_mesh({"data": 2, "model": 2}, {"data": 1, "model": 0})
    seq = ("data", "model")
    # 16 slots over four blocks of 4: both boundaries of block 1.
    assert [SH.slot_owner(s, 16, seq, mesh) for s in (3, 4, 7, 8, 15)] == \
        [(0, 3), (1, 0), (1, 3), (2, 0), (3, 3)]
    assert SH.slot_owner(5, 16, "model", mesh) == (0, 5)
    assert SH.slot_owner(9, 16, "model", mesh) == (1, 1)
    assert SH.slot_owner(6, 16, None, mesh) == (0, 6)
    assert SH.axes_index(mesh, seq) == 2 and \
        SH.axes_index(mesh, ("model",)) == 0
    # An 8-slot ring over "model": pos 7 ends block 1, pos 8 wraps to 0.
    ring = [SH.slot_owner(port_model.cache_slot("local", p, 8), 8, "model",
                          mesh) for p in (3, 4, 7, 8, 12)]
    assert ring == [(0, 3), (1, 0), (1, 3), (0, 0), (1, 0)]
    # A global layer's last slot keeps taking the tokens past the cache.
    assert SH.slot_owner(port_model.cache_slot("global", 40, 16), 16, seq,
                         mesh) == (3, 3)
    with pytest.raises(ValueError, match="does not split"):
        SH.slot_owner(0, 10, seq, mesh)


@pytest.mark.parametrize("arch", sorted(SERVE_FAULTS.values()))
def test_partitioned_decode_matches_one_process(world, arch):
    for r in world:
        got = r["serve"][arch]
        assert got["logits"] <= RTOL32 and got["state"] <= RTOL32, got


@pytest.mark.parametrize("fault", sorted(SERVE_FAULTS))
def test_planted_serve_faults_are_rejected(world, fault):
    worst = max(r["faults"][fault]["logits"] for r in world)
    assert worst > RTOL32, (fault, worst)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma3-12b",
                                  "whisper-base", "falcon-mamba-7b",
                                  "recurrentgemma-9b"])
def test_cache_round_trip_reference_port_reference(arch):
    import jax
    import jax.numpy as jnp
    from repro.configs.base import get_config as ref_config
    from repro.models import model as ref_model
    from repro_torch import interop
    rcfg = ref_config(arch).reduced()
    cache = ref_model.init_cache(rcfg, 2, 8)
    rng = np.random.default_rng(0)
    cache = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape), a.dtype), cache)
    tree = jax.tree.map(np.asarray, cache)
    port = interop.cache_from_numpy(get_config(arch).reduced(), tree)
    model = port_model.LM(get_config(arch).reduced(), device="meta")
    assert [{n: (tuple(t.shape), t.dtype) for n, t in layer.items()}
            for layer in port] == [
        {n: (s, d) for n, (s, d) in layer.items()}
        for layer in model.cache_shapes(2, 8)]
    back = interop.cache_to_numpy(model, port)
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert flat_back.keys() == flat_ref.keys()
    for k, want in flat_ref.items():
        assert np.array_equal(flat_back[k], np.asarray(want, np.float32)), k


def test_import_guard_lists_the_serve_modules():
    text = (ROOT / "tests" / "test_torch_formats.py").read_text()
    for mod in ("repro_torch.models.model", "repro_torch.models.ssm",
                "repro_torch.models.rglru", "repro_torch.models.attention",
                "repro_torch.train.train_step", "repro_torch.interop",
                "repro_torch.launch.sharding", "repro_torch.core.device"):
        assert mod in text, mod
