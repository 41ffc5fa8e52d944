"""The port's data pipeline, checkpointer and trainer against the
reference's, on the CPU.

* Pipeline (``repro_torch.data.pipeline``): numpy on both sides, so every
  batch must equal the reference's byte for byte, for the synthetic and
  the memmap sources and the vlm / encdec stubs, over several steps.
* Checkpointer (``repro_torch.checkpoint``): the reference's own tests
  (``tests/test_checkpoint.py``) re-run against the port; a directory
  either package writes restores through the other to equal arrays; a
  bf16 leaf's ``.npy`` is byte-identical between the two.
* Trainer (``repro_torch.train.trainer``): the reference's
  ``tests/test_trainer.py`` cases, ported (loss decreases, restart resumes
  without replay, restart equivalence, the straggler watchdog).  On the
  CPU restart equivalence is exact: every weight and AdamW state leaf
  equal bit for bit.  And the launcher
  (``python -m repro_torch.launch.train --reduced --device cpu``).
"""
from __future__ import annotations

import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro.configs.base import ShapeConfig as RefShape
from repro.configs.base import get_config as ref_config
from repro.data.pipeline import DataConfig as RefData
from repro.data.pipeline import Pipeline as RefPipeline
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config as port_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.tree import leaves
from repro_torch.data.pipeline import DataConfig, Pipeline
from repro_torch.launch import train as train_cli
from repro_torch.train.trainer import Trainer, TrainerConfig

SHAPE = (16, 4)                 # seq_len, global_batch
SMALL_SHAPE = ShapeConfig("tiny", seq_len=32, global_batch=4, kind="train")


# ---------------------------------------------------------------------- #
# Pipeline.
# ---------------------------------------------------------------------- #

def _pipelines(arch, data_kw):
    seq, batch = SHAPE
    return (RefPipeline(ref_config(arch).reduced(),
                        RefShape("t", seq, batch, "train"),
                        RefData(**data_kw)),
            Pipeline(port_config(arch).reduced(),
                     ShapeConfig("t", seq, batch, "train"),
                     DataConfig(**data_kw)))


def _assert_same_batch(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype and \
            got[k].shape == want[k].shape, f"{what} {k}"
        assert got[k].tobytes() == want[k].tobytes(), f"{what} {k}"


@pytest.mark.parametrize("arch,seed", [("llama3.2-1b", 0),
                                       ("olmoe-1b-7b", 3),
                                       ("qwen2-vl-7b", 1),
                                       ("whisper-base", 2)])
def test_batches_equal_the_reference_byte_for_byte(arch, seed):
    """Synthetic source; vlm adds ``mm_embeds`` and M-RoPE positions,
    encdec the audio frames."""
    ref, port = _pipelines(arch, {"seed": seed})
    for step in (0, 1, 2, 7, 1000):
        _assert_same_batch(port.batch_for_step(step),
                           ref.batch_for_step(step), f"{arch} step {step}")


@pytest.mark.parametrize("token_dtype", ["uint16", "uint32"])
def test_memmap_batches_equal_the_reference(tmp_path, token_dtype):
    path = tmp_path / "tokens.bin"
    vocab = port_config("llama3.2-1b").reduced().vocab_size
    (np.random.default_rng(9).integers(0, vocab, size=20000)
     .astype(token_dtype)).tofile(path)
    kw = {"seed": 4, "path": str(path), "token_dtype": token_dtype}
    ref, port = _pipelines("llama3.2-1b", kw)
    for step in (0, 1, 5):
        _assert_same_batch(port.batch_for_step(step),
                           ref.batch_for_step(step), f"memmap step {step}")


def test_labels_are_shifted_tokens():
    _, p = _pipelines("llama3.2-1b", {"seed": 0})
    b = p.batch_for_step(0)
    assert b["tokens"].shape == b["labels"].shape == (4, 16)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].max() < p.cfg.vocab_size


# ---------------------------------------------------------------------- #
# Checkpointer: the reference's tests, run against the port.
# ---------------------------------------------------------------------- #

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": torch.from_numpy(
                           rng.normal(size=(4, 4)).astype(np.float32)),
                       "b": torch.from_numpy(
                           rng.normal(size=4).astype(np.float32))},
            "opt": {"count": torch.tensor(7, dtype=torch.int32)}}


def test_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path))
    tree = _tree()
    ck.save(3, tree)
    out = ck.restore()
    assert torch.equal(out["params"]["w"], tree["params"]["w"])
    assert int(out["opt"]["count"]) == 7 and out["opt"]["count"].shape == ()
    assert ck.latest_step() == 3


def test_atomicity_ignores_uncommitted(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _tree(1))
    d = ck._dir(2)
    shutil.copytree(ck._dir(1), d)
    os.remove(os.path.join(d, "COMMITTED"))
    assert ck.latest_step() == 1
    shutil.copytree(ck._dir(1), ck._dir(3) + ".tmp")
    assert ck.latest_step() == 1


def test_retention_gc(tmp_path):
    ck = Checkpointer(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        ck.save(s, _tree(s))
    assert ck.committed_steps() == [3, 4]


def test_restore_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path)).restore()


def test_restore_validates_structure(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"params": {"w": torch.ones(2)}})
    with pytest.raises(ValueError):
        ck.restore(like={"params": {"w": torch.ones(2),
                                    "missing": torch.ones(2)}})


def test_manifest_contents(tmp_path):
    path = Checkpointer(str(tmp_path)).save(5, _tree())
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    assert manifest["step"] == 5
    assert manifest["arrays"]["params/w"]["shape"] == [4, 4]
    assert os.path.basename(path) == "step_000000005"


# ---------------------------------------------------------------------- #
# Checkpoints across the two packages.
# ---------------------------------------------------------------------- #

def _mixed(seed=0):
    """A tree of fp32, bf16 and int32 leaves as numpy (bf16 as fp32 values
    that bf16 holds exactly)."""
    rng = np.random.default_rng(seed)
    bf = np.array(jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16)
                  .astype(jnp.float32))
    return {"params": {"layers.0.w": rng.normal(size=(4, 3)).astype(
                np.float32)},
            "opt": {"mu": {"layers.0.w": bf}, "count": np.int32(2)}}


def test_port_checkpoint_restores_through_the_reference(tmp_path):
    tree = _mixed()
    port_tree = {"params": {"layers.0.w": torch.from_numpy(
                     tree["params"]["layers.0.w"])},
                 "opt": {"mu": {"layers.0.w": torch.from_numpy(
                     tree["opt"]["mu"]["layers.0.w"]).to(torch.bfloat16)},
                     "count": torch.tensor(2, dtype=torch.int32)}}
    Checkpointer(str(tmp_path)).save(4, port_tree)
    out = RefCheckpointer(str(tmp_path)).restore()
    np.testing.assert_array_equal(out["params"]["layers.0.w"],
                                  tree["params"]["layers.0.w"])
    assert int(out["opt"]["count"]) == 2
    mu = out["opt"]["mu"]["layers.0.w"]          # raw 2-byte records
    want = np.asarray(jnp.asarray(tree["opt"]["mu"]["layers.0.w"],
                                  jnp.bfloat16))
    assert mu.tobytes() == want.tobytes() and mu.shape == want.shape


def test_reference_checkpoint_restores_through_the_port(tmp_path):
    tree = _mixed(1)
    ref_tree = {"params": {"layers.0.w": jnp.asarray(
                    tree["params"]["layers.0.w"])},
                "opt": {"mu": {"layers.0.w": jnp.asarray(
                    tree["opt"]["mu"]["layers.0.w"], jnp.bfloat16)},
                    "count": jnp.int32(2)}}
    RefCheckpointer(str(tmp_path)).save(6, ref_tree)
    out = Checkpointer(str(tmp_path)).restore(like={
        "params": {"layers.0.w": 0}, "opt": {"count": 0}})
    assert torch.equal(out["params"]["layers.0.w"],
                       torch.from_numpy(tree["params"]["layers.0.w"]))
    mu = out["opt"]["mu"]["layers.0.w"]
    assert mu.dtype == torch.bfloat16
    assert torch.equal(mu.float(), torch.from_numpy(
        tree["opt"]["mu"]["layers.0.w"]))
    assert out["opt"]["count"].dtype == torch.int32 and \
        int(out["opt"]["count"]) == 2


def test_bf16_leaf_file_is_byte_identical(tmp_path):
    vals = np.random.default_rng(2).normal(size=(6, 7)).astype(np.float32)
    RefCheckpointer(str(tmp_path / "ref")).save(
        0, {"mu": jnp.asarray(vals, jnp.bfloat16)})
    Checkpointer(str(tmp_path / "port")).save(
        0, {"mu": torch.from_numpy(vals).to(torch.bfloat16)})
    files = [tmp_path / d / "step_000000000" / "arrays" / "mu.npy"
             for d in ("ref", "port")]
    assert files[0].read_bytes() == files[1].read_bytes()
    manifests = [json.loads((tmp_path / d / "step_000000000" /
                             "manifest.json").read_text())
                 for d in ("ref", "port")]
    assert manifests[0]["arrays"]["mu"]["dtype"] == \
        manifests[1]["arrays"]["mu"]["dtype"] == "bfloat16"


# ---------------------------------------------------------------------- #
# Trainer: the reference's tests/test_trainer.py, ported.
# ---------------------------------------------------------------------- #

def _trainer(tmp_path, ckpt_every=4, arch="llama3.2-1b"):
    cfg = port_config(arch).reduced()
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path), ckpt_every=ckpt_every,
                         schedule_kwargs={"warmup_steps": 2,
                                          "total_steps": 1000})
    return Trainer(cfg, SMALL_SHAPE, tcfg, data_cfg=DataConfig(seed=1),
                   device="cpu")


def test_loss_decreases(tmp_path):
    tr = _trainer(tmp_path)
    tr.run(10)
    first = np.mean([h["loss"] for h in tr.history[:3]])
    last = np.mean([h["loss"] for h in tr.history[-3:]])
    assert last < first


def test_restart_resumes_without_replay(tmp_path):
    tr1 = _trainer(tmp_path)
    tr1.run(12, stop_after=8)
    assert tr1.ckpt.latest_step() == 7
    tr2 = _trainer(tmp_path)
    tr2.init_or_restore()
    assert tr2.start_step == 8
    tr2.run(12)
    assert [h["step"] for h in tr2.history] == list(range(8, 12))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "olmoe-1b-7b"])
def test_restart_equivalence(tmp_path, arch):
    """Interrupted-and-resumed training equals uninterrupted training, bit
    for bit on the CPU: every weight, mu, nu and the count."""
    full = _trainer(tmp_path / "a", ckpt_every=100, arch=arch)
    full.run(8)
    tr1 = _trainer(tmp_path / "b", ckpt_every=4, arch=arch)
    tr1.run(8, stop_after=4)
    tr2 = _trainer(tmp_path / "b", ckpt_every=4, arch=arch)
    tr2.run(8)
    assert [h["loss"] for h in tr1.history + tr2.history] == \
        [h["loss"] for h in full.history]
    got, want = dict(leaves(tr2.state())), \
        dict(leaves(full.state()))
    assert set(got) == set(want)
    for name in want:
        assert torch.equal(got[name], want[name]), name


def test_straggler_watchdog(tmp_path):
    tcfg = TrainerConfig(ckpt_dir=str(tmp_path), straggler_factor=2.0,
                         ema_decay=0.5)
    t = Trainer(port_config("llama3.2-1b").reduced(), SMALL_SHAPE, tcfg,
                device="cpu")
    t._watchdog(0, 1.0)
    t._watchdog(1, 1.1)
    assert not t.straggler_events
    t._watchdog(2, 5.0)
    assert len(t.straggler_events) == 1 and t.straggler_events[0][0] == 2


def test_trainer_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default resolves to it")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        Trainer(port_config("llama3.2-1b").reduced(), SMALL_SHAPE,
                TrainerConfig(ckpt_dir=str(tmp_path)))


def test_trainer_mesh_is_not_ported(tmp_path):
    # Over a mesh the trainer runs every arch
    # (tests/test_torch_gspmd_trainer.py): on gemma3-12b it is made with
    # the policy's specs, whisper's frames among the batch's; a mesh that
    # is not a ProcessMesh is refused.
    from repro_torch.launch.mesh import ProcessMesh
    mesh = ProcessMesh(axis_names=("data", "model"),
                       shape={"data": 2, "model": 2},
                       coords={"data": 1, "model": 0}, rank=2,
                       device=torch.device("cpu"), backend="gloo",
                       groups={}, group_ranks={}, log=None)
    for arch, extra in (("gemma3-12b", {}),
                        ("whisper-base", {"frames": ("data", None, None)})):
        t = Trainer(port_config(arch).reduced(), SMALL_SHAPE,
                    TrainerConfig(ckpt_dir=str(tmp_path / arch)), mesh=mesh)
        assert t.mesh is mesh and t.device == torch.device("cpu")
        assert t.specs["batch"] == {"tokens": ("data", None),
                                    "labels": ("data", None), **extra}
        assert t.specs["opt"]["mu"] == t.specs["params"]
    for arch in ("gemma3-12b", "llama3.2-1b"):
        with pytest.raises(TypeError, match="ProcessMesh"):
            Trainer(port_config(arch).reduced(), SMALL_SHAPE,
                    TrainerConfig(ckpt_dir=str(tmp_path)), mesh=object(),
                    device="cpu")


def test_train_launcher_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "olmoe-1b-7b", "--reduced", "--device", "cpu",
            "--steps", "4", "--ckpt-dir", str(tmp_path)]
    rec = train_cli.train(train_cli.parser().parse_args(argv))
    assert [h["step"] for h in rec["trainer"].history] == [0, 1, 2, 3]
    assert rec["launches"] == rec["planned"] == 0
    assert rec["trainer"].shape == train_cli.SMOKE_SHAPE
    out = capsys.readouterr().out
    assert "grouped_matmul launches 0 (planned 0)" in out
    again = train_cli.train(train_cli.parser().parse_args(
        argv[:-3] + ["6", "--ckpt-dir", str(tmp_path)]))
    assert again["trainer"].start_step == 4
    assert [h["step"] for h in again["trainer"].history] == [4, 5]
    # --mesh spawns a world (tests/test_torch_gspmd_trainer.py); a
    # trainer made without this rank's mesh refuses, whatever the arch.
    with pytest.raises(ValueError, match="spawned world"):
        train_cli.make_trainer(train_cli.parser().parse_args(
            argv + ["--mesh", "2,2"]))
    with pytest.raises(ValueError, match="spawned world"):
        train_cli.make_trainer(train_cli.parser().parse_args(
            ["--arch", "falcon-mamba-7b"] + argv[2:] + ["--mesh", "2,2"]))
