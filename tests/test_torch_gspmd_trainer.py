"""``Trainer(mesh=)`` and ``launch.train --mesh`` on four gloo CPU ranks.

* Reduced olmoe-1b-7b's trainer on ``(data=2, model=2)`` preempted after 2
  steps (a checkpoint saved over the mesh) and resumed to 4 by a new
  trainer (each rank restoring only its blocks) must equal the
  uninterrupted run bit for bit: every rank's parameter and ``mu``
  blocks, and the losses.
* Its checkpoint must restore in one process of the port (whole leaves,
  no mesh) and in the reference's ``Checkpointer`` to the same leaves,
  each rank's blocks the port's ``local_block`` of them.
* ``python -m repro_torch.launch.train --arch olmoe-1b-7b --reduced
  --mesh 2,2 --device cpu`` trains 2 steps in a subprocess, and so does
  ``--arch qwen2-vl-7b`` (its patch embeddings and M-RoPE positions split
  by each rank's rows); gemma3-12b's trainer is made on a rank's mesh
  with the policy's specs, and ``--mesh`` without the rank's mesh is
  refused.
* The fresh-interpreter import guard of ``tests/test_torch_formats.py``
  covers the modules this slice added to or changed.
"""
from __future__ import annotations

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _gspmd_ranks import trainer_rank
from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro.checkpoint.checkpointer import Checkpointer as RefCheckpointer
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import get_config
from repro_torch.launch import sharding as SH
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import ProcessMesh
from repro_torch.launch.spawn import run_world
from repro_torch.models.model import LM

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEPS, STOP = 4, 2


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("trainer")
    ranks = run_world(trainer_rank, 4, str(root), STEPS, STOP, threads=1,
                      timeout=300)
    return ranks, root


def test_resumed_run_equals_the_uninterrupted_one_bit_for_bit(world):
    ranks, _ = world
    for r in ranks:
        assert r["start"] == STOP
        assert r["history"]["first"] + r["history"]["resumed"] == \
            r["history"]["whole"]
        for got, want in zip(r["resumed"], r["whole"]):
            assert set(got) == set(want)
            for k in want:
                assert np.array_equal(got[k], want[k]), k
    assert len({tuple(r["history"]["whole"]) for r in ranks}) == 1


def _fake_mesh(coords: dict) -> ProcessMesh:
    return ProcessMesh(axis_names=("data", "model"),
                       shape={"data": 2, "model": 2}, coords=dict(coords),
                       rank=0, device=torch.device("cpu"), backend="gloo",
                       groups={}, group_ranks={}, log=None)


def test_checkpoint_restores_in_one_process_and_in_the_reference(world):
    ranks, root = world
    ckpt = root / "resumed"
    port = Checkpointer(str(ckpt)).restore()
    ref = RefCheckpointer(str(ckpt)).restore()
    assert Checkpointer(str(ckpt)).latest_step() == STEPS - 1
    flat_ref = {}

    def walk(node, prefix=""):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat_ref[prefix + k] = np.asarray(v)
    walk(ref)
    params = port["params"]
    assert set(f"params/{n}" for n in params) <= set(flat_ref)
    model = LM(get_config("olmoe-1b-7b").reduced(), device="meta",
               masters=True)
    model.load_state_dict(params, strict=True, assign=True)
    for name, whole in params.items():
        np.testing.assert_array_equal(whole.numpy(),
                                      flat_ref[f"params/{name}"])
        for r in ranks:
            block = SH.local_block(whole.numpy(), r["specs"][name],
                                   _fake_mesh(r["coords"]))
            assert np.array_equal(block, r["resumed"][0][name]), name
    for name, mu in port["opt"]["mu"].items():
        np.testing.assert_array_equal(mu.numpy(),
                                      flat_ref[f"opt/mu/{name}"])


def test_launcher_trains_over_a_spawned_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "olmoe-1b-7b", "--reduced", "--mesh", "2,2", "--device", "cpu",
         "--steps", "2", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300,
        cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mesh={'data': 2, 'model': 2} backend=gloo" in r.stdout
    assert "step 1: loss" in r.stdout
    assert Checkpointer(str(tmp_path)).latest_step() == 1


def test_launcher_mesh_refuses_the_other_families(tmp_path):
    # Every family trains over --mesh now: gemma3-12b's trainer is made
    # on this rank's mesh with the policy's specs; what is still refused
    # is a trainer without the rank's mesh and a mesh of another form.
    args = train_cli.parser().parse_args(
        ["--arch", "gemma3-12b", "--reduced", "--mesh", "2,2", "--device",
         "cpu", "--ckpt-dir", str(tmp_path)])
    with pytest.raises(ValueError, match="spawned world"):
        train_cli.make_trainer(args)
    trainer = train_cli.make_trainer(args, _fake_mesh({"data": 1,
                                                       "model": 0}))
    named = dict(LM(trainer.cfg, device="meta",
                    masters=True).named_parameters())
    assert trainer.specs["params"] == SH.param_pspecs(
        trainer.cfg, named, trainer.mesh)
    assert trainer.specs["params"]["layers.0.attn.wq.kernel"] == \
        ("data", "model")
    with pytest.raises(ValueError, match="data,model"):
        train_cli.parse_mesh("2,2,2")


def test_launcher_trains_qwen2_vl_over_a_spawned_mesh(tmp_path):
    # A family with modality inputs: each rank keeps its rows of the
    # pipeline's mm_embeds and of positions_3d (split along dim 1).
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "qwen2-vl-7b", "--reduced", "--mesh", "2,2", "--device", "cpu",
         "--steps", "2", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300,
        cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "mesh={'data': 2, 'model': 2} backend=gloo" in r.stdout
    losses = [float(line.split("loss ")[1].split(",")[0])
              for line in r.stdout.splitlines()
              if line.startswith("step ")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert Checkpointer(str(tmp_path)).latest_step() == 1


def test_import_guard_lists_the_new_modules():
    text = (ROOT / "tests" / "test_torch_formats.py").read_text()
    for mod in ("repro_torch.launch.sharding", "repro_torch.models.layers",
                "repro_torch.models.attention", "repro_torch.interop",
                "repro_torch.train.trainer", "repro_torch.launch.train",
                "repro_torch.optim.adamw", "repro_torch.data.pipeline",
                "repro_torch.checkpoint.checkpointer",
                "repro_torch.models.sharding_ctx", "repro_torch.models.moe",
                "repro_torch.core.device"):
        assert mod in text, mod
