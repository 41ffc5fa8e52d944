"""The dry run's loop-aware count and its full-size cells
(``repro_torch.launch.dryrun``), on ``meta`` tensors.

* The loop-aware count (no layers and one group, two and three
  micro-batches, extrapolated) equals the count of the whole model, field
  for field, on a 2 x 2 mesh, for dense, MoE, ssm and encoder-decoder
  configs and every step kind.
* One cell per family at full size on both production meshes: the record's
  keys are the reference's (``src/repro/launch/dryrun.py``) less
  ``cost_raw`` and ``compile_seconds``, plus ``count_seconds`` and
  ``fits``; the per-device FLOPs times the chips are at least the whole
  step's, and equal where every product is split over every axis (a dense
  model whose batch takes every data axis); ``model_flops`` over the
  counted FLOPs lies in (0, 1.05].
* The CLI writes its record under the directory it is given, in a fresh
  interpreter that loads neither jax nor the reference package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ShapeConfig
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MS
from repro_torch.launch import sharding as SH

MESH = MS.abstract_mesh((2, 2), ("data", "model"))


LOOP_CASES = [
    ("llama3.2-1b", "train", 4), ("llama3.2-1b", "train", 1),
    ("llama3.2-1b", "prefill", 1), ("llama3.2-1b", "decode", 1),
    ("olmoe-1b-7b", "train", 4), ("olmoe-1b-7b", "prefill", 1),
    ("olmoe-1b-7b", "decode", 1), ("falcon-mamba-7b", "train", 4),
    ("falcon-mamba-7b", "decode", 1), ("whisper-base", "train", 1),
    ("whisper-base", "prefill", 1), ("whisper-base", "decode", 1)]


@pytest.mark.parametrize("arch,kind,ga", LOOP_CASES)
def test_loop_aware_count_equals_full_count(arch, kind, ga):
    cfg = DR.with_groups(get_config(arch).reduced(), 3)
    shape = ShapeConfig("x", 64, 8, kind)
    full = DR.count_step(cfg, shape, MESH, grad_accum=ga)
    loop = DR.loop_aware_count(cfg, shape, MESH, grad_accum=ga)
    assert loop.flops == full.flops
    assert loop.bytes == full.bytes
    assert loop.flops_per_device == full.flops_per_device
    assert loop.bytes_per_device == pytest.approx(full.bytes_per_device,
                                                  rel=1e-12)
    assert dict(loop.constraints) == dict(full.constraints)


#: The reference record's keys (src/repro/launch/dryrun.py).
REF_KEYS = {"arch", "shape", "mesh", "chips", "step_kind", "grad_accum",
            "causal_impl", "chunked_loss", "cost", "cost_raw", "memory",
            "collectives", "collective_counts", "model_flops",
            "param_count", "active_param_count", "sparse_components",
            "compile_seconds"}

#: One cell per family (gemma3-12b's prefill_32k, the slowest to count,
#: is in tests/test_torch_dryrun_prefill.py).
CELLS = [("olmoe-1b-7b", "train_4k"), ("falcon-mamba-7b", "long_500k"),
         ("whisper-base", "decode_32k"), ("qwen3-moe-235b-a22b", "train_4k")]


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_full_size_cell(arch, shape_name, multi_pod):
    check_cell(arch, shape_name, multi_pod)


def check_cell(arch: str, shape_name: str, multi_pod: bool) -> None:
    """Count one cell at full size and hold its record (module doc)."""
    rec = DR.run_cell(arch, shape_name, multi_pod, verbose=False)
    assert set(rec) == (REF_KEYS - {"cost_raw", "compile_seconds"}) | \
        {"count_seconds", "fits"}
    cfg = get_config(arch)
    mesh = MS.make_production_mesh(multi_pod=multi_pod)
    assert rec["chips"] == mesh.size == (512 if multi_pod else 256)
    assert rec["mesh"] == ("2x32x8" if multi_pod else "32x8")
    cost = rec["cost"]
    spread = cost["flops_per_device"] * rec["chips"]
    assert spread >= cost["flops"] * (1 - 1e-12)
    _, leftover = SH.dp_axes_for_batch(mesh,
                                       SHAPES[shape_name].global_batch)
    if not cfg.num_experts and not leftover:
        assert spread == pytest.approx(cost["flops"], rel=1e-12)
    assert 0 < rec["model_flops"] / spread <= 1.05
    assert rec["fits"] is rec["memory"]["fits"]
    assert rec["memory"]["total_hbm_bytes"] > 0
    assert rec["collectives"]["total"] > 0
    assert rec["count_seconds"] > 0
    assert rec["grad_accum"] == DR.GRAD_ACCUM_DEFAULTS.get(
        (arch, shape_name), 1)
    if cfg.num_experts:
        assert rec["sparse_components"][0]["regime"] == "blocked_tpu"
    json.dumps(rec)


def test_cli_writes_the_record_without_jax(tmp_path):
    code = (
        "import runpy, sys\n"
        "sys.argv = ['dryrun', '--arch', 'falcon-mamba-7b', '--shape',\n"
        f"            'long_500k', '--out-dir', {str(tmp_path)!r}]\n"
        "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH="src")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=os.path.dirname(os.path.dirname(
                             os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    path = DR.record_path(str(tmp_path), "falcon-mamba-7b", "long_500k",
                          False)
    with open(path) as f:
        rec = json.load(f)
    assert rec["arch"] == "falcon-mamba-7b" and rec["chips"] == 256
    assert DR.DEFAULT_OUT == "experiments/dryrun_torch"
