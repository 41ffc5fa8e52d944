"""The port's partitioned prefill against the reference's
``make_prefill_step(cfg, shape, mesh)`` on four host devices
(``tests/_gspmd.py`` runs both), at fp32, batch 4 x 32.

Each rank's block of the logits (``[B / dp, S, V_padded / tp]``, the
reference's ``P(dp, None, "model")``) must be the reference's shard on the
device at the rank's mesh position: the same spec and index, and its
values within ``RTOL`` of the largest |logit| of the row in the
reference's whole logits (two fp32 computations of the same sums in
another order; ``tests/test_torch_train_extras.py``'s one-process bound
is 1e-4).  The cases cover heads and kv heads over ``"model"``, MQA's
whole K/V, kv heads that ``"model"`` does not divide, the
context-parallel fallback, pure FSDP, the MoE with and without a
``"pod"`` axis, biases and an untied head, and the fused ``wqkv`` /
``wi_fused`` kernels (gathered whole on every rank).
"""
from __future__ import annotations

import numpy as np
import pytest

from _gspmd import case, position, ref_shard, run_module
from _gspmd_ranks import prefill_rank
from _torch_train_helpers import GRAD_RTOL
from _torch_train_helpers import one_torch_thread  # noqa: F401

RTOL = 1e-5
CASES = [
    case("llama-2x2", "llama3.2-1b", (2, 2), kind="prefill"),
    case("gemma-2x2", "gemma-2b", (2, 2), kind="prefill"),
    case("llama-1x4", "llama3.2-1b", (1, 4), kind="prefill"),
    case("heads2-1x4", "llama3.2-1b", (1, 4), kind="prefill",
         overrides={"num_heads": 2}),
    case("llama-4x1", "llama3.2-1b", (4, 1), kind="prefill"),
    case("qwen2-2x2", "qwen2-72b", (2, 2), kind="prefill"),
    case("fused-2x2", "llama3.2-1b", (2, 2), kind="prefill", fused=True),
    case("olmoe-2x2", "olmoe-1b-7b", (2, 2), kind="prefill"),
    case("olmoe-pod", "olmoe-1b-7b", (2, 1, 2), ("pod", "data", "model"),
         kind="prefill"),
]
NAMES = [c["name"] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_module(CASES, prefill_rank, tmp_path_factory.mktemp("gspmd"))


def test_reference_and_world_stay_inside_their_limits(runs):
    assert runs["world_s"] < 180.0 and runs["seconds"] < 240.0


@pytest.mark.parametrize("name", NAMES)
def test_logits_spec_equals_the_reference(runs, name):
    want = runs["info"][name]["logits"]["spec"]
    for r in runs["ranks"]:
        got = [list(e) if isinstance(e, tuple) else e for e in r[name]["spec"]]
        assert got == want


@pytest.mark.parametrize("name", NAMES)
def test_logits_blocks_are_the_reference_shards(runs, name):
    c = runs["cases"][name]
    whole = runs["ref"][f"{name}/logits"]
    scale = np.abs(whole).max(axis=-1, keepdims=True)
    index = runs["info"][name]["logits"]["index"]
    worst = 0.0
    for r in runs["ranks"]:
        at = index[position(c, r[name]["coords"])]
        got, want = r[name]["logits"], ref_shard(whole, at)
        assert got.shape == want.shape and np.isfinite(got).all()
        err = np.abs(got - want) / ref_shard(scale, at[:2] + [[0, 1]])
        worst = max(worst, float(err.max()))
        assert r[name]["margin"] > 2 * GRAD_RTOL, r[name]["margin"]
    assert worst <= RTOL, f"{name}: worst error / row scale {worst:.3e}"
