"""The port's serve step over a mesh against the reference's
``make_serve_step(cfg, shape, mesh)`` on four host devices
(``tests/_gspmd.py`` runs both), for the five archs of global attention,
at fp32: 24 decode steps of batch 4 (or 1) from an empty 32-slot cache.

Each rank's block of every step's logits (``[B / dp, V_padded / tp]``,
the reference's ``P(dp, "model")``) and of every leaf of the final cache
(``[B / dp, S_c / n, Hkv, D]``, the sequence split over the leftover data
axes and ``"model"``) must be the reference's shard on the device at the
rank's mesh position: the same spec and index, and values within
``RTOL32`` of each logit row's largest |logit| (the one-process decode
tests' bound, ``tests/test_torch_lm.py``) or of the cache leaf's largest
|value|.  The port is held to the reference's **partitioned** step, not
the unsharded one: the MoE's capacity is counted per data shard, so the
dropped tokens can differ from one process's.  The cases: heads and kv
heads over ``"model"``, MQA (gemma-2b: K/V whole), ``(1, 4)`` with an
untied head and biases (qwen2-72b) and with the MoE (qwen3-moe), a batch
of 1 whose cache sequence is split over ``("data", "model")``, and a
``"pod"`` axis; olmoe-1b-7b at batch 1 on ``(2, 2)`` is refused with
``ValueError`` by both packages (the MoE's ``shard_map`` needs the data
axes to divide the batch).
"""
from __future__ import annotations

import numpy as np
import pytest

from _gspmd import run_module, serve_case
from _gspmd_ranks import serve_rank
from _gspmd_serve import (check_cache_blocks, check_cache_specs,
                          check_logits, check_param_blocks,
                          check_whole_cache)
from _torch_train_helpers import GRAD_RTOL
from _torch_train_helpers import one_torch_thread  # noqa: F401

CASES = [
    serve_case("llama-2x2", "llama3.2-1b", (2, 2)),
    serve_case("olmoe-2x2", "olmoe-1b-7b", (2, 2)),
    serve_case("gemma-2x2", "gemma-2b", (2, 2)),
    serve_case("qwen2-1x4", "qwen2-72b", (1, 4)),
    serve_case("qwen3moe-1x4", "qwen3-moe-235b-a22b", (1, 4)),
    serve_case("llama-b1", "llama3.2-1b", (2, 2), batch=1),
    serve_case("olmoe-pod", "olmoe-1b-7b", (2, 1, 2),
               ("pod", "data", "model")),
    serve_case("olmoe-b1", "olmoe-1b-7b", (2, 2), batch=1),
]
REFUSED = "olmoe-b1"
NAMES = [c["name"] for c in CASES if c["name"] != REFUSED]
MOE = [n for n in NAMES if "olmoe" in n or "moe" in n]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_module(CASES, serve_rank, tmp_path_factory.mktemp("serve"))


def test_reference_and_world_stay_inside_their_limits(runs):
    assert runs["world_s"] < 180.0 and runs["seconds"] < 240.0


@pytest.mark.parametrize("name", NAMES)
def test_logits_blocks_are_the_reference_shards(runs, name):
    check_logits(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_cache_specs_equal_the_reference(runs, name):
    check_cache_specs(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_cache_blocks_are_the_reference_shards(runs, name):
    check_cache_blocks(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_whole_cache_assembles_on_every_rank(runs, name):
    check_whole_cache(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_blocks_are_the_reference_shards(runs, name):
    check_param_blocks(runs, name)


@pytest.mark.parametrize("name", MOE)
def test_no_routing_near_tie(runs, name):
    for r in runs["ranks"]:
        assert r[name]["margin"] > 2 * GRAD_RTOL, r[name]["margin"]


def test_moe_batch_the_data_axes_do_not_divide_is_refused_by_both(runs):
    assert "error" in runs["info"][REFUSED]
    assert "divisible" in runs["info"][REFUSED]["error"]
    for r in runs["ranks"]:
        assert "shard_map" in r[REFUSED]["error"], r[REFUSED]
    assert all("error" not in r[n] for r in runs["ranks"] for n in NAMES)
    assert np.isfinite(runs["ranks"][0][NAMES[0]]["logits"][-1]).all()
