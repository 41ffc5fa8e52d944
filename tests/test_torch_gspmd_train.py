"""The port's partitioned train step against the reference's
``make_train_step(cfg, shape, mesh)`` on four host devices: the dense
archs (``tests/_gspmd.py`` runs both; the MoE cases are in
``tests/test_torch_gspmd_train_moe.py``).

Cases, each three fp32 steps (1, 2, 3 of the schedule; step 0's warm-up
``lr_scale`` of 0 would move nothing) at batch 4 x 16:

* reduced llama3.2-1b on ``(data=2, model=2)``: FSDP, tensor and sequence
  parallel, heads and kv heads over ``"model"``;
* reduced gemma-2b on ``(2, 2)``: MQA, K/V whole on every rank;
* reduced llama3.2-1b on ``(1, 4)``: its 2 kv heads do not divide 4;
* reduced llama3.2-1b with 2 heads on ``(1, 4)``: the context-parallel
  fallback (queries split along the sequence, K/V gathered);
* reduced llama3.2-1b on ``(4, 1)``: pure FSDP;
* reduced qwen2-72b on ``(2, 2)``: q/k/v biases, an untied ``lm_head``;
* reduced llama3.2-1b on ``(2, 2)`` with fused projections (``wqkv``,
  ``wi_fused``), whose blocks each rank gathers whole, and with the
  chunked loss (each chunk's logits vocab-parallel).

Each rank's blocks are held against the reference's shards on the device
at the same mesh position: the specs and indices exactly, the loss,
``grad_norm`` and ``lr_scale`` by ``_check_metrics``, the parameters after
each step by ``_check_params`` (the element rule), ``mu`` and ``nu``
within ``GRAD_RTOL`` (``2 * GRAD_RTOL`` for ``nu``, a square) of each
leaf's largest value.
"""
from __future__ import annotations

import pytest

from _gspmd import (case, check_blocks_placed, check_metrics_all_ranks,
                    check_opt_state, check_params_per_step, check_specs,
                    run_module)
from _gspmd_ranks import train_rank
from _torch_train_helpers import one_torch_thread  # noqa: F401

CASES = [
    case("llama-2x2", "llama3.2-1b", (2, 2)),
    case("gemma-2x2", "gemma-2b", (2, 2)),
    case("llama-1x4", "llama3.2-1b", (1, 4)),
    case("heads2-1x4", "llama3.2-1b", (1, 4), overrides={"num_heads": 2}),
    case("llama-4x1", "llama3.2-1b", (4, 1)),
    case("qwen2-2x2", "qwen2-72b", (2, 2)),
    case("fused-2x2", "llama3.2-1b", (2, 2), fused=True),
    case("chunked-2x2", "llama3.2-1b", (2, 2), chunked=True),
]
NAMES = [c["name"] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_module(CASES, train_rank, tmp_path_factory.mktemp("gspmd"))


def test_reference_and_world_stay_inside_their_limits(runs):
    assert runs["world_s"] < 180.0 and runs["seconds"] < 240.0


@pytest.mark.parametrize("name", NAMES)
def test_specs_equal_the_reference(runs, name):
    check_specs(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_blocks_are_the_reference_shards(runs, name):
    check_blocks_placed(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_metrics_match_on_every_rank(runs, name):
    check_metrics_all_ranks(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_parameter_blocks_match_after_each_step(runs, name):
    check_params_per_step(runs, name)


@pytest.mark.parametrize("name", NAMES)
def test_optimiser_blocks_match_after_each_step(runs, name):
    check_opt_state(runs, name)
