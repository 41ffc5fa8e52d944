"""The port's partitioned train step against the reference's
``make_train_step(cfg, shape, mesh)`` on four host devices: the MoE archs
(``tests/_gspmd.py`` runs both; the dense cases are in
``tests/test_torch_gspmd_train.py``).

For an MoE arch the mesh changes the result: the expert capacity is
counted per ``(pod, data)`` shard, so another set of tokens drops than in
one process.  The port's partitioned step is therefore held to the
reference's partitioned step, case by case, three fp32 steps (1, 2, 3 of
the schedule) at batch 4 x 32:

* reduced olmoe-1b-7b on ``(data=2, model=2)``: expert parallel over
  ``"model"``, FSDP over ``"data"``, the MoE's ``psum_scatter`` as the
  sequence-parallel exit;
* the same at batch 8 with ``grad_accum`` 2 at the capacity factor 1.25,
  where tokens drop: each rank's micro-batch ``i`` must be its two rows
  of the reference's micro-batch ``i`` (``launch.sharding.batch_rows``),
  since the drops depend on which rows share a capacity;
* reduced olmoe-1b-7b on ``(pod=2, data=1, model=2)``: the weights are
  replicated over ``"pod"``, their gradients summed over it;
* reduced qwen3-moe-235b-a22b on ``(2, 2)``.

The bounds are ``tests/test_torch_gspmd_train.py``'s.  A routing near-tie
could flip an expert between the packages: every router call's top-k
margin must exceed ``2 * GRAD_RTOL`` of the row's largest |logit|.
"""
from __future__ import annotations

import pytest

from _gspmd import (case, check_blocks_placed, check_metrics_all_ranks,
                    check_opt_state, check_params_per_step, check_specs,
                    run_module)
from _gspmd_ranks import train_rank
from _torch_train_helpers import GRAD_RTOL
from _torch_train_helpers import one_torch_thread  # noqa: F401

CASES = [
    case("olmoe-2x2", "olmoe-1b-7b", (2, 2)),
    case("olmoe-2x2-ga2", "olmoe-1b-7b", (2, 2), batch=8, grad_accum=2),
    case("olmoe-pod", "olmoe-1b-7b", (2, 1, 2), ("pod", "data", "model")),
    case("qwen3moe-2x2", "qwen3-moe-235b-a22b", (2, 2)),
]
NAMES = [c["name"] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_module(CASES, train_rank, tmp_path_factory.mktemp("gspmd"))


def test_reference_and_world_stay_inside_their_limits(runs):
    assert runs["world_s"] < 180.0 and runs["seconds"] < 240.0


@pytest.mark.parametrize("name", NAMES)
def test_routing_has_no_near_ties(runs, name):
    for r in runs["ranks"]:
        assert r[name]["margin"] > 2 * GRAD_RTOL, r[name]["margin"]


def test_the_accumulated_case_drops_tokens(runs):
    assert sum(r["olmoe-2x2-ga2"]["dropped"] for r in runs["ranks"]) > 0


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
