"""The port's partitioned train step against the reference's
``make_train_step(cfg, shape, mesh)`` on four host devices, for reduced
recurrentgemma-9b cut to one period of ``(rglru, rglru, local)``
(``tests/_gspmd.py`` runs both; gemma3-12b's local layers are in
``tests/test_torch_gspmd_train_local.py``).

Cases, each three fp32 steps (1, 2, 3 of the schedule) at batch 4 x 32:
``(data=2, model=2)`` and ``(1, 4)`` with a 16-token window (the RG-LRU
on the rank's channels and gate blocks, MQA local attention over the
gathered sequence), ``(pod=2, 1, 2)``, and 2 heads with an 8-token window
on ``(1, 4)`` (the context-parallel fallback, each block's window
reaching into the block before).

Each rank's blocks are held against the reference's shards on the device
at the same mesh position, as in ``tests/test_torch_gspmd_train_local.py``.
"""
from __future__ import annotations

import pytest

from _gspmd import (case, check_blocks_placed, check_metrics_all_ranks,
                    check_opt_state, check_params_per_step, check_specs,
                    run_module)
from _gspmd_ranks import train_rank
from _torch_train_helpers import one_torch_thread  # noqa: F401

POD = ("pod", "data", "model")
RG = {"layer_pattern": ("rglru", "rglru", "local"), "num_layers": 3}
CASES = [
    case("rgemma-2x2", "recurrentgemma-9b", (2, 2),
         overrides={**RG, "window_size": 16}),
    case("rgemma-1x4", "recurrentgemma-9b", (1, 4),
         overrides={**RG, "window_size": 16}),
    case("rgemma-pod", "recurrentgemma-9b", (2, 1, 2), POD, overrides=RG),
    case("rgemma-heads2-1x4", "recurrentgemma-9b", (1, 4),
         overrides={**RG, "num_heads": 2, "window_size": 8}),
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
