"""The port's partitioned train step against the reference's
``make_train_step(cfg, shape, mesh)`` on four host devices, for reduced
gemma3-12b (five sliding-window ``local`` layers to one global;
``tests/_gspmd.py`` runs both).  The hybrid arch's local layers are in
``tests/test_torch_gspmd_train_hybrid.py``.

Cases, each three fp32 steps (1, 2, 3 of the schedule) at batch 4 x 32:

* gemma3-12b on ``(data=2, model=2)`` (its whole period), and cut to one
  local and the global layer on ``(1, 4)`` (its 2 kv heads do not divide
  4), ``(4, 1)`` and ``(pod=2, 1, 2)``, with a 16-token window so that
  ``local_attention`` runs (the reduced window of 32 equals the
  sequence, and the reference tests the global length against it);
* the cut gemma3-12b with 2 heads on ``(1, 4)``: the context-parallel fallback
  (queries split along the sequence in blocks of 8, K/V gathered), with
  an 8-token window, so each block's window reaches into the block
  before.

Each rank's blocks are held against the reference's shards on the device
at the same mesh position: the specs and indices exactly, the loss,
``grad_norm`` and ``lr_scale`` by ``_check_metrics``, the parameters after
each step by the element rule, ``mu`` and ``nu`` within what the
gradients' agreement allows (``tests/_gspmd.py``).
"""
from __future__ import annotations

import pytest

from _gspmd import (case, check_blocks_placed, check_metrics_all_ranks,
                    check_opt_state, check_params_per_step, check_specs,
                    run_module)
from _gspmd_ranks import train_rank
from _torch_train_helpers import one_torch_thread  # noqa: F401

POD = ("pod", "data", "model")
#: One local and the global layer: both kinds at a third of the period's
#: compile time in the reference (the whole period runs on (2, 2)).
LG = {"layer_pattern": ("local", "global"), "num_layers": 2}
CASES = [
    case("gemma3-2x2", "gemma3-12b", (2, 2), overrides={"window_size": 16}),
    case("gemma3-1x4", "gemma3-12b", (1, 4),
         overrides={**LG, "window_size": 16}),
    case("gemma3-4x1", "gemma3-12b", (4, 1),
         overrides={**LG, "window_size": 16}),
    case("gemma3-pod", "gemma3-12b", (2, 1, 2), POD,
         overrides={**LG, "window_size": 16}),
    case("gemma3-heads2-1x4", "gemma3-12b", (1, 4),
         overrides={**LG, "num_heads": 2, "window_size": 8}),
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
