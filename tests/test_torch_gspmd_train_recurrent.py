"""The port's partitioned train step against the reference's
``make_train_step(cfg, shape, mesh)`` on four host devices, for reduced
falcon-mamba-7b (``tests/_gspmd.py`` runs both): the mamba scan on each
rank's channels (``in_proj``'s output gathered before the rank takes its
channels of u and z, the conv on ``conv_w``'s block, ``x_proj``
row-parallel with its partial sums ``psum``-med, ``dt_proj``, ``A_log``
and ``D`` on the block, ``out_proj`` row-parallel).

Cases, each three fp32 steps (1, 2, 3 of the schedule) at batch 4 x 32:
``(data=2, model=2)``, ``(1, 4)``, ``(4, 1)`` (pure FSDP),
``(pod=2, 1, 2)``, and ``(2, 2)`` at 4 x 512, two 256-step chunks, so the
scan's carry crosses a chunk on channel shards.

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

ARCH = "falcon-mamba-7b"
CASES = [
    case("mamba-2x2", ARCH, (2, 2)),
    case("mamba-1x4", ARCH, (1, 4)),
    case("mamba-4x1", ARCH, (4, 1)),
    case("mamba-pod", ARCH, (2, 1, 2), ("pod", "data", "model")),
    case("mamba-s512-2x2", ARCH, (2, 2), seq=512),
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
