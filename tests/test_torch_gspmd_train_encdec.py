"""The port's partitioned train step and whisper's cross cache over a
mesh against the reference's on four host devices, for reduced
whisper-base (``tests/_gspmd.py`` runs both).

Train cases, each three fp32 steps (1, 2, 3 of the schedule) at batch 4 x
32 on the batches' frames: ``(data=2, model=2)``, ``(1, 4)``, ``(4, 1)``,
``(pod=2, 1, 2)``, 2 heads on ``(1, 4)`` (the context-parallel fallback
in the encoder, the decoder and the cross-attention), and ``grad_accum``
2 on ``(2, 2)``.  The encoder runs sequence-parallel over ``"model"``
and its output, whole on every rank, feeds each decoder layer's
cross-attention; each rank's blocks are held against the reference's
shards as in ``tests/test_torch_gspmd_train.py``.

Cross-cache cases: ``LM.encode`` over the mesh (with the serve step's
context) and ``LM.prime_cross_cache`` into the rank's blocks, against the
reference's ``prime_cross_cache`` on its encoder's whole output, sliced
by its ``cache_pspecs``: the specs and each rank's block index exactly,
the encoder's output (the rank's rows) and every layer's ``cross_k`` /
``cross_v`` block within ``RTOL`` of the leaf's largest |value|, on
``(2, 2)`` at batch 4 and 1 (the cache's sequence over ``("data",
"model")``) and on ``(1, 4)``.
"""
from __future__ import annotations

import numpy as np
import pytest

from _gspmd import (case, check_blocks_placed, check_metrics_all_ranks,
                    check_opt_state, check_params_per_step, check_specs,
                    position, ref_shard, run_module)
from _gspmd_ranks import train_rank
from _torch_train_helpers import one_torch_thread  # noqa: F401

ARCH = "whisper-base"
RTOL = 1e-5
TRAIN = [
    case("whisper-2x2", ARCH, (2, 2)),
    case("whisper-1x4", ARCH, (1, 4)),
    case("whisper-4x1", ARCH, (4, 1)),
    case("whisper-pod", ARCH, (2, 1, 2), ("pod", "data", "model")),
    case("whisper-heads2-1x4", ARCH, (1, 4), overrides={"num_heads": 2}),
    case("whisper-accum2-2x2", ARCH, (2, 2), grad_accum=2),
]
PRIME = [
    case("prime-2x2", ARCH, (2, 2), kind="prime", steps=0, cache_len=32),
    case("prime-b1-2x2", ARCH, (2, 2), kind="prime", steps=0, batch=1,
         cache_len=32),
    case("prime-1x4", ARCH, (1, 4), kind="prime", steps=0, cache_len=32),
]
NAMES = [c["name"] for c in TRAIN]
PRIMES = [c["name"] for c in PRIME]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_module(TRAIN + PRIME, train_rank,
                      tmp_path_factory.mktemp("gspmd"))


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


@pytest.mark.parametrize("name", PRIMES)
def test_cross_cache_specs_and_blocks_are_the_reference_shards(runs, name):
    c = runs["cases"][name]
    info = runs["info"][name]
    for r in runs["ranks"]:
        mine = r[name]
        pos = position(c, mine["coords"])
        for key in ("cross_k", "cross_v"):
            want = info[key]
            whole = runs["ref"][f"{name}/{key}"]
            index = want["index"][pos]
            assert index[0] == [0, whole.shape[0]]
            scale = np.abs(whole).max()
            for i, (spec, layer) in enumerate(zip(mine["specs"],
                                                  mine["cache"])):
                got = [list(e) if isinstance(e, tuple) else e
                       for e in spec]
                assert [None] + got == want["spec"], (key, got)
                ref = ref_shard(whole[i], index[1:])
                assert layer[key].shape == ref.shape, (key, i)
                err = float(np.abs(layer[key] - ref).max()) / scale
                assert err <= RTOL, f"{name} {key} layer {i}: {err:.3e}"


@pytest.mark.parametrize("name", PRIMES)
def test_encoder_output_over_the_mesh_matches(runs, name):
    c = runs["cases"][name]
    whole = runs["ref"][f"{name}/enc_out"]
    index = runs["info"][name]["cross_k"]["index"]
    scale = np.abs(whole).max()
    for r in runs["ranks"]:
        rows = index[position(c, r[name]["coords"])][1]
        want = whole[rows[0]:rows[1]]
        got = r[name]["enc_out"]
        assert got.shape == want.shape and np.isfinite(got).all()
        assert float(np.abs(got - want).max()) / scale <= RTOL
