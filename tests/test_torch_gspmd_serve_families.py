"""The port's serve step over a mesh against the reference's
``make_serve_step(cfg, shape, mesh)`` on four host devices
(``tests/_gspmd.py`` runs both), for the ``local``, ``vlm``, ``encdec``,
``ssm`` and ``hybrid`` families at fp32: 24 decode steps of batch 4 (or
1) from an empty 32-slot cache, held as ``tests/test_torch_gspmd_serve.py``
holds the global archs (``tests/_gspmd_serve.py``: specs and indices
exactly, logits and cache blocks within ``RTOL32``).

* gemma3-12b with ``window_size`` 8 (in both packages): its local
  layers' 8-slot rings are split over ``"model"`` and wrap across the
  blocks three times;
* qwen2-vl-7b: M-RoPE with every stream at ``pos``, as the reference's
  serve step broadcasts it;
* whisper-base: the cross K/V filled from a seed (the reference's zeros
  would leave the cross-attention unchecked), split along the encoder's
  sequence and never written;
* falcon-mamba-7b on ``(2, 2)``, and at batch 1 (the rows whole on every
  rank): the mamba state and conv inputs split by channels over
  ``"model"``;
* recurrentgemma-9b on ``(1, 4)`` with ``window_size`` 8: the RG-LRU's
  four gate blocks per rank, its channel-split state, and the rings.
"""
from __future__ import annotations

import pytest

from _gspmd import run_module, serve_case
from _gspmd_ranks import serve_rank
from _gspmd_serve import (check_cache_blocks, check_cache_specs,
                          check_logits, check_param_blocks,
                          check_whole_cache)
from _torch_train_helpers import one_torch_thread  # noqa: F401

CASES = [
    serve_case("gemma3-2x2", "gemma3-12b", (2, 2),
               overrides={"window_size": 8}),
    serve_case("qwen2vl-2x2", "qwen2-vl-7b", (2, 2)),
    serve_case("whisper-2x2", "whisper-base", (2, 2)),
    serve_case("mamba-2x2", "falcon-mamba-7b", (2, 2)),
    serve_case("mamba-b1", "falcon-mamba-7b", (2, 2), batch=1),
    serve_case("rgemma-1x4", "recurrentgemma-9b", (1, 4),
               overrides={"window_size": 8}),
]
NAMES = [c["name"] for c in CASES]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_module(CASES, serve_rank, tmp_path_factory.mktemp("serve"))


def test_reference_and_world_stay_inside_their_limits(runs):
    assert runs["world_s"] < 180.0 and runs["seconds"] < 240.0
    assert not any("error" in runs["info"][n] for n in NAMES)


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


def test_the_rings_wrap_across_blocks(runs):
    # gemma3's and recurrentgemma's 8-slot rings: 24 steps write each
    # slot three times, so every block holds a written slot.
    for name in ("gemma3-2x2", "rgemma-1x4"):
        for r in runs["ranks"]:
            k = r[name]["cache"]["p2/kv/k"]
            assert k.shape[2] < 8 and (abs(k) > 0).all(axis=(0, 1, 3, 4)).all()
