"""The port's partitioned prefill against the reference's
``make_prefill_step(cfg, shape, mesh)`` on four host devices
(``tests/_gspmd.py`` runs both), at fp32, batch 4 x 32, for the five
families beside the global-attention dense and MoE archs (those are in
``tests/test_torch_gspmd_prefill.py``): gemma3-12b (a 16-token window,
so the local layers run their window), recurrentgemma-9b (one period of
``(rglru, rglru, local)``), falcon-mamba-7b, whisper-base (on the
batch's frames) and qwen2-vl-7b (``mm_embeds`` and ``positions_3d``).

Each on ``(data=2, model=2)`` and ``(1, 4)``; the local archs also with
2 heads on ``(1, 4)`` and an 8-token window (the context-parallel
fallback, a window across the blocks), whisper and qwen2-vl also on
``(pod=2, 1, 2)``.  Each rank's block of the logits (the reference's
``P(dp, None, "model")``) must be the reference's shard on the device at
the rank's mesh position: the same spec and index, and its values
within ``RTOL`` of the largest |logit| of the row in the reference's
whole logits: two fp32 computations of the same sums in another order,
the one-process bound of ``tests/test_torch_train_extras.py`` (the
mamba scan's exponentials carry the reordered sums of ``x_proj``'s
partial products into every later step: 1.3e-5 of a row on ``(2, 2)``).
"""
from __future__ import annotations

import numpy as np
import pytest

from _gspmd import case, position, ref_shard, run_module
from _gspmd_ranks import prefill_rank
from _torch_train_helpers import one_torch_thread  # noqa: F401

RTOL = 1e-4
POD = ("pod", "data", "model")
RG = {"layer_pattern": ("rglru", "rglru", "local"), "num_layers": 3}
LOCAL = {"gemma3-12b": {}, "recurrentgemma-9b": RG}
CASES = []
for arch, short in (("gemma3-12b", "gemma3"),
                    ("recurrentgemma-9b", "rgemma"),
                    ("falcon-mamba-7b", "mamba"), ("whisper-base", "whisper"),
                    ("qwen2-vl-7b", "vlm")):
    ov = dict(LOCAL.get(arch, {}))
    if arch in LOCAL:
        ov["window_size"] = 16
    for shape in ((2, 2), (1, 4)):
        CASES.append(case(f"{short}-{shape[0]}x{shape[1]}", arch, shape,
                          kind="prefill", overrides=ov))
    if arch in LOCAL:
        CASES.append(case(f"{short}-heads2-1x4", arch, (1, 4),
                          kind="prefill", overrides={**ov, "num_heads": 2,
                                                     "window_size": 8}))
    if arch in ("whisper-base", "qwen2-vl-7b"):
        CASES.append(case(f"{short}-pod", arch, (2, 1, 2), POD,
                          kind="prefill"))
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
    assert worst <= RTOL, f"{name}: worst error / row scale {worst:.3e}"
