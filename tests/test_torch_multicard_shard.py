"""The sharded SpMM tier on a process mesh against the reference's
``shard_map`` tier on four devices.

The port runs one gloo world of four CPU ranks on a ``(shard=4)`` mesh
(``tests/_multicard_ranks.py::shard_rank``): for every case of
``tests/test_torch_shard.py``'s D = 4 list (both backends, the four
structures at n = 256, every B strategy, the forced scale-free formats,
``bf16i16``), each rank plans the same ``ShardedPlan``, keeps its own
shard on its kernel's layout and runs the strategy's collectives; C is the
ranks' blocks gathered (``ShardedPlan.gather_c``).  The reference is the
same module's D = 4 dump (``ref_dump_4``: one subprocess with four host
devices).

Bounds: each plan's record (partition, per-shard nonzeros, eligibility,
skip reasons, chosen strategy, every ``ShardRoofline`` number within a
relative 1e-9) equals the reference's, on every rank; C within the repo's
value bound per side, ``4 * eps * (|A| @ |B|) + atol + rtol * |C|``
(``_assert_within``): the ``reduce_scatter`` and band sums are fp32 sums
in another order.  Each rank's block is exactly its rows of the gathered
C.  Three planted faults (the reduce-scatter without its sum, an
all-gather of the rank's own slice only, the band partials not summed)
must break the value bound.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

from _multicard_ranks import SHARD_FAULTS, shard_rank
from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro_torch.launch.spawn import run_world
from test_torch_shard import (CASES_D4, _assert_same_record, _assert_within,
                              _b, _case_id, _eps, _mats, ref_dump_4)  # noqa

#: The cases each planted fault runs on (f32i32, host-cpu ceilings): the
#: structures whose shards read B rows of other shards (block-diagonal
#: shards read only their own, so these faults would not change them).
FAULT_CASES = {
    "reduce_scatter without the sum": [
        ("cuda", "host-cpu", "random", "auto", "reduce_scatter", "-"),
        ("torch", "host-cpu", "scale_free", "auto", "reduce_scatter", "-")],
    "all_gather of the own slice only": [
        ("cuda", "host-cpu", "random", "auto", "all_gather", "-"),
        ("torch", "host-cpu", "scale_free", "auto", "all_gather", "-")],
    "band partials not summed": [
        ("cuda", "host-cpu", "banded", "auto", "replicate", "-")],
}


def _numpy_mats() -> dict:
    return {k: (m.n, m.rows, m.cols, m.vals, m.pattern)
            for k, m in _mats().items()}


@pytest.fixture(scope="module")
def ranks():
    t0 = time.perf_counter()
    res = run_world(shard_rank, 4, list(CASES_D4), _numpy_mats(), _b(),
                    FAULT_CASES, threads=1, timeout=600)
    return sorted(res, key=lambda r: r["index"]), time.perf_counter() - t0


def test_world_stays_inside_its_limit(ranks):
    assert ranks[1] < 120.0


@pytest.mark.parametrize("case", CASES_D4, ids=_case_id)
def test_process_mesh_plan_equals_reference_on_four_devices(case, ranks,
                                                            ref_dump_4):
    records, outputs, _ = ref_dump_4
    key = _case_id(case)
    ref = records[key]
    for r in ranks[0]:
        got = r["cases"][key]
        if "error" in ref:
            assert "ineligible" in got.get("error", ""), (key, got)
            continue
        _assert_same_record(got["record"], ref, key)
        assert sum(got["record"]["shard_nnz"]) == _mats()[case[2]].nnz
        _assert_within(_mats()[case[2]], _b(), got["c"], outputs[key],
                       _eps(case), f"{key} rank {r['index']}")
        lo, hi = got["c_rows"]
        np.testing.assert_array_equal(got["block"], got["c"][lo:hi])


@pytest.mark.parametrize("fault,case", [
    (f, c) for f, cs in FAULT_CASES.items() for c in cs],
    ids=lambda v: v if isinstance(v, str) else _case_id(v))
def test_planted_fault_is_rejected(fault, case, ranks, ref_dump_4):
    assert fault in SHARD_FAULTS
    _, outputs, _ = ref_dump_4
    key = _case_id(case)
    assert ranks[0][0]["cases"][key]["record"]["b_strategy"] == case[4]
    rejected = 0
    for r in ranks[0]:
        try:
            _assert_within(_mats()[case[2]], _b(), r["faults"][(fault, key)],
                           outputs[key], _eps(case), fault)
        except AssertionError:
            rejected += 1
    assert rejected == len(ranks[0])


def test_blocks_partition_the_rows(ranks):
    """Row-block and reduce-scatter blocks tile ``[0, n)`` in rank order;
    a DIA ``replicate`` plan gives every rank all of C."""
    for key, first in ranks[0][0]["cases"].items():
        if "error" in first:
            continue
        rows = [r["cases"][key]["c_rows"] for r in ranks[0]]
        if rows[0] == (0, first["c"].shape[0]) and all(
                x == rows[0] for x in rows):
            assert first["record"]["chosen"] == "dia", key
            continue
        assert rows[0][0] == 0 and rows[-1][1] == first["c"].shape[0], key
        assert all(a[1] == b[0] for a, b in zip(rows, rows[1:])), key
