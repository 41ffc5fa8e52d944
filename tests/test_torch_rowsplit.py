"""The row-split fold: derived carry metadata and the plain version.

``rowsplit_layout`` derives, beside the reference packer's arrays, each
chunk's last slot and shared end rows, the rows that span chunks (carry
rows) and the rows with no entry (``rowsplit_carries``).  The CUDA kernels
store every row from these lists alone, so the first tests check them
against the row pointers the packer started from: every nonempty row is
owned by exactly one chunk or listed once as a carry row with its chunk
range, and every empty row is listed.  The plain version, the same
carry-and-fix-up fold in PyTorch, is then held against the reference's
``rowsplit_spmm_pallas`` in interpret mode within ``4 * eps * (|A| @ |B|)
+ 5e-4 + 5e-4 * |C|`` per side (the sum of both sides for two computed
results), on the same packed arrays.

Cases: a hub row spanning many chunks (some chunks lie inside it), rows
that end exactly on chunk boundaries (one row fills a chunk, one fills
two), empty rows including the first and the last, no entry at all, and
n not a multiple of 8.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as ref_patterns
from repro.core.precision import as_precision as ref_precision
from repro.kernels.binned_spmm import pack_rowsplit_chunks as ref_pack
from repro.kernels.binned_spmm import rowsplit_spmm_pallas
from repro.sparse import formats as ref_fmt

from repro_torch import kernels
from repro_torch.kernels.rowsplit_spmm import (
    HEAD_SHARED, TAIL_SHARED, rowsplit_layout, rowsplit_spmm,
    rowsplit_spmm_plain)

RTOL = ATOL = 5e-4
D = 16


def _coo(n: int, degrees, seed: int) -> ref_patterns.COOMatrix:
    """Row r gets ``degrees[r]`` distinct random columns, values from a
    seed."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), degrees)
    cols = np.concatenate([np.sort(rng.choice(n, k, replace=False))
                           for k in degrees]).astype(np.int32)
    vals = rng.normal(size=rows.shape[0]).astype(np.float32)
    return ref_patterns.COOMatrix(n=n, rows=rows.astype(np.int32), cols=cols,
                                  vals=vals, pattern="custom")


def _hub():
    """n = 203: row 7 holds every column, the others 0-3 entries."""
    degrees = np.random.default_rng(1).integers(0, 4, size=203)
    degrees[7] = 203
    return _coo(203, degrees, seed=2)


def _boundaries():
    """Degrees whose prefix sums hit multiples of 16: at chunk = 16 rows
    end on chunk boundaries, row 6 fills one chunk and row 7 two."""
    degrees = np.array([16, 8, 8, 5, 11, 3, 16, 32, 13, 3, 7, 9] + [1] * 44)
    return _coo(56, degrees, seed=3)


def _empty_rows():
    """n = 61 with empty rows first, last and in a run in the middle."""
    degrees = np.random.default_rng(4).integers(1, 9, size=61)
    degrees[[0, 20, 21, 22, 23, 40, 60]] = 0
    return _coo(61, degrees, seed=5)


def _no_entries():
    return _coo(13, np.zeros(13, dtype=np.int64), seed=6)


CASES = {"hub": _hub, "boundaries": _boundaries, "empty-rows": _empty_rows,
         "no-entries": _no_entries}


def _pack(m, chunk: int, token: str = "f32i32"):
    prec = ref_precision(token)
    csr = ref_fmt.coo_to_csr(m, prec.value_jnp)
    indptr = np.asarray(csr.indptr)
    arrays = ref_pack(indptr, np.asarray(csr.indices), np.asarray(csr.data),
                      n=m.n, chunk=chunk, index_dtype=prec.index_np)
    return indptr, arrays


@pytest.mark.parametrize("chunk", [8, 16, 128])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_row_is_owned_once_carried_or_listed_empty(case, chunk):
    m = CASES[case]()
    indptr, arrays = _pack(m, chunk)
    layout = rowsplit_layout(*arrays, n=m.n, device="cpu")
    row_map = layout.row_map.numpy()
    last = layout.last_slot.numpy()
    shared = layout.shared.numpy()
    assert np.array_equal(last, np.asarray(arrays[2])[:, -1])

    # What the row pointers say: the chunks each nonempty row's entries
    # fall in.
    degree = np.diff(indptr)
    first_chunk = indptr[:-1] // chunk
    last_chunk = (indptr[1:] - 1) // chunk
    spans = (degree > 0) & (last_chunk > first_chunk)
    single = (degree > 0) & ~spans

    # What the layout says: rows stored by one chunk alone ...
    owned = np.zeros(m.n, dtype=np.int64)
    for c in range(layout.num_chunks):
        for s in range(last[c] + 1):
            row = row_map[c, s]
            head, tail = shared[c] & HEAD_SHARED, shared[c] & TAIL_SHARED
            at_head = s == 0 and (head or (last[c] == 0 and tail))
            at_tail = s == last[c] and tail
            if row < m.n and not (at_head or at_tail):
                owned[row] += 1
    assert np.array_equal(owned, single.astype(np.int64))
    # ... carry rows, each once, with the chunk range its entries span ...
    carry_rows = layout.carry_rows.numpy()
    assert np.array_equal(carry_rows, np.flatnonzero(spans))
    assert np.array_equal(layout.carry_chunks.numpy(), np.stack(
        [first_chunk[spans], last_chunk[spans]], axis=1))
    # ... and the rows with no entry.
    assert np.array_equal(layout.empty_rows.numpy(),
                          np.flatnonzero(degree == 0))
    if case == "hub" and chunk < 128:
        hub = list(carry_rows).index(7)
        lo, hi = layout.carry_chunks.numpy()[hub]
        inside = (last[lo + 1:hi] == 0) & (shared[lo + 1:hi] == 3)
        assert hi - lo >= 10 and inside.all()


@pytest.mark.parametrize("token", ["f32i32", "bf16i32", "bf16i16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_fold_matches_pallas_kernel(case, token):
    m = CASES[case]()
    prec = ref_precision(token)
    _, arrays = _pack(m, 16, token)
    b = np.random.default_rng(7).normal(size=(m.n, D)).astype(np.float32)
    ref_c = np.asarray(rowsplit_spmm_pallas(
        *(jnp.asarray(a) for a in arrays),
        jnp.asarray(b).astype(prec.value_jnp), n=m.n,
        window=int(arrays[0].shape[1]), block_d=D, interpret=True),
        np.float64)
    layout = rowsplit_layout(*arrays, n=m.n, device="cpu")
    dtype = torch.bfloat16 if prec.reduced else torch.float32
    bt = torch.from_numpy(b).to(dtype)
    before = kernels.launch_counts()
    got = rowsplit_spmm(layout, bt)
    assert kernels.launch_counts() == before
    assert got.dtype == dtype and torch.equal(got,
                                              rowsplit_spmm_plain(layout, bt))
    g = got.to(torch.float64).numpy()
    dense = np.asarray(ref_fmt.coo_to_dense(m), np.float64)
    absprod = 4.0 * prec.eps * (np.abs(dense) @ np.abs(b.astype(np.float64)))
    bound = 2 * (absprod + ATOL) + RTOL * (np.abs(g) + np.abs(ref_c))
    assert np.isfinite(g).all()
    assert np.all(np.abs(g - ref_c) <= bound), (
        f"{case}/{token}: exceeds the bound by "
        f"{float(np.max(np.abs(g - ref_c) - bound)):.3e}")
    assert not g[np.diff(np.asarray(m.row_ptr())) == 0].any()


@pytest.mark.parametrize("fault", ["gap", "offset", "row-range"])
def test_rowsplit_layout_refuses_what_the_fold_cannot_take(fault):
    """The kernel stores rows by ``row_map`` and takes slot 0 as a chunk's
    first row, so slots must start at 0 with no gaps, and rows must lie
    in [0, n]."""
    m = CASES["boundaries"]()
    _, (row_map, cols, slots, vals) = _pack(m, 16)
    row_map, slots = row_map.copy(), slots.copy()
    if fault == "gap":
        slots[1, 8:] += 1
    elif fault == "offset":
        slots[2] += 1
    else:
        row_map[0, 0] = m.n + 1
    with pytest.raises(ValueError, match="rowsplit layout"):
        rowsplit_layout(row_map, cols, slots, vals, n=m.n)
