"""The row-tile kernels' derived arrays: chunk lengths and the work list.

The CSR and binned CUDA kernels walk only each chunk's real entries
(``chunk_len``) and take their work from a list of pieces that cuts every
owner's chunk range at ``PIECE_NNZ`` real entries (``work_pieces``).  Both
are derived from the packed arrays when a layout is built.  Here they are
held against the packer's group counts, and a plain walk that follows the
work list as the kernels do (a piece that is its owner's only one stores
its rows, the pieces of a split owner add into them) is held against the
kernels' plain versions and the reference's Pallas kernels (interpret
mode), within ``4 * eps * (|A| @ |B|) + ATOL + RTOL * |C|`` per side, the
sum of both sides' bounds for two computed results.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as ref_patterns
from repro.core.precision import as_precision as ref_precision
from repro.data.corpus import vendored_entries
from repro.kernels import registry as ref_registry
from repro.sparse import formats as ref_fmt

from repro_torch import interop, kernels
from repro_torch.kernels.binned_spmm import (binned_spmm_plain,
                                             slab_bin_layout)
from repro_torch.kernels import csr_spmm as csr_module
from repro_torch.kernels.csr_spmm import (PIECE_NNZ, chunk_lengths, csr_spmm,
                                          csr_spmm_plain, csr_to_row_tiles,
                                          csr_variant, row_tile_layout,
                                          split_owners, with_work_list,
                                          work_pieces)

RTOL = ATOL = 5e-4
N = 256
B_TILE = 64
CHUNK = 128
ROW_TILE = 8
TOKENS = ("f32i32", "bf16i32", "bf16i16")


def _skewed(n: int = 1024):
    """One hub row with n nonzeros next to n singleton rows."""
    rows = np.concatenate([np.full(n, 3), np.arange(n)]).astype(np.int32)
    cols = np.concatenate([np.arange(n), np.arange(n)]).astype(np.int32)
    vals = (1.0 + np.arange(2 * n)).astype(np.float32) / n
    return ref_patterns.COOMatrix(n=n, rows=rows, cols=cols, vals=vals,
                                  pattern="skew")


def _explicit_zeros(n: int = N):
    """A random matrix with every third stored value an explicit zero, and
    empty row tiles."""
    m = ref_patterns.serving_suite(n)["uniform"]()
    keep = (m.rows // ROW_TILE) % 5 != 2
    vals = np.where(np.arange(keep.sum()) % 3 == 0, 0.0, m.vals[keep])
    return ref_patterns.COOMatrix(n=n, rows=m.rows[keep], cols=m.cols[keep],
                                  vals=vals, pattern="zeros")


MATRICES = ([(f"corpus-{e.group}-{e.name}", e.load)
             for e in vendored_entries()]
            + [(name, lambda name=name: ref_patterns.serving_suite(N)[name]())
               for name in sorted(ref_patterns.serving_suite(N))]
            + [("skew", _skewed), ("explicit-zeros", _explicit_zeros)])
IDS = [name for name, _ in MATRICES]


def _layout(fmt: str, m, token: str, *, piece_nnz: int = PIECE_NNZ):
    """The reference's packing of ``m`` (Pallas spec, b_tile = 64) as the
    port's layout, with the derived arrays at ``piece_nnz``."""
    ctx = ref_registry.KernelContext(plan_d=8, precision=ref_precision(token),
                                     b_tile=B_TILE)
    packed = ref_registry.get(fmt, "pallas").prepare(m, ctx)
    arrays = [np.asarray(a) for a in packed["arrays"]]
    make = slab_bin_layout if fmt == "binned" else row_tile_layout
    layout = make(*arrays, n=int(packed["n"]), b_tile=packed["b_tile"],
                  row_tile=int(packed["row_tile"]), device="cpu")
    return layout if piece_nnz == PIECE_NNZ else \
        with_work_list(layout, piece_nnz)


def _group_lengths(m, fmt: str) -> np.ndarray:
    """Chunk lengths from the packer's (tile, slab) group counts: full
    chunks, then the remainder; an empty group owns one chunk of 0."""
    csr = ref_fmt.coo_to_csr(m)
    indptr = np.asarray(csr.indptr, np.int64)
    rows = np.repeat(np.arange(m.n), np.diff(indptr))
    cols = np.asarray(csr.indices, np.int64)[:indptr[-1]]
    tiles, slabs = rows // ROW_TILE, cols // B_TILE
    num_tiles = -(-m.n // ROW_TILE)
    if fmt == "binned":
        keys = slabs * (num_tiles + 1) + tiles
        counts = np.unique(keys, return_counts=True)[1] if keys.size else \
            np.zeros(1, np.int64)
    else:
        keys = tiles * (m.n + 1) + slabs
        uniq, counts = np.unique(keys, return_counts=True)
        empty = np.setdiff1d(np.arange(num_tiles), uniq // (m.n + 1))
        keys = np.concatenate([uniq, empty * (m.n + 1)])
        counts = np.concatenate([counts, np.zeros_like(empty)])[
            np.argsort(keys, kind="stable")]
    out = []
    for count in counts:
        full, rest = divmod(int(count), CHUNK)
        out += [CHUNK] * full + ([rest] if rest or not full else [])
    return np.asarray(out, np.int64)


@pytest.mark.parametrize("token", TOKENS)
@pytest.mark.parametrize("fmt", ["csr", "binned"])
@pytest.mark.parametrize("name,gen", MATRICES, ids=IDS)
def test_chunk_lengths_equal_group_counts(name, gen, fmt, token):
    m = gen()
    layout = _layout(fmt, m, token)
    lens = layout.chunk_len.numpy()
    np.testing.assert_array_equal(lens, _group_lengths(m, fmt))
    assert int(lens.sum()) == ref_fmt.coo_to_csr(m).indptr[-1]
    # Every slot past a chunk's length is padding: (0, 0, +0.0) bit for bit.
    pad = np.arange(CHUNK)[None, :] >= lens[:, None]
    vals = layout.vals.view(torch.int16) if layout.vals.dtype == \
        torch.bfloat16 else layout.vals.view(torch.int32)
    for arr in (layout.cols, layout.slots, vals):
        assert not bool(arr.numpy()[pad].any())


def test_chunk_lengths_keep_explicit_zeros_inside_a_chunk():
    cols = np.array([[3, 0, 5, 0], [0, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    slots = np.array([[0, 1, 1, 0], [0, 0, 0, 0], [0, 2, 0, 0]], np.int32)
    vals = np.array([[0.0, 0.0, 0.0, 0.0], [-0.0, 0, 0, 0],
                     [1.0, 0.0, 0, 0]], np.float32)
    np.testing.assert_array_equal(chunk_lengths(cols, slots, vals),
                                  [3, 1, 2])


@pytest.mark.parametrize("piece_nnz", [CHUNK, 300, PIECE_NNZ])
@pytest.mark.parametrize("fmt", ["csr", "binned"])
@pytest.mark.parametrize("name,gen", MATRICES, ids=IDS)
def test_work_list_covers_every_chunk_once(name, gen, fmt, piece_nnz):
    layout = _layout(fmt, gen(), "f32i32", piece_nnz=piece_nnz)
    ptr = layout.piece_ptr.numpy().astype(np.int64)
    owner = layout.piece_owner.numpy()
    chunk_owner = (layout.chunk_visits if fmt == "binned"
                   else layout.tile_ids).numpy()
    lens = layout.chunk_len.numpy().astype(np.int64)
    assert ptr[0] == 0 and ptr[-1] == lens.shape[0]
    assert np.all(np.diff(ptr) > 0)
    for p in range(owner.shape[0]):
        assert np.all(chunk_owner[ptr[p]:ptr[p + 1]] == owner[p])
        if ptr[p + 1] - ptr[p] > 1:
            assert lens[ptr[p]:ptr[p + 1]].sum() <= piece_nnz
    num_owners = (layout.visit_tiles.shape[0] if fmt == "binned"
                  else layout.num_tiles)
    np.testing.assert_array_equal(np.unique(owner), np.arange(num_owners))
    if fmt == "csr":
        split, rank = split_owners(owner, num_owners)
        np.testing.assert_array_equal(layout.split_tiles.numpy(), split)
        np.testing.assert_array_equal(layout.piece_split.numpy(), rank)
        multi = np.bincount(owner, minlength=num_owners) > 1
        np.testing.assert_array_equal(np.flatnonzero(multi), split)


@pytest.mark.parametrize("gen,piece_nnz", [
    (_skewed, 256),
    (lambda: ref_patterns.serving_suite(4096)["scale-free"](), PIECE_NNZ)],
    ids=["skew", "scale-free"])
def test_hub_tile_is_split(gen, piece_nnz):
    m = gen()
    csr = ref_fmt.coo_to_csr(m)
    arrays = csr_to_row_tiles(np.asarray(csr.indptr),
                              np.asarray(csr.indices), np.asarray(csr.data),
                              n=m.n, b_tile=None)
    layout = with_work_list(row_tile_layout(*arrays, n=m.n, b_tile=None,
                                            device="cpu"), piece_nnz)
    per_tile = np.bincount(m.rows // ROW_TILE)
    hub = int(np.argmax(per_tile))
    assert per_tile[hub] > piece_nnz
    pieces = int((layout.piece_owner == hub).sum())
    assert pieces >= -(-int(per_tile[hub]) // piece_nnz)
    assert hub in layout.split_tiles.tolist()


def test_work_pieces_refuse_a_piece_below_one_chunk():
    with pytest.raises(ValueError, match="below one chunk"):
        work_pieces(np.array([0, 1]), np.array([5]), chunk=128,
                    piece_nnz=64)


@pytest.mark.parametrize("d,want", [
    (1, ("narrow", 1)), (2, ("narrow", 2)), (3, ("narrow", 4)),
    (4, ("narrow", 4)), (5, ("narrow", 8)), (16, ("narrow", 16)),
    (17, ("narrow", 32)), (32, ("narrow", 32)), (33, ("wide", 32)),
    (64, ("wide", 32)), (200, ("wide", 32))])
def test_csr_variant_gives_narrow_widths_the_fewest_lanes_that_hold_d(d,
                                                                      want):
    """d <= 32: L lanes per entry, the smallest power of two >= d;
    wider B: the wide walk."""
    assert csr_variant(d) == want


def test_csr_variant_refuses_an_empty_width():
    with pytest.raises(ValueError, match="d must be >= 1"):
        csr_variant(0)


@pytest.mark.parametrize("d", [4, 64])
def test_a_cpu_operand_takes_the_plain_version_and_counts_no_walk(d):
    layout = _layout("csr", _skewed(256), "f32i32")
    b = torch.from_numpy(np.random.default_rng(d).normal(
        size=(layout.n, d)).astype(np.float32))
    before = dict(csr_module.LAUNCHES_BY_VARIANT)
    assert torch.equal(csr_spmm(layout, b), csr_spmm_plain(layout, b))
    assert csr_module.LAUNCHES_BY_VARIANT == before


def test_reset_launch_counts_zeroes_the_walk_counts():
    csr_module.LAUNCHES_BY_VARIANT["narrow"] += 3
    kernels.reset_launch_counts()
    assert set(csr_module.LAUNCHES_BY_VARIANT.values()) == {0}


def _walk_pieces(layout, b: torch.Tensor, binned: bool) -> torch.Tensor:
    """The kernels' walk in plain PyTorch: piece by piece, real entries
    only; an owner's only piece stores its rows, a split owner's pieces
    (and every binned visit) add into them in fp32."""
    d = b.shape[1]
    out = torch.full((layout.num_tiles * ROW_TILE, d), float("nan"))
    if binned:
        split, tile_of = set(), layout.visit_tiles.tolist()
        out.zero_()
    else:
        split, tile_of = set(layout.split_tiles.tolist()), None
        for t in split:
            out[t * ROW_TILE:(t + 1) * ROW_TILE] = 0
    base = layout.b_tile or 0
    ptr = layout.piece_ptr.tolist()
    for p, owner in enumerate(layout.piece_owner.tolist()):
        block = torch.zeros(ROW_TILE, d)
        for c in range(ptr[p], ptr[p + 1]):
            k = int(layout.chunk_len[c])
            rows = (int(layout.chunk_slabs[c]) * base
                    + layout.cols[c, :k].long())
            block.index_add_(0, layout.slots[c, :k].long(),
                             (b[rows] * layout.vals[c, :k, None]).float())
        r0 = (tile_of[owner] if binned else owner) * ROW_TILE
        if binned or owner in split:
            out[r0:r0 + ROW_TILE] += block
        else:
            out[r0:r0 + ROW_TILE] = block
    return out[:layout.n].to(b.dtype)


def _bound(m, b: np.ndarray, eps: float) -> np.ndarray:
    dense = np.asarray(ref_fmt.coo_to_dense(m), np.float64)
    return 4.0 * eps * (np.abs(dense) @ np.abs(b.astype(np.float64)))


def _assert_within(got, ref, absprod, what: str) -> None:
    g = np.asarray(got, np.float64)
    r = np.asarray(ref, np.float64)
    assert g.shape == r.shape and np.isfinite(g).all(), what
    bound = 2 * (absprod + ATOL) + RTOL * (np.abs(g) + np.abs(r))
    err = np.abs(g - r)
    assert np.all(err <= bound), (
        f"{what}: exceeds the bound by {float(np.max(err - bound)):.3e}")


WALK_MATRICES = [(name, gen) for name, gen in MATRICES
                 if name in ("scale-free", "uniform", "skew",
                             "explicit-zeros", "corpus-scale_free-"
                             + next(e.name for e in vendored_entries()
                                    if e.group == "scale_free"))]


@pytest.mark.parametrize("token", TOKENS)
@pytest.mark.parametrize("fmt", ["csr", "binned"])
@pytest.mark.parametrize("name,gen", WALK_MATRICES,
                         ids=[n for n, _ in WALK_MATRICES])
def test_piece_walk_matches_plain_version_and_pallas(name, gen, fmt, token):
    m = gen()
    prec = ref_precision(token)
    layout = _layout(fmt, m, token, piece_nnz=CHUNK)
    d = 8
    b = np.random.default_rng(3).normal(size=(m.n, d)).astype(np.float32)
    bt = torch.from_numpy(b).to(torch.bfloat16 if prec.reduced
                                else torch.float32)
    walked = _walk_pieces(layout, bt, fmt == "binned")
    plain = (binned_spmm_plain if fmt == "binned" else csr_spmm_plain)(
        layout, bt)
    absprod = _bound(m, b, prec.eps)
    to_np = lambda t: t.to(torch.float32).numpy()  # noqa: E731
    _assert_within(to_np(walked), to_np(plain), absprod,
                   f"{fmt}/{token}/{name} walk vs plain")
    ctx = ref_registry.KernelContext(plan_d=d, precision=prec,
                                     b_tile=B_TILE)
    spec = ref_registry.get(fmt, "pallas")
    ref_c = np.asarray(spec.run(spec.prepare(m, ctx), jnp.asarray(b), ctx),
                       np.float32)
    _assert_within(to_np(walked), ref_c, absprod,
                   f"{fmt}/{token}/{name} walk vs pallas")


def test_layouts_bridged_from_the_reference_carry_the_same_work_list():
    """``interop.layout_from_numpy`` derives the same arrays as the
    port's own layout builders."""
    m = ref_patterns.serving_suite(N)["scale-free"]()
    for fmt in ("csr", "binned"):
        ctx = ref_registry.KernelContext(plan_d=8, b_tile=B_TILE)
        packed = ref_registry.get(fmt, "pallas").prepare(m, ctx)
        packed = dict(packed, arrays=tuple(np.asarray(a)
                                           for a in packed["arrays"]))
        bridged = interop.layout_from_numpy(fmt, packed, "cpu")
        own = _layout(fmt, m, "f32i32")
        for f in dataclasses.fields(own):
            a, b = getattr(bridged, f.name), getattr(own, f.name)
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b), f"{fmt}.{f.name}"
            else:
                assert a == b, f"{fmt}.{f.name}"
