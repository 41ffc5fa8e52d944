"""The port's kernel modules against the reference's Pallas kernels.

Each case packs one matrix with the reference's ``pallas`` spec, bridges the
packed numpy arrays into the port with ``repro_torch.interop``, and runs the
reference kernel (Pallas interpret mode, as the reference's own CPU tests
run it) and the port's wrapper on the CPU, which takes the kernel's plain
PyTorch version.  Every declared precision is covered.

Tolerance: each side may be off by ``4 * eps * (|A| @ |B|) + ATOL + RTOL *
|C|`` (eps of the value dtype: products round once, B and A round once, C
casts once), the bound of ``tests/test_differential.py``; two computed
sides are allowed the sum of both bounds.

The CUDA kernels themselves run only on the card: ``tests/test_torch_gpu.py``
holds them against these plain versions there.
"""
from __future__ import annotations

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as ref_patterns
from repro.core.precision import as_precision as ref_precision
from repro.data.corpus import vendored_entries
from repro.kernels import ref as ref_oracle
from repro.kernels import registry as ref_registry
from repro.kernels.binned_spmm import rowsplit_spmm_pallas
from repro.kernels.grouped_matmul import grouped_matmul_pallas
from repro.sparse import formats as ref_fmt

from _torch_train_helpers import one_torch_thread  # noqa: F401
from repro_torch import interop, kernels
from repro_torch.kernels import build
from repro_torch.kernels import registry as port_registry
from repro_torch.kernels.banded_spmm import banded_spmm, banded_spmm_plain
from repro_torch.kernels.bcsr_spmm import bcsr_spmm, bcsr_spmm_plain
from repro_torch.kernels.binned_spmm import binned_spmm, binned_spmm_plain
from repro_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain
from repro_torch.kernels.grouped_matmul import (grouped_matmul,
                                                grouped_matmul_plain)
from repro_torch.kernels.rowsplit_spmm import (
    pack_rowsplit_chunks, rowsplit_layout, rowsplit_spmm, rowsplit_spmm_plain)

RTOL = ATOL = 5e-4
N = 256

#: format -> (wrapper, plain version) of the kernel that carries it.
KERNEL_OF = {"csr": (csr_spmm, csr_spmm_plain),
             "binned": (binned_spmm, binned_spmm_plain),
             "rowsplit": (rowsplit_spmm, rowsplit_spmm_plain),
             "bcsr": (bcsr_spmm, bcsr_spmm_plain),
             "dia": (banded_spmm, banded_spmm_plain)}


def _corpus(group: str):
    return next(e.load() for e in vendored_entries() if e.group == group)


def _suite(name: str, n: int = N):
    return ref_patterns.serving_suite(n)[name]()


#: format -> matrices of the regime the kernel serves, plus one other.
MATRICES = {
    "csr": [("uniform", lambda: _suite("uniform")),
            ("scale-free", lambda: _suite("scale-free")),
            ("corpus-random", lambda: _corpus("random"))],
    "binned": [("scale-free", lambda: _suite("scale-free")),
               ("corpus-scale_free", lambda: _corpus("scale_free"))],
    # Every vendored matrix and every serving structure.
    "rowsplit": ([(f"corpus-{e.group}-{e.name}", e.load)
                  for e in vendored_entries()]
                 + [(name, lambda name=name: _suite(name))
                    for name in sorted(ref_patterns.serving_suite(N))]),
    "bcsr": [("moe-block", lambda: _suite("moe-block")),
             ("corpus-blocked", lambda: _corpus("blocked"))],
    "dia": [("banded", lambda: _suite("banded")),
            ("corpus-diagonal", lambda: _corpus("diagonal"))],
}

CASES = [(f, tok, name, gen)
         for f in MATRICES
         for tok in ref_registry.get(f, "pallas").supported_precisions
         for name, gen in MATRICES[f]]


def _bridge(m):
    return interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                  m.meta)


def _as_numpy(layout):
    """The reference's packed layout with numpy arrays, as interop takes."""
    if isinstance(layout, dict):
        if "arrays" in layout:
            return dict(layout, arrays=tuple(np.asarray(a)
                                             for a in layout["arrays"]))
        return {k: np.asarray(v) if hasattr(v, "shape") else v
                for k, v in layout.items()}
    return {f: np.asarray(getattr(layout, f)) if f in (
        "blocks", "block_rows", "block_cols", "block_ptr")
        else getattr(layout, f)
        for f in ("blocks", "block_rows", "block_cols", "block_ptr", "n",
                  "t", "nnz")}


def _bound(m, b: np.ndarray, eps: float) -> np.ndarray:
    dense = np.asarray(ref_fmt.coo_to_dense(m), np.float64)
    return 4.0 * eps * (np.abs(dense) @ np.abs(b.astype(np.float64)))


def _assert_within(got, ref, absprod, what: str) -> None:
    g = np.asarray(got, np.float64)
    r = np.asarray(ref, np.float64)
    assert g.shape == r.shape, f"{what}: {g.shape} vs {r.shape}"
    assert np.isfinite(g).all(), f"{what}: non-finite output"
    bound = 2 * (absprod + ATOL) + RTOL * (np.abs(g) + np.abs(r))
    err = np.abs(g - r)
    assert np.all(err <= bound), (
        f"{what}: exceeds the bound by {float(np.max(err - bound)):.3e}")


def _to_numpy(c: torch.Tensor) -> np.ndarray:
    return c.to(torch.float32).numpy()


@pytest.mark.parametrize("d", [1, 8, 16])
@pytest.mark.parametrize("fmt,token,name,gen", CASES,
                         ids=[f"{f}-{t}-{n}" for f, t, n, _ in CASES])
def test_plain_version_matches_pallas_kernel(fmt, token, name, gen, d):
    m = gen()
    prec = ref_precision(token)
    # An explicit slab makes the row-tiled layouts stream B in slabs (and
    # keeps the int16 rows legal) at this small n.
    b_tile = 64 if fmt in ("csr", "binned") else None
    ctx = ref_registry.KernelContext(bcsr_block=32, plan_d=d,
                                     precision=prec, b_tile=b_tile)
    spec = ref_registry.get(fmt, "pallas")
    ref_layout = spec.prepare(m, ctx)
    b = np.random.default_rng(d).normal(size=(m.n, d)).astype(np.float32)
    ref_c = np.asarray(spec.run(ref_layout, jnp.asarray(b), ctx),
                       np.float32)

    layout = interop.layout_from_numpy(fmt, _as_numpy(ref_layout), "cpu")
    dtype = torch.bfloat16 if prec.reduced else torch.float32
    bt = torch.from_numpy(b).to(dtype)
    wrapper, plain = KERNEL_OF[fmt]
    before = kernels.launch_counts()
    port_c = wrapper(layout, bt)
    assert kernels.launch_counts() == before, \
        "the CPU path must not count a kernel launch"
    assert port_c.dtype == dtype and tuple(port_c.shape) == (m.n, d)
    assert torch.equal(port_c, plain(layout, bt))
    absprod = _bound(m, b, prec.eps)
    _assert_within(_to_numpy(port_c), ref_c, absprod,
                   f"{fmt}/{token}/{name}/d={d}")


@pytest.mark.parametrize("n", [63, 66, 68, 1024])
def test_banded_plain_version_at_every_block_edge(n):
    """The band tile t = pallas_band_tile(n) runs from 1 to 128."""
    m = ref_patterns.banded(n, 3, fill=0.9, seed=n)
    ctx = ref_registry.KernelContext(plan_d=8)
    spec = ref_registry.get("dia", "pallas")
    ref_layout = spec.prepare(m, ctx)
    assert ref_layout["t"] == ref_registry.pallas_band_tile(n)
    b = np.random.default_rng(0).normal(size=(n, 8)).astype(np.float32)
    ref_c = np.asarray(spec.run(ref_layout, jnp.asarray(b), ctx))
    layout = interop.layout_from_numpy("dia", _as_numpy(ref_layout), "cpu")
    port_c = banded_spmm(layout, torch.from_numpy(b))
    _assert_within(_to_numpy(port_c), ref_c, _bound(m, b, 2.0 ** -23),
                   f"banded n={n}")


@pytest.mark.parametrize("fmt", sorted(KERNEL_OF) + ["grouped"])
def test_wrappers_refuse_other_devices(fmt):
    if fmt == "grouped":
        # meta operands take the dry run's shape-only path; any other
        # device than CUDA, the CPU or meta raises.
        from types import SimpleNamespace
        from repro_torch.kernels import grouped_matmul as G
        gids = torch.zeros(2, dtype=torch.int32, device="meta")
        w = torch.zeros(2, 128, 128, device="meta")
        out = grouped_matmul(torch.zeros(256, 128, device="meta"), w, gids)
        assert out.device.type == "meta" and out.shape == (256, 128)
        with pytest.raises(ValueError, match="CUDA, the CPU or meta"):
            G._device_product(SimpleNamespace(device=torch.device("xpu")),
                              w, gids, 128)
        return
    m = _bridge(MATRICES[fmt][0][1]())
    layout = port_registry.get(fmt, "cuda").prepare(
        m, port_registry.KernelContext(bcsr_block=32, plan_d=8,
                                       device=torch.device("cpu")))
    wrapper, _ = KERNEL_OF[fmt]
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        wrapper(layout, torch.zeros(m.n, 8, device="meta"))


def test_every_kernel_source_has_its_launcher_and_note():
    csrc = build.CSRC
    for name in build.KERNELS:
        text = (csrc / f"{name}.cu").read_text()
        assert re.search(rf'extern "C" int {name}_launch\(', text), name
        assert "Replaces the TPU kernel" in text, name
        assert "What bounds it on the card" in text, name
    # The build is content-addressed: every header is part of the hash.
    path = build.library_path("csr_spmm")
    assert path.name.startswith("csr_spmm-") and path.suffix == ".so"
    assert pathlib.Path(path).parent == build.build_dir()


# ---------------------------------------------------------------------- #
# Row-split: load balance across hub rows, and the layout's contract.
# ---------------------------------------------------------------------- #

def _skewed(n: int = 128):
    """One hub row with n nonzeros next to n singleton rows."""
    rows = np.concatenate([np.full(n, 3), np.arange(n)]).astype(np.int32)
    cols = np.concatenate([np.arange(n), np.arange(n)]).astype(np.int32)
    vals = (1.0 + np.arange(2 * n)).astype(np.float32) / n
    return ref_patterns.COOMatrix(n=n, rows=rows, cols=cols, vals=vals,
                                  pattern="skew")


@pytest.mark.parametrize("token", ["f32i32", "bf16i32", "bf16i16"])
@pytest.mark.parametrize("chunk", [32, 128])
def test_rowsplit_plain_version_on_skewed_rows(chunk, token):
    """Chunks cross row boundaries and the hub row spans several chunks;
    the same packed arrays go through the Pallas kernel and the port."""
    m = _skewed()
    prec = ref_precision(token)
    csr = ref_fmt.coo_to_csr(m, prec.value_jnp)
    arrays = pack_rowsplit_chunks(
        np.asarray(csr.indptr), np.asarray(csr.indices),
        np.asarray(csr.data), n=m.n, chunk=chunk,
        index_dtype=prec.index_np)
    b = np.random.default_rng(chunk).normal(size=(m.n, 32)).astype(
        np.float32)
    ref_c = rowsplit_spmm_pallas(
        *(jnp.asarray(a) for a in arrays),
        jnp.asarray(b).astype(prec.value_jnp), n=m.n,
        window=int(arrays[0].shape[1]), block_d=32, interpret=True)
    layout = rowsplit_layout(*arrays, n=m.n, device="cpu")
    dtype = torch.bfloat16 if prec.reduced else torch.float32
    port_c = rowsplit_spmm(layout, torch.from_numpy(b).to(dtype))
    _assert_within(_to_numpy(port_c), np.asarray(ref_c, np.float32),
                   _bound(m, b, prec.eps), f"skewed chunk={chunk} {token}")


def test_rowsplit_layout_refuses_unordered_slots():
    """The kernel flushes on every slot change, so the layout refuses
    slots that decrease within a chunk or leave the window."""
    row_map, cols, slots, vals = pack_rowsplit_chunks(
        *_csr_host(_skewed(16)), n=16, chunk=8)
    bad = slots.copy()
    bad[0, 1], bad[0, 2] = bad[0, 2] + 1, 0
    with pytest.raises(ValueError, match="non-decreasing"):
        rowsplit_layout(row_map, cols, bad, vals, n=16)
    with pytest.raises(ValueError, match="non-decreasing"):
        rowsplit_layout(row_map, cols, slots + row_map.shape[1], vals, n=16)
    assert rowsplit_layout(row_map, cols, slots, vals, n=16).window == \
        row_map.shape[1]


def _csr_host(m):
    csr = ref_fmt.coo_to_csr(m)
    return (np.asarray(csr.indptr), np.asarray(csr.indices),
            np.asarray(csr.data))


# ---------------------------------------------------------------------- #
# Grouped matmul (the MoE expert FFN).
# ---------------------------------------------------------------------- #

def _grouped_bound(x: np.ndarray, w: np.ndarray, gids: np.ndarray,
                   bm: int, eps: float) -> np.ndarray:
    ax = np.abs(x.astype(np.float64))
    aw = np.abs(w.astype(np.float64))
    return 4.0 * eps * np.concatenate([
        ax[i * bm:(i + 1) * bm] @ aw[g] for i, g in enumerate(gids)])


@pytest.mark.parametrize("E,bm", [(4, 64), (8, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_plain_version_matches_pallas_kernel(E, bm, dtype):
    rng = np.random.default_rng(E * bm)
    T, K, N = 4 * bm, 128, 256
    x = rng.normal(size=(T, K)).astype(np.float32)
    w = rng.normal(size=(E, K, N)).astype(np.float32)
    gids = rng.integers(0, E, size=T // bm).astype(np.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj, wj = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    ref_c = np.asarray(grouped_matmul_pallas(
        xj, wj, jnp.asarray(gids), bm=bm, bk=64, bn=128, interpret=True),
        np.float32)
    oracle = np.asarray(ref_oracle.grouped_matmul_ref(
        xj, wj, jnp.asarray(gids), bm=bm), np.float32)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    before = kernels.launch_counts()
    port_c = grouped_matmul(xt, wt, torch.from_numpy(gids), bm=bm, bk=64,
                            bn=128)
    assert kernels.launch_counts() == before
    assert port_c.dtype == tdt and tuple(port_c.shape) == (T, N)
    assert torch.equal(port_c, grouped_matmul_plain(
        xt, wt, torch.from_numpy(gids), bm=bm))
    eps = float(torch.finfo(tdt).eps)
    absprod = _grouped_bound(_to_numpy(xt), _to_numpy(wt), gids, bm, eps)
    got = _to_numpy(port_c)
    _assert_within(got, ref_c, absprod, f"grouped E={E} bm={bm} {dtype}")
    _assert_within(got, oracle, absprod, f"grouped oracle E={E} {dtype}")


def test_grouped_matmul_refuses_ragged_shapes():
    x = torch.zeros(256, 128)
    w = torch.zeros(2, 128, 128)
    gids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="not divisible by tiles"):
        grouped_matmul(x[:200], w, gids, bm=128)
    with pytest.raises(ValueError, match="not divisible by tiles"):
        grouped_matmul(x, w, gids, bm=128, bk=96)
    with pytest.raises(ValueError, match="K="):
        grouped_matmul(x, w[:, :64], gids, bm=128, bk=64)
    assert grouped_matmul(x, w, gids, bm=128).shape == (256, 128)
