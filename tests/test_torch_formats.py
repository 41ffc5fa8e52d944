"""The port's containers, converters and host packers against the reference.

The same matrix (the vendored corpus, loaded by the reference's loader, and
the serving suite) goes to both packages through ``repro_torch.interop``;
every container field and every packed array must be equal, bit for bit
(bf16 values are compared as their 16-bit patterns).  Also: the port
imports neither ``jax`` nor ``repro``.
"""
from __future__ import annotations

import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as ref_patterns
from repro.data.corpus import vendored_entries
from repro.kernels import registry as ref_registry
from repro.kernels.binned_spmm import csr_to_slab_bins as ref_slab_bins
from repro.kernels.binned_spmm import pack_rowsplit_chunks as ref_rowsplit
from repro.kernels.csr_spmm import csr_to_row_tiles as ref_row_tiles
from repro.sparse import formats as ref_fmt

from repro_torch import interop
from repro_torch.core import patterns as port_patterns
from repro_torch.kernels import registry as port_registry
from repro_torch.kernels.binned_spmm import csr_to_slab_bins
from repro_torch.kernels.csr_spmm import csr_to_row_tiles
from repro_torch.kernels.rowsplit_spmm import pack_rowsplit_chunks
from repro_torch.sparse import formats as port_fmt

ROOT = pathlib.Path(__file__).resolve().parent.parent
N = 256


def _bridge(m):
    return interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                  m.meta)


def _matrices():
    out = [(f"corpus:{e.group}/{e.name}", e.load())
           for e in vendored_entries()]
    out += [(f"suite:{name}", gen())
            for name, gen in ref_patterns.serving_suite(N).items()]
    return out


MATRICES = _matrices()
IDS = [name for name, _ in MATRICES]


def bits(x) -> np.ndarray:
    """A field as a numpy array, bf16 as its uint16 bit pattern."""
    if isinstance(x, torch.Tensor):
        return port_fmt.host_values(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_same(ref, port, what: str) -> None:
    r, p = bits(ref), bits(port)
    assert r.dtype == p.dtype, f"{what}: dtype {r.dtype} vs {p.dtype}"
    assert r.shape == p.shape, f"{what}: shape {r.shape} vs {p.shape}"
    assert np.array_equal(r, p), f"{what}: values differ"


def assert_container(ref, port, fields, statics, what: str) -> None:
    for f in fields:
        assert_same(getattr(ref, f), getattr(port, f), f"{what}.{f}")
    for f in statics:
        assert getattr(ref, f) == getattr(port, f), f"{what}.{f}"


CONTAINERS = {
    "csr": (lambda m, dt: ref_fmt.coo_to_csr(m, dt),
            lambda m, dt: port_fmt.coo_to_csr(m, dt),
            ("data", "indices", "indptr", "row_ids"), ("n",)),
    "ell": (lambda m, dt: ref_fmt.coo_to_ell(m, dt),
            lambda m, dt: port_fmt.coo_to_ell(m, dt),
            ("data", "indices"), ("n",)),
    "bcsr": (lambda m, dt: ref_fmt.coo_to_bcsr(m, 32, dt),
             lambda m, dt: port_fmt.coo_to_bcsr(m, 32, dt),
             ("blocks", "block_rows", "block_cols", "block_ptr"),
             ("n", "t", "nnz")),
    "binned": (lambda m, dt: ref_fmt.coo_to_binned(m, dt),
               lambda m, dt: port_fmt.coo_to_binned(m, dt),
               ("data", "cols", "rows", "slab_ptr"), ("slab_rows", "n")),
    "rowsplit": (lambda m, dt: ref_fmt.coo_to_rowsplit(m, dt),
                 lambda m, dt: port_fmt.coo_to_rowsplit(m, dt),
                 ("data", "cols", "rows"), ("chunk", "n", "nnz")),
    "ell_coo": (lambda m, dt: ref_fmt.coo_to_ell_coo(m, dt),
                lambda m, dt: port_fmt.coo_to_ell_coo(m, dt),
                ("body_data", "body_indices", "tail_data", "tail_cols",
                 "tail_rows"), ("n", "nnz")),
}


@pytest.mark.parametrize("value", ["f32", "bf16"])
@pytest.mark.parametrize("name,m", MATRICES, ids=IDS)
def test_containers_equal_reference(name, m, value):
    pm = _bridge(m)
    rdt, pdt = ((jnp.float32, torch.float32) if value == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    for fmt_name, (ref_conv, port_conv, fields, statics) in \
            CONTAINERS.items():
        assert_container(ref_conv(m, rdt), port_conv(pm, pdt), fields,
                         statics, f"{name}/{fmt_name}")
    try:
        ref_dia = ref_fmt.coo_to_dia(m, rdt)
    except ValueError as e:
        with pytest.raises(ValueError, match="distinct diagonals"):
            port_fmt.coo_to_dia(pm, pdt)
        assert "distinct diagonals" in str(e)
    else:
        assert_container(ref_dia, port_fmt.coo_to_dia(pm, pdt), ("data",),
                         ("offsets", "n"), f"{name}/dia")
    assert_same(ref_fmt.coo_to_dense(m, rdt), port_fmt.coo_to_dense(pm, pdt),
                f"{name}/dense")


@pytest.mark.parametrize("name,m", MATRICES, ids=IDS)
def test_format_helpers_equal_reference(name, m):
    deg = np.bincount(m.rows, minlength=m.n)
    assert ref_fmt.ell_coo_cutoff(deg) == port_fmt.ell_coo_cutoff(deg)
    assert ref_fmt.default_slab_rows(m.n) == port_fmt.default_slab_rows(m.n)
    for shards, align in ((1, 1), (3, 1), (4, 8)):
        np.testing.assert_array_equal(
            ref_fmt.nnz_balanced_splits(deg, shards, align=align),
            port_fmt.nnz_balanced_splits(deg, shards, align=align))
    assert ref_registry.ell_coo_split_stats(m) == \
        port_registry.ell_coo_split_stats(_bridge(m))
    for slab in (32, 100, m.n):
        assert ref_registry.binned_layout_stats(m, slab_rows=slab) == \
            port_registry.binned_layout_stats(_bridge(m), slab_rows=slab)


def _csr_arrays(m, value: str):
    """The reference's host CSR arrays, values at the storage dtype."""
    csr = ref_fmt.coo_to_csr(m, jnp.float32 if value == "f32"
                             else jnp.bfloat16)
    return (np.asarray(csr.indptr), np.asarray(csr.indices),
            np.asarray(csr.data))


def _port_csr_arrays(m, value: str):
    return port_fmt.csr_host_arrays(
        _bridge(m), torch.float32 if value == "f32" else torch.bfloat16)


PACKS = [("f32", None, np.int32), ("f32", 48, np.int32),
         ("bf16", None, np.int32), ("bf16", 64, np.int16),
         ("f32", 8, np.int16)]


@pytest.mark.parametrize("value,b_tile,index", PACKS)
@pytest.mark.parametrize("name,m", MATRICES, ids=IDS)
def test_row_tile_and_slab_bin_packers_byte_identical(name, m, value, b_tile,
                                                      index):
    ref_csr = _csr_arrays(m, value)
    port_csr = _port_csr_arrays(m, value)
    for r, p in zip(ref_csr, port_csr):
        assert_same(r, p, f"{name}/host csr")
    kw = dict(n=m.n, row_tile=8, chunk=128, b_tile=b_tile,
              index_dtype=index)
    for what, ref_pack, port_pack in (
            ("row_tiles", ref_row_tiles, csr_to_row_tiles),
            ("slab_bins", ref_slab_bins, csr_to_slab_bins)):
        ref_out = ref_pack(*ref_csr, **kw)
        port_out = port_pack(*port_csr, **kw)
        assert len(ref_out) == len(port_out)
        for i, (r, p) in enumerate(zip(ref_out, port_out)):
            assert_same(r, p, f"{name}/{what}[{i}]")


@pytest.mark.parametrize("name,m", MATRICES, ids=IDS)
def test_rowsplit_packer_byte_identical(name, m):
    ref_out = ref_rowsplit(*_csr_arrays(m, "f32"), n=m.n, chunk=128)
    port_out = pack_rowsplit_chunks(*_port_csr_arrays(m, "f32"), n=m.n,
                                    chunk=128)
    for i, (r, p) in enumerate(zip(ref_out, port_out)):
        assert_same(r, p, f"{name}/rowsplit[{i}]")


def test_packers_refuse_int16_past_extent():
    m = ref_patterns.erdos_renyi(64, 4, seed=0)
    with pytest.raises(ValueError, match="int16"):
        csr_to_row_tiles(*_port_csr_arrays(m, "f32"), n=2 ** 15,
                         index_dtype=np.int16)


@pytest.mark.parametrize("value", ["f32", "bf16"])
@pytest.mark.parametrize("name,m", MATRICES, ids=IDS)
def test_band_and_block_padding_byte_identical(name, m, value):
    rdt, pdt = ((jnp.float32, torch.float32) if value == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    pm = _bridge(m)
    # BCSR with empty block rows padded by a zero diagonal block.
    for t in (16, 32):
        ref_b = ref_registry.pad_empty_block_rows(ref_fmt.coo_to_bcsr(m, t,
                                                                      rdt))
        port_b = port_registry.pad_empty_block_rows(
            port_fmt.coo_to_bcsr(pm, t, pdt))
        assert_container(ref_b, port_b,
                         ("blocks", "block_rows", "block_cols", "block_ptr"),
                         ("n", "t", "nnz"), f"{name}/bcsr t={t}")
    try:
        ref_dia = ref_fmt.coo_to_dia(m, rdt)
    except ValueError:
        return
    port_dia = port_fmt.coo_to_dia(pm, pdt)
    for t in (1, 4, ref_registry.pallas_band_tile(m.n)):
        ref_band, ref_w = ref_registry.band_to_blocks(
            np.asarray(ref_dia.data), ref_dia.offsets, n=m.n, t=t)
        port_band, port_w = port_registry.band_to_blocks(
            port_fmt.host_values(port_dia.data), port_dia.offsets, n=m.n,
            t=t)
        assert ref_w == port_w
        assert_same(ref_band, port_band, f"{name}/band t={t}")


@pytest.mark.parametrize("n", [1, 7, 64, 96, 250, 256])
def test_tile_rules_equal_reference(n):
    assert ref_registry.pallas_band_tile(n) == \
        port_registry.pallas_band_tile(n)
    for d in (1, 8, 16, 48, 64, 1024):
        assert ref_registry.pallas_block_d(d) == \
            port_registry.pallas_block_d(d)
        for vmem in (0, 4096, 2 ** 20, 50 * 2 ** 20):
            assert ref_registry.choose_b_tile(n, vmem, bd=64) == \
                port_registry.choose_b_tile(n, vmem, bd=64)


@pytest.mark.parametrize("name", sorted(ref_patterns.serving_suite(N)))
def test_generators_equal_reference(name):
    ref = ref_patterns.serving_suite(N)[name]()
    port = port_patterns.serving_suite(N)[name]()
    assert ref.n == port.n and ref.pattern == port.pattern
    for f in ("rows", "cols", "vals"):
        assert_same(getattr(ref, f), getattr(port, f), f"{name}.{f}")


def test_interop_layout_round_trip():
    """A reference-packed layout bridged with ``layout_from_numpy`` equals
    the layout the port's own ``cuda`` spec prepares (on the CPU)."""
    m = ref_patterns.scale_free(N, 8, seed=3)
    pm = _bridge(m)
    ctx = port_registry.KernelContext(device=torch.device("cpu"),
                                      plan_d=16)
    from repro.kernels.registry import KernelContext as RefCtx
    rctx = RefCtx(plan_d=16)
    for f in ("csr", "binned", "rowsplit", "bcsr", "dia"):
        if f == "dia":
            m2 = ref_patterns.banded(N, 3, seed=1)
            pm2 = _bridge(m2)
        else:
            m2, pm2 = m, pm
        ref_layout = ref_registry.get(f, "pallas").prepare(m2, rctx)
        if f in ("csr", "binned", "rowsplit"):
            ref_layout = dict(ref_layout, arrays=tuple(
                np.asarray(a) for a in ref_layout["arrays"]))
        elif f == "bcsr":
            ref_layout = {k: np.asarray(getattr(ref_layout, k))
                          for k in ("blocks", "block_rows", "block_cols",
                                    "block_ptr", "n", "t", "nnz")}
        bridged = interop.layout_from_numpy(f, ref_layout, device="cpu")
        own = port_registry.get(f, "cuda").prepare(pm2, ctx)
        for field in ("tile_ids", "visit_tiles", "chunk_len", "piece_ptr",
                      "piece_owner", "piece_split", "split_tiles",
                      "chunk_visits", "chunk_slabs", "row_map", "cols",
                      "slots", "vals",
                      "blocks", "block_rows", "block_cols", "block_ptr",
                      "band"):
            if hasattr(own, field):
                assert_same(getattr(bridged, field), getattr(own, field),
                            f"{f}.{field}")


# ---------------------------------------------------------------------- #
# The port stands alone: no jax, nothing of the reference package.
# ---------------------------------------------------------------------- #

def _port_sources():
    return sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def test_port_sources_import_neither_jax_nor_reference():
    bad = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b"
                     r"(?!_torch)|from\s+repro(\.|\s)(?!_torch))", re.M)
    offenders = [str(p.relative_to(ROOT)) for p in _port_sources()
                 if bad.search(p.read_text())]
    assert not offenders, f"port files import jax or repro: {offenders}"


def test_importing_port_leaves_jax_and_reference_unloaded():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.interop, repro_torch.sparse\n"
        "import repro_torch.launch.serve, repro_torch.kernels.build\n"
        "import repro_torch.launch.moe_block\n"
        "import repro_torch.core.calibrate, repro_torch.data.dtree\n"
        "import repro_torch.data.corpus\n"
        "import repro_torch.launch.harvest_dispatch\n"
        "import repro_torch.sparse.engine, repro_torch.sparse.shard\n"
        "import repro_torch.launch.mesh\n"
        "import repro_torch.configs, repro_torch.models.model\n"
        "import repro_torch.configs.paper_spmm\n"
        "import repro_torch.models.decode_check\n"
        "import repro_torch.models.ssm, repro_torch.models.rglru\n"
        "import repro_torch.optim.adamw, repro_torch.optim.schedule\n"
        "import repro_torch.optim.compression, repro_torch.data.pipeline\n"
        "import repro_torch.checkpoint.checkpointer\n"
        "import repro_torch.train.train_step, repro_torch.train.trainer\n"
        "import repro_torch.launch.train\n"
        "import repro_torch.models.sharding_ctx, repro_torch.launch.sharding\n"
        "import repro_torch.core.step_cost, repro_torch.core.collectives\n"
        "import repro_torch.core.analyzer, repro_torch.launch.dryrun\n"
        "import repro_torch.core.comm, repro_torch.launch.spawn\n"
        "import repro_torch.train.pipeline\n"
        "import repro_torch.models.layers, repro_torch.models.attention\n"
        "import repro_torch.models.moe, repro_torch.core.device\n"
        "import repro_torch.core.trace\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or "
        "k.startswith('jax.') or k == 'repro' or k.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
