"""The port's four kernel modules against the reference's Pallas kernels.

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
from repro.kernels import registry as ref_registry
from repro.sparse import formats as ref_fmt

from repro_torch import interop, kernels
from repro_torch.kernels import build
from repro_torch.kernels import registry as port_registry
from repro_torch.kernels.banded_spmm import banded_spmm, banded_spmm_plain
from repro_torch.kernels.bcsr_spmm import bcsr_spmm, bcsr_spmm_plain
from repro_torch.kernels.binned_spmm import binned_spmm, binned_spmm_plain
from repro_torch.kernels.csr_spmm import csr_spmm, csr_spmm_plain

RTOL = ATOL = 5e-4
N = 256

#: format -> (wrapper, plain version) of the kernel that carries it.
KERNEL_OF = {"csr": (csr_spmm, csr_spmm_plain),
             "binned": (binned_spmm, binned_spmm_plain),
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
                   f"banded t={layout.t}")


@pytest.mark.parametrize("fmt", sorted(KERNEL_OF))
def test_wrappers_refuse_other_devices(fmt):
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
