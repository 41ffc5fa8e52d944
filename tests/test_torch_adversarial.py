"""The reference's adversarial set through the port's CSR-family, binned,
row-split and banded pairs, at every precision each declares.

``tests/test_differential.py``'s ``ADVERSARIAL`` (an all-zero matrix,
n = 1 empty and dense, one hub row, singleton rows, alternating empty
rows, a lone corner) is the set a packer gets wrong first.  Each case goes
through the port's ``("csr" | "ell" | "ell_coo" | "binned" | "rowsplit" |
"dia", "cuda")`` prepare on the CPU:

* the layout must equal the reference's ``pallas`` prepare of the same
  matrix, bridged with ``repro_torch.interop``, byte for byte (the banded
  pair's diagonals also re-expand to the reference's band);
* the pair's run (the kernel's plain version, on a CPU operand) must agree
  with the reference's oracle (``repro.kernels.ref``) within ``4 * eps *
  (|A| @ |B|) + ATOL + RTOL * |C|`` per side, at d in {1, 8};
* the port's ``cuda`` plan must equal the reference's ``pallas`` plan.

``tests/test_torch_bcsr.py`` holds the same set for BCSR, and
``tests/test_torch_gpu.py`` runs it through the CUDA kernels on the card.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hardware as ref_hw
from repro.core.precision import as_precision as ref_precision
from repro.kernels import ref as ref_oracle
from repro.kernels import registry as ref_registry
from repro.sparse import formats as ref_fmt
from repro.sparse.dispatch import Dispatcher as RefDispatcher

from repro_torch import interop
from repro_torch.core import hardware as port_hw
from repro_torch.core.precision import as_precision
from repro_torch.kernels import registry as port_registry
from repro_torch.sparse.dispatch import Dispatcher
from repro_torch.sparse.formats import host_values

from test_differential import ADVERSARIAL

RTOL = ATOL = 5e-4
FORMATS = ("csr", "ell", "ell_coo", "binned", "rowsplit", "dia")
CASES = [(f, case, tok) for f in FORMATS for case in sorted(ADVERSARIAL)
         for tok in port_registry.get(f, "cuda").supported_precisions]
IDS = [f"{f}-{c}-{t}" for f, c, t in CASES]

#: The packed fields each layout holds (those a kernel reads and the
#: derived work lists), compared bit for bit.
FIELDS = ("tile_ids", "visit_tiles", "chunk_len", "piece_ptr", "piece_owner",
          "piece_split", "split_tiles", "chunk_visits", "chunk_slabs",
          "row_map", "cols", "slots", "vals", "last_slot", "shared",
          "carry_rows", "carry_chunks", "empty_rows", "band", "offsets",
          "diags")
STATICS = ("n", "b_tile", "row_tile", "window", "w", "t")


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return host_values(x)
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _bridge(m):
    return interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                  m.meta)


def _layouts(fmt_name: str, case: str, token: str, d: int = 8):
    m = ADVERSARIAL[case]
    ref_ctx = ref_registry.KernelContext(precision=ref_precision(token),
                                         plan_d=d)
    ref = ref_registry.get(fmt_name, "pallas").prepare(m, ref_ctx)
    if isinstance(ref, dict) and "arrays" in ref:
        ref = dict(ref, arrays=tuple(np.asarray(a) for a in ref["arrays"]))
    ctx = port_registry.KernelContext(precision=as_precision(token),
                                      plan_d=d, device=torch.device("cpu"))
    port = port_registry.get(fmt_name, "cuda").prepare(_bridge(m), ctx)
    return m, ref, port, ctx


@pytest.mark.parametrize("fmt_name,case,token", CASES, ids=IDS)
def test_adversarial_layout_equals_reference(fmt_name, case, token):
    _, ref, port, _ = _layouts(fmt_name, case, token)
    bridged = interop.layout_from_numpy(fmt_name, ref, device="cpu")
    assert type(bridged) is type(port)
    seen = 0
    for f in FIELDS:
        if not hasattr(port, f):
            continue
        r, p = _bits(getattr(bridged, f)), _bits(getattr(port, f))
        assert r.dtype == p.dtype and r.shape == p.shape, f
        assert np.array_equal(r, p), f"{fmt_name} {case} {token}: {f}"
        seen += 1
    if fmt_name == "dia":
        # The port packs no band: its diagonals, re-expanded at the
        # reference's block edge, are the reference's band.
        band, w = port_registry.band_to_blocks(
            host_values(port.diags), port.offsets.tolist(), n=port.n,
            t=int(ref["t"]))
        assert w == int(ref["w"])
        assert np.array_equal(_bits(band), _bits(ref["band"])), \
            f"{fmt_name} {case} {token}: band"
        seen += 1
    assert seen >= 3
    for f in STATICS:
        if hasattr(port, f):
            assert getattr(bridged, f) == getattr(port, f), f


def _oracle(fmt_name, m, ref, b, prec):
    bj = jnp.asarray(b).astype(prec.value_jnp)
    if fmt_name == "dia":
        return ref_oracle.banded_ref(ref["band"], bj, t=ref["t"],
                                     w=ref["w"])
    csr = ref_fmt.coo_to_csr(m, prec.value_jnp)
    return ref_oracle.csr_ref(csr.indptr, csr.indices, csr.data, bj, n=m.n)


@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("fmt_name,case,token", CASES, ids=IDS)
def test_adversarial_plain_version_matches_oracle(fmt_name, case, token, d):
    m, ref, port, ctx = _layouts(fmt_name, case, token, d)
    prec = ref_precision(token)
    b = np.random.default_rng(d).normal(size=(m.n, d)).astype(np.float32)
    want = np.asarray(_oracle(fmt_name, m, ref, b, prec), np.float64)
    got_t = port_registry.get(fmt_name, "cuda").run(
        port, torch.from_numpy(b), ctx)
    dtype = torch.bfloat16 if prec.reduced else torch.float32
    assert got_t.dtype == dtype and tuple(got_t.shape) == (m.n, d)
    got = got_t.to(torch.float32).numpy().astype(np.float64)
    dense = np.asarray(ref_fmt.coo_to_dense(m), np.float64)
    absprod = 4.0 * prec.eps * (np.abs(dense) @ np.abs(b.astype(np.float64)))
    bound = 2 * (absprod + ATOL) + RTOL * (np.abs(got) + np.abs(want))
    assert np.isfinite(got).all()
    err = np.abs(got - want)
    assert np.all(err <= bound), (
        f"{fmt_name} {case} {token} d={d}: exceeds the bound by "
        f"{float(np.max(err - bound)):.3e}")


CANDIDATE_FIELDS = ("format", "precision", "eligible", "skip_reason", "ai",
                    "useful_fraction", "predicted_gflops",
                    "amortized_gflops", "conversion_bytes",
                    "ceiling_source")


@pytest.mark.parametrize("tolerance", [0.0, 1e-2])
@pytest.mark.parametrize("d", [1, 8])
@pytest.mark.parametrize("case", sorted(ADVERSARIAL))
def test_adversarial_plan_equals_reference(case, d, tolerance):
    m = ADVERSARIAL[case]
    ref = RefDispatcher(ref_hw.HOST_CPU, backend="pallas",
                        calibration=False, tree=False).plan(
        m, d, reuse=8, tolerance=tolerance)
    port = Dispatcher(port_hw.HOST_CPU, backend="cuda", device="cpu",
                      calibration=False, tree=False).plan(
        _bridge(m), d, reuse=8, tolerance=tolerance)
    assert (port.chosen, port.precision, port.regime) == \
        (ref.chosen, ref.precision, ref.regime)
    assert len(port.candidates) == len(ref.candidates)
    for pc, rc in zip(port.candidates, ref.candidates):
        for f in CANDIDATE_FIELDS:
            assert getattr(pc, f) == getattr(rc, f), (case, pc.format, f)
