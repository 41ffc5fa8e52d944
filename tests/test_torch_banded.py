"""The banded kernel's diagonals against the reference's band.

The port packs the k stored diagonals that the CUDA kernel walks straight
from DIA storage; a layout bridged from the reference derives them from
its block-band tensor with ``band_diagonals``.  Held here on the CPU:
re-expanding derived diagonals with ``band_to_blocks`` gives the band back
byte for byte (bf16 compared as its 16-bit patterns), zero and ``-0.0``
entries come out as the band stores them, k stays within the kernel's 64,
the walk ``C[r] = sum_j diags[j, r] * B[r + offsets[j]]`` in numpy equals
the plain version and A @ B within ``4 * eps * (|A| @ |B|) + 5e-4 + 5e-4 *
|C|``, and a layout bridged from the reference carries the same diagonals
as the one the port prepares, which re-expand to the reference's band.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import patterns as ref_patterns
from repro.core.precision import as_precision as ref_precision
from repro.data.corpus import vendored_entries
from repro.kernels import registry as ref_registry
from repro.sparse import formats as ref_fmt

from repro_torch import interop
from repro_torch.core.precision import as_precision
from repro_torch.kernels import registry as port_registry
from repro_torch.kernels.banded_spmm import (MAX_DIAGONALS, band_diagonals,
                                             banded_spmm_plain)
from repro_torch.sparse import formats as port_fmt

N = 256
ATOL = RTOL = 5e-4


def _matrices():
    out = [(f"corpus:{e.group}/{e.name}", e.load())
           for e in vendored_entries()]
    out += [(f"suite:{name}", gen())
            for name, gen in ref_patterns.serving_suite(N).items()]
    out += [(f"banded:n={n}", ref_patterns.banded(n, 3, fill=0.9, seed=n))
            for n in (63, 66, 68, 1024)]
    return out


MATRICES = _matrices()
IDS = [name for name, _ in MATRICES]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _ref_dia(m, value):
    dt = jnp.float32 if value == "f32" else jnp.bfloat16
    try:
        dia = ref_fmt.coo_to_dia(m, dt)
    except ValueError:           # more diagonals than DIA takes
        return None
    return _bits(dia.data), dia.offsets


def _assert_reexpands(band, w, t, what):
    """``band_to_blocks`` of the derived diagonals is ``band``, byte for
    byte; a dropped all-zero outer block diagonal must be all zero.  The
    diagonals span the band's nb * t rows (n rounded up to t)."""
    n = band.shape[0] * t
    offsets, diags = band_diagonals(band, w, t)
    assert offsets.dtype == np.int32 and diags.dtype == band.dtype
    assert diags.shape == (offsets.shape[0], n)
    assert np.all(np.diff(offsets) > 0), what
    again, w2 = port_registry.band_to_blocks(diags, offsets, n=n, t=t)
    assert w2 <= w, what
    inner = band[:, w - w2:w + w2 + 1]
    assert again.dtype == band.dtype and again.shape == inner.shape, what
    assert np.array_equal(_bits(again), _bits(inner)), f"{what}: bytes"
    outer = np.concatenate([band[:, :w - w2], band[:, w + w2 + 1:]], axis=1)
    assert not np.any(_bits(outer)), f"{what}: dropped a stored slot"
    return offsets, diags


@pytest.mark.parametrize("value", ["f32", "bf16"])
@pytest.mark.parametrize("name,m", MATRICES, ids=IDS)
def test_band_diagonals_reexpand_to_the_band(name, m, value):
    ref = _ref_dia(m, value)
    if ref is None:
        return
    data, offs = ref
    for t in sorted({1, 4, ref_registry.pallas_band_tile(m.n)}):
        band, w = ref_registry.band_to_blocks(data, offs, n=m.n, t=t)
        band = _bits(band)
        offsets, _ = _assert_reexpands(band, w, t,
                                       f"{name}/{value} t={t}")
        # Exactly the offsets that hold a nonzero value.
        nz = (data & 0x7FFF) != 0 if value == "bf16" else data != 0
        assert offsets.tolist() == [o for o, row in zip(offs, nz)
                                    if row.any()]


@pytest.mark.parametrize("value", ["f32", "bf16"])
@pytest.mark.parametrize("t", [1, 2, 4, 8])
def test_band_diagonals_handle_zero_and_negative_zero(value, t):
    """An all-zero diagonal and an all ``-0.0`` one are dropped (the band
    stores nothing for them); a ``-0.0`` inside a kept diagonal comes back
    as the band's +0.0."""
    n = 8 * t
    offsets = (-2, 0, 1, 3)
    data = np.random.default_rng(t).normal(size=(4, n)).astype(np.float32)
    data[2] = 0.0                 # explicitly zero diagonal
    data[3] = -0.0                # a diagonal of -0.0
    data[1, 5] = -0.0             # one -0.0 on the main diagonal
    if value == "bf16":
        data = torch.from_numpy(data).to(torch.bfloat16).view(
            torch.int16).numpy().view(np.uint16)
    band, w = port_registry.band_to_blocks(data, offsets, n=n, t=t)
    got, diags = _assert_reexpands(band, w, t, f"{value} t={t}")
    assert got.tolist() == [-2, 0]
    assert _bits(diags)[1, 5] == 0          # +0.0, as the band stores it
    # A -0.0 stored in a band that was not built from DIA keeps its slot.
    band2 = band.copy()
    r = 2 * t + 1 if t > 1 else 3
    neg = np.array([0x8000], np.uint16) if value == "bf16" else \
        np.array([-0.0], np.float32)
    band2[r // t, w, r % t, r % t] = neg[0] if value == "bf16" else -0.0
    got2, diags2 = band_diagonals(band2, w, t)
    assert 0 in got2.tolist()
    j = got2.tolist().index(0)
    assert _bits(diags2)[j, r] == _bits(neg)[0]


@pytest.mark.parametrize("n,offsets", [
    (256, tuple(range(-31, 32))),               # 63 diagonals
    (256, tuple(range(-40, 24))),               # 64, the DIA cap
    (300, (-200, -3, 0, 5, 150)),               # far apart
])
def test_band_diagonals_stay_within_the_kernels_limit(n, offsets):
    rng = np.random.default_rng(len(offsets))
    data = rng.normal(size=(len(offsets), n)).astype(np.float32)
    r = np.arange(n)
    for i, o in enumerate(offsets):        # zero where r + o leaves [0, n)
        data[i, (r + o < 0) | (r + o >= n)] = 0.0
    t = port_registry.pallas_band_tile(n)
    band, w = port_registry.band_to_blocks(data, offsets, n=n, t=t)
    got, diags = _assert_reexpands(band, w, t, f"k={len(offsets)}")
    assert got.tolist() == list(offsets)
    assert len(got) <= MAX_DIAGONALS
    assert np.array_equal(diags, data)


@pytest.mark.parametrize("value", ["f32", "bf16"])
@pytest.mark.parametrize("name,m", MATRICES, ids=IDS)
def test_diagonal_walk_equals_plain_version(name, m, value):
    """The kernel's arithmetic, in numpy over the packed diagonals,
    against the plain version's shifted slices and against A @ B."""
    pm = interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                m.meta)
    prec = "f32i32" if value == "f32" else "bf16i32"
    ctx = port_registry.KernelContext(device=torch.device("cpu"), plan_d=8,
                                      precision=as_precision(prec))
    try:
        layout = port_registry.get("dia", "cuda").prepare(pm, ctx)
    except ValueError:
        return
    dtype = layout.diags.dtype
    b = torch.from_numpy(np.random.default_rng(1).normal(
        size=(m.n, 8)).astype(np.float32)).to(dtype)
    plain = banded_spmm_plain(layout, b).double().numpy()
    diags = layout.diags.double().numpy()
    bd = b.double().numpy()
    walk = np.zeros_like(plain)
    r = np.arange(m.n)
    for j, off in enumerate(layout.offsets.tolist()):
        src = r + off
        ok = (src >= 0) & (src < m.n)
        walk[r[ok]] += diags[j, r[ok], None] * bd[src[ok]]
    walk = torch.from_numpy(walk).to(dtype).double().numpy()
    eps = float(torch.finfo(dtype).eps)
    dense = np.zeros((m.n, m.n))
    np.add.at(dense, (m.rows, m.cols), np.abs(m.vals))
    bound = 2 * (4 * eps * (dense @ np.abs(bd)) + ATOL) + RTOL * (
        np.abs(walk) + np.abs(plain))
    assert np.all(np.abs(walk - plain) <= bound), name
    signed = np.zeros((m.n, m.n))
    np.add.at(signed, (m.rows, m.cols), m.vals.astype(np.float32)
              if value == "f32" else
              torch.from_numpy(m.vals).to(dtype).double().numpy())
    exact = signed @ bd
    bound = 2 * (4 * eps * (dense @ np.abs(bd)) + ATOL) + RTOL * (
        np.abs(exact) + np.abs(plain))
    assert np.all(np.abs(exact - plain) <= bound), name


@pytest.mark.parametrize("value", ["f32", "bf16"])
@pytest.mark.parametrize("n", [63, 66, 68, 256, 1024])
def test_bridged_and_prepared_layouts_carry_the_same_diagonals(n, value):
    m = ref_patterns.banded(n, 3, fill=0.9, seed=n + 1)
    prec = "f32i32" if value == "f32" else "bf16i32"
    ref_layout = ref_registry.get("dia", "pallas").prepare(
        m, ref_registry.KernelContext(plan_d=8,
                                      precision=ref_precision(prec)))
    bridged = interop.layout_from_numpy(
        "dia", {k: np.asarray(v) if hasattr(v, "shape") else v
                for k, v in ref_layout.items()}, device="cpu")
    pm = interop.coo_from_numpy(m.n, m.rows, m.cols, m.vals, m.pattern,
                                m.meta)
    own = port_registry.get("dia", "cuda").prepare(
        pm, port_registry.KernelContext(device=torch.device("cpu"),
                                        plan_d=8,
                                        precision=as_precision(prec)))
    assert own.offsets.device.type == "cpu"
    assert own.offsets.dtype == torch.int32
    assert bridged.n == own.n == m.n
    for field in ("offsets", "diags"):
        a, b = getattr(bridged, field), getattr(own, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(port_fmt.host_values(a),
                              port_fmt.host_values(b)), field
    # The port packs no band; its diagonals re-expand to the reference's.
    band, w = port_registry.band_to_blocks(
        port_fmt.host_values(own.diags), own.offsets.tolist(), n=m.n,
        t=int(ref_layout["t"]))
    assert w == int(ref_layout["w"])
    assert np.array_equal(_bits(band), _bits(ref_layout["band"]))
