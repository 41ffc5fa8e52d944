"""Kernel registry: every SpMM kernel of the port behind one ``KernelSpec``.

Each ``(format, backend)`` pair registers a :class:`KernelSpec` bundling

  * ``prepare(m, ctx)`` — one-time host-side layout prep (format
    conversion, row-tile chunking, empty-row padding),
    with the result on ``ctx.device``;
  * ``run(layout, b, ctx)`` — the per-call launch;
  * ``estimate(m, d, ctx)`` — the sparsity-aware roofline placement;
  * ``footprint(n, d, ctx)`` — the modeled working set of one block of
    work in bytes (the reference's VMEM model, same values).

Backends are ``"torch"`` (the plain PyTorch implementations of
``repro_torch.sparse.spmm``, the reference's ``"jax"``) and ``"cuda"``
(the hand-written Hopper kernels, the reference's ``"pallas"``).  The
``"cuda"`` specs call the kernel wrappers, which launch the CUDA kernel
for a CUDA operand and take the plain PyTorch version for a CPU one.

``cuda`` has a kernel for every format: csr, ell and ell_coo (all three
on the CSR kernel, sharing its row-tile packing), binned, rowsplit, bcsr
and dia.  ``("grouped", "cuda")`` is the MoE expert FFN as a grouped
matmul; its operand is ``(w, group_ids, bm, bk, bn)``, not a sparse
pattern (``KernelSpec.operand == "moe"``).

The slab sizing reads ``ctx.hardware.vmem_bytes``, which on the H100 is
the 50 MB L2 (see ``repro_torch.core.hardware``).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import sparsity_models as sm
from repro_torch.core.device import device_of
from repro_torch.core.hardware import H100, HOST_CPU, HardwareSpec
from repro_torch.core.precision import DEFAULT_PRECISION, Precision
from repro_torch.kernels import banded_spmm as banded_module
from repro_torch.kernels.banded_spmm import banded_spmm, dia_layout
from repro_torch.kernels.bcsr_spmm import bcsr_spmm, with_quadrants
from repro_torch.kernels.binned_spmm import (
    binned_spmm, csr_to_slab_bins, slab_bin_layout)
from repro_torch.kernels.csr_spmm import (
    csr_spmm, csr_to_row_tiles, row_tile_layout)
from repro_torch.kernels.grouped_matmul import check_group_ids, grouped_matmul
from repro_torch.kernels.rowsplit_spmm import (
    pack_rowsplit_chunks, rowsplit_layout, rowsplit_spmm)

BACKENDS: Tuple[str, ...] = ("torch", "cuda")

#: Version of the port's kernel set and layout rules; stamped into saved
#: calibrations so a stale one is flagged.  1 = the first CUDA kernels,
#: 2 = the row-split and grouped-matmul kernels, 3 = the work-piece walk of
#: CSR and binned, with binned's fold in the kernel, 4 = the banded
#: kernel's diagonal walk and the bf16 grouped matmul on wgmma + TMA, 5 =
#: row-split's fold in the kernel and the fp32 grouped matmul as a
#: register-tiled SGEMM, 6 = the BCSR kernel's t = 64 variants (a block
#: ring across block rows: register-tiled fp32, TMA + wgmma at bf16).
REGISTRY_VERSION: int = 6


def pallas_block_d(d: int) -> int:
    """Largest d-tile (<= 512) dividing d: the width the slab budget is
    charged for (the reference's name and values)."""
    for bd in (512, 256, 128, 64, 32, 16, 8, 4, 2):
        if d % bd == 0:
            return bd
    return 1


def pallas_band_tile(n: int) -> int:
    """Largest tile edge in {128, ..., 2, 1} dividing n (banded layout)."""
    for t in (128, 64, 32, 16, 8, 4, 2):
        if n % t == 0:
            return t
    return 1


def choose_b_tile(n: int, vmem_bytes: int, *, bd: int = 512,
                  sizeof_val: int = 4) -> Optional[int]:
    """B row-slab size for the row-tiled kernels, from the cache budget.

    Half the budget goes to the B slab.  Returns ``None`` when all of B
    fits (one slab, global column ids); otherwise a multiple of 8 rows.
    """
    if vmem_bytes <= 0:
        return None
    slab_rows = (vmem_bytes // 2) // (bd * sizeof_val)
    if slab_rows >= n:
        return None
    return max(8, int(slab_rows) // 8 * 8)


@dataclasses.dataclass(frozen=True)
class KernelContext:
    """Knobs a :class:`KernelSpec` needs to prepare and launch.

    Attributes:
        hardware: ceilings of the target device; ``vmem_bytes`` sizes the
            B slab of the row-tiled layouts and the footprints.
        bcsr_block: BCSR block edge t.
        max_dia_offsets: DIA conversion cap (mirrors the dispatch policy).
        row_tile: rows per C tile of the row-tiled layouts.
        chunk: nonzeros per packed chunk.
        b_tile: explicit B row-slab override; None sizes it from
            ``hardware.vmem_bytes`` (``choose_b_tile``).
        plan_d: the dense width the plan was made for, when known (sizes
            the slab for the actual d-tile instead of the widest, 512).
        precision: value/index storage dtypes of the layouts.
        convert: optional ``(m, format) -> container`` hook (the
            dispatcher's conversion cache, bound to ``precision``).
        device: where prepared layouts live (None: the CPU).
    """

    hardware: HardwareSpec = HOST_CPU
    bcsr_block: int = 64
    max_dia_offsets: int = 64
    row_tile: int = 8
    chunk: int = 128
    b_tile: Optional[int] = None
    plan_d: Optional[int] = None
    precision: Precision = DEFAULT_PRECISION
    convert: Optional[Callable[[Any, str], Any]] = None
    device: Optional[torch.device] = None

    def resolve_b_tile(self, n: int) -> Optional[int]:
        """The row-tiled layouts' slab size for an ``[n, n]`` matrix,
        charged at the operand's element size."""
        if self.b_tile is not None:
            return self.b_tile if self.b_tile < n else None
        bd = 512 if self.plan_d is None else min(512,
                                                 pallas_block_d(self.plan_d))
        return choose_b_tile(n, self.hardware.vmem_bytes, bd=bd,
                             sizeof_val=self.precision.sizeof_val)


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered kernel: layout prep, launch, estimate, footprint."""

    format: str
    backend: str                 # "torch" | "cuda"
    description: str
    prepare: Callable[[Any, KernelContext], Any]
    run: Callable[[Any, torch.Tensor, KernelContext], torch.Tensor]
    estimate: Callable[[Any, int, KernelContext], "KernelRoofline"]
    footprint: Callable[[int, int, KernelContext], int]
    #: Specs producing identical prepared layouts share this key.
    layout_key: Optional[str] = None
    #: ``run`` enqueues the work and returns before it completes (true of
    #: every CUDA launch and of PyTorch ops on a CUDA tensor).
    async_dispatch: bool = True
    #: The launch may reuse B's buffer for its output (none does).
    donate_b: bool = False
    #: What ``prepare``/``bind`` take as the matrix operand: ``"coo"`` (a
    #: ``COOMatrix``, computing ``C = A @ B``) or ``"moe"`` (the grouped
    #: matmul's ``(w, group_ids, bm, bk, bn)``).
    operand: str = "coo"
    #: Precision tokens (``Precision.token``) this kernel can execute.
    supported_precisions: Tuple[str, ...] = ("f32i32",)

    def supports_precision(self, precision: Precision) -> bool:
        """True iff this kernel can execute at ``precision``."""
        return precision.token in self.supported_precisions

    @property
    def key(self) -> Tuple[str, str]:
        """The registry key, ``(format, backend)``."""
        return (self.format, self.backend)

    @property
    def layout_cache_key(self) -> Tuple[str, str]:
        """Cache identity of ``prepare``'s output, ``(layout, backend)``."""
        return (self.layout_key or self.format, self.backend)

    def bind(self, m, ctx: KernelContext
             ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Prepare the layout for ``m`` once and return ``run(b) -> c``."""
        layout = self.prepare(m, ctx)
        return lambda b: self.run(layout, b, ctx)


_REGISTRY: Dict[Tuple[str, str], KernelSpec] = {}


def register(spec: KernelSpec) -> KernelSpec:
    """Add ``spec`` under ``(spec.format, spec.backend)``; reject dupes."""
    if spec.key in _REGISTRY:
        raise ValueError(f"kernel {spec.key} already registered")
    _REGISTRY[spec.key] = spec
    return spec


def get(format: str, backend: str) -> KernelSpec:
    """Resolve the spec for ``(format, backend)``.

    Raises:
        KeyError: when the pair is unregistered; the message lists what is.
    """
    try:
        return _REGISTRY[(format, backend)]
    except KeyError:
        raise KeyError(
            f"no kernel registered for format={format!r} "
            f"backend={backend!r}; available: {sorted(_REGISTRY)}") from None


def spmm(m, b: torch.Tensor, *, format: str, backend: str = "cuda",
         ctx: Optional[KernelContext] = None) -> torch.Tensor:
    """One-call registry entry point: prepare + run in one shot.

    The ``cuda`` backend launches the kernel for a CUDA ``b`` and takes
    the plain version for a CPU one.  For repeated execution against one
    matrix, use ``repro_torch.sparse.dispatch`` (cached layouts) or
    ``spec.bind``.
    """
    if ctx is None:
        ctx = KernelContext(device=b.device)
    return get(format, backend).bind(m, ctx)(b)


def specs() -> Tuple[KernelSpec, ...]:
    """All registered specs, sorted by (format, backend)."""
    return tuple(_REGISTRY[k] for k in sorted(_REGISTRY))


def formats_for(backend: str) -> Tuple[str, ...]:
    """Formats with a kernel registered under ``backend``."""
    return tuple(sorted(f for f, b in _REGISTRY if b == backend))


def feature_matrix() -> Dict[Tuple[str, str], str]:
    """(format, backend) -> one-line description, for docs and tests."""
    return {k: _REGISTRY[k].description for k in sorted(_REGISTRY)}


# ------------------------------------------------------------------ #
# Layout helpers (host-side)
# ------------------------------------------------------------------ #

def pad_empty_block_rows(a):
    """Ensure every block row owns >= 1 block (zero block on the diagonal).

    Same arrays as the reference's: the padded blocks are appended, then
    every block is stably re-sorted by block row.
    """
    from repro_torch.sparse.formats import BCSRMatrix, to_device
    nb = a.nb
    present = np.zeros(nb, dtype=bool)
    rows_np = a.block_rows.cpu().numpy()
    present[rows_np] = True
    missing = np.nonzero(~present)[0].astype(np.int32)
    if missing.size == 0:
        return a
    dev = a.blocks.device
    blocks = torch.cat([a.blocks, torch.zeros(
        (missing.size, a.t, a.t), dtype=a.blocks.dtype, device=dev)])
    rows = np.concatenate([rows_np, missing])
    cols = np.concatenate([a.block_cols.cpu().numpy(), missing])
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=nb)
    ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return BCSRMatrix(
        blocks=blocks[to_device(torch.from_numpy(order), dev)],
        block_rows=to_device(torch.from_numpy(rows[order].astype(np.int32)),
                             dev),
        block_cols=to_device(torch.from_numpy(cols[order].astype(np.int32)),
                             dev),
        block_ptr=to_device(torch.from_numpy(ptr), dev),
        n=a.n, t=a.t, nnz=a.nnz)


def band_to_blocks(dia_data: np.ndarray, offsets, *, n: int, t: int
                   ) -> Tuple[np.ndarray, int]:
    """Convert DIA storage to the banded kernel's block-band tensor.

    Args:
        dia_data: DIA values, ``[num_offsets, n]`` indexed by row (float32,
            or bf16 as ``uint16`` bits).
        offsets: diagonal offsets matching ``dia_data`` rows.
        n: matrix dimension.
        t: block edge of the band tensor.

    Returns:
        ``(band, w)``: numpy band ``[nb, 2w+1, t, t]`` in ``dia_data``'s
        dtype and the block half-bandwidth w, byte-identical to the
        reference's (vectorised per offset instead of per row).
    """
    dia = np.asarray(dia_data)
    nb = (n + t - 1) // t
    max_off = max(abs(int(o)) for o in offsets) if len(offsets) else 0
    w = (max_off + t - 1) // t
    band = np.zeros((nb, 2 * w + 1, t, t), dtype=dia.dtype)
    # Entries equal to zero are skipped (as the reference skips them), so
    # a stored -0.0 leaves +0.0 in the band.
    as_float = ((dia.astype(np.uint32) << 16).view(np.float32)
                if dia.dtype == np.uint16 else dia)
    r = np.arange(n, dtype=np.int64)
    for oi, off in enumerate(offsets):
        c = r + int(off)
        keep = (c >= 0) & (c < n) & (as_float[oi] != 0)
        rr, cc = r[keep], c[keep]
        bi, bj = rr // t, cc // t
        band[bi, bj - bi + w, rr % t, cc % t] = dia[oi, rr]
    return band, w


# ------------------------------------------------------------------ #
# Roofline estimates
# ------------------------------------------------------------------ #

@dataclasses.dataclass(frozen=True)
class KernelRoofline:
    """Sparsity-aware placement of one kernel launch on a roofline."""

    name: str
    ai: float
    useful_flops: float
    mxu_flops: float
    attainable_flops_per_s: float
    mxu_utilization: float


def csr_kernel_roofline(a, d: int, *, regime: str = "random",
                        hw: HardwareSpec = H100) -> KernelRoofline:
    """Place a CSR kernel launch on the roofline under its regime model.

    ``a`` is a CSR container (``n``, ``nnz`` and ``data``, whose element
    size is the model's ``sizeof_val``); ``regime`` names a model of
    ``sparsity_models.arithmetic_intensity`` that needs no argument beyond
    ``sizeof_val`` (``"blocked"`` needs the block shape and raises).  The
    kernel issues exactly the useful FLOPs (padding slots multiply zeros),
    so utilization is 1.0; what varies with structure is the B-traffic
    term of the AI.  The ``mxu_*`` names are kept for parity with the
    reference: on the card the CSR kernel runs on the CUDA cores.
    """
    tb = sm.arithmetic_intensity(regime, a.n, a.nnz, d,
                                 sizeof_val=a.data.dtype.itemsize)
    return KernelRoofline(
        name="csr_spmm", ai=tb.ai, useful_flops=tb.flops,
        mxu_flops=tb.flops,
        attainable_flops_per_s=hw.attainable(tb.ai),
        mxu_utilization=1.0)


def bcsr_kernel_roofline(a, d: int,
                         hw: HardwareSpec = H100) -> KernelRoofline:
    """Place a BCSR kernel launch on the blocked model
    (``sparsity_models.ai_blocked_tpu``): each stored t x t block and its
    t x d B tile moved once, C written once.

    ``mxu_flops`` (2 d t^2 N) are the products the kernel issues over the
    dense blocks and ``mxu_utilization`` the useful share of them.  The
    names are kept for parity with the reference: on the card they count
    the tensor cores' work for the ``wgmma_bf16`` variant and the CUDA
    cores' otherwise.
    """
    tb = sm.ai_blocked_tpu(a.n, a.nnz, d, t=a.t, num_blocks=a.num_blocks,
                           sizeof_val=a.blocks.dtype.itemsize)
    util = sm.mxu_utilization(a.nnz, a.t, a.num_blocks)
    return KernelRoofline(
        name="bcsr_spmm", ai=tb.ai, useful_flops=tb.flops,
        mxu_flops=2.0 * d * a.t * a.t * a.num_blocks,
        attainable_flops_per_s=hw.attainable(tb.ai),
        mxu_utilization=util)


def dia_kernel_roofline(m, d: int, hw: HardwareSpec) -> KernelRoofline:
    """Diagonal-regime placement: B streamed once, k full diagonals issued."""
    k = max(int(np.unique(m.cols.astype(np.int64) - m.rows).shape[0]), 1)
    tb = sm.arithmetic_intensity("diagonal", m.n, m.nnz, d)
    return KernelRoofline(
        name="banded_spmm", ai=tb.ai, useful_flops=tb.flops,
        mxu_flops=2.0 * d * k * m.n,
        attainable_flops_per_s=hw.attainable(tb.ai),
        mxu_utilization=m.nnz / float(k * m.n))


def grouped_matmul_roofline(T: int, K: int, N: int, E: int, *,
                            itemsize: int = 2,
                            hw: HardwareSpec = H100) -> KernelRoofline:
    """Block-diagonal case: every block dense, so every issued FLOP is
    useful (utilization 1.0)."""
    flops = 2.0 * T * K * N
    bytes_moved = itemsize * (T * K + E * K * N + T * N)
    ai = flops / bytes_moved
    return KernelRoofline(
        name="grouped_matmul", ai=ai, useful_flops=flops, mxu_flops=flops,
        attainable_flops_per_s=hw.attainable(ai), mxu_utilization=1.0)


def _convert(ctx: KernelContext, m, format: str):
    """Convert ``m`` to ``format``'s container on ``ctx.device``, through
    ``ctx.convert`` when given."""
    if ctx.convert is not None:
        return ctx.convert(m, format)
    from repro_torch.sparse import formats as fmt
    dtype, dev = ctx.precision.value_torch, ctx.device
    if format == "csr":
        return fmt.coo_to_csr(m, dtype=dtype, device=dev)
    if format == "ell":
        return fmt.coo_to_ell(m, dtype=dtype, device=dev)
    if format == "bcsr":
        return fmt.coo_to_bcsr(m, ctx.bcsr_block, dtype=dtype, device=dev)
    if format == "dia":
        return fmt.coo_to_dia(m, dtype=dtype,
                              max_offsets=ctx.max_dia_offsets, device=dev)
    if format == "binned":
        return fmt.coo_to_binned(m, dtype=dtype, device=dev)
    if format == "rowsplit":
        return fmt.coo_to_rowsplit(m, dtype=dtype, chunk=ctx.chunk,
                                   device=dev)
    if format == "ell_coo":
        return fmt.coo_to_ell_coo(m, dtype=dtype, device=dev)
    raise ValueError(f"unknown format {format!r}")


def binned_layout_stats(m, *, slab_rows: int,
                        row_tile: int = 8) -> Tuple[int, int]:
    """(slabs_touched, num_visits) of the slab-binned layout for ``m``."""
    if m.nnz == 0:
        return 1, 1
    slabs = np.asarray(m.cols, dtype=np.int64) // slab_rows
    tiles = np.asarray(m.rows, dtype=np.int64) // row_tile
    num_slabs = max(1, -(-m.n // slab_rows))
    visits = _count_distinct(tiles * num_slabs + slabs,
                             num_slabs * (-(-m.n // row_tile)))
    return _count_distinct(slabs, num_slabs), visits


def _count_distinct(keys: np.ndarray, extent: int) -> int:
    """``np.unique(keys).size`` for keys in ``[0, extent)``; a bitmap when
    the extent is small enough, a sort otherwise."""
    if extent <= max(1 << 26, 4 * keys.size):
        seen = np.zeros(extent, dtype=bool)
        seen[keys] = True
        return int(np.count_nonzero(seen))
    return int(np.unique(keys).shape[0])


def rowsplit_window_model(n_nonempty: int, nnz: int,
                          chunk: int = 128) -> int:
    """Expected row-window width of the row-split packing (model side)."""
    if nnz <= 0 or n_nonempty <= 0:
        return 8
    span = min(chunk, -(-n_nonempty * chunk // nnz) + 1)
    return max(8, -(-span // 8) * 8)


def ell_coo_split_stats(m) -> Tuple[int, int]:
    """(k_cut, tail_nnz) of the hybrid ELL/COO layout for ``m``."""
    from repro_torch.sparse import formats as fmt
    if m.nnz == 0:
        return 1, 0
    deg = np.bincount(np.asarray(m.rows), minlength=m.n)
    k_cut = fmt.ell_coo_cutoff(deg)
    return k_cut, int(np.maximum(deg - k_cut, 0).sum())


# ------------------------------------------------------------------ #
# "torch" specs: the plain PyTorch implementations
# ------------------------------------------------------------------ #

def _torch_prepare(format: str):
    def prepare(m, ctx: KernelContext):
        return _convert(ctx, m, format)
    return prepare


def _torch_run(format: str):
    def run(layout, b, ctx: KernelContext):
        # Module path, not attribute access: repro_torch.sparse keeps its
        # ``spmm`` attribute the submodule, but importlib is unambiguous.
        impl = importlib.import_module("repro_torch.sparse.spmm")
        if ctx.precision.reduced:
            b = b.to(ctx.precision.value_torch)
        return impl.IMPLEMENTATIONS[format](layout, b)
    return run


def _torch_estimate(format: str):
    regime = {"csr": "random", "ell": "random", "dia": "diagonal"}

    def estimate(m, d, ctx: KernelContext) -> KernelRoofline:
        if format == "bcsr":
            roof = _bcsr_estimate(m, d, ctx)
            return dataclasses.replace(roof, name="bcsr_spmm_torch")
        tb = sm.arithmetic_intensity(regime[format], m.n, m.nnz, d)
        return KernelRoofline(
            name=f"{format}_spmm_torch", ai=tb.ai, useful_flops=tb.flops,
            mxu_flops=tb.flops,
            attainable_flops_per_s=ctx.hardware.attainable(tb.ai),
            mxu_utilization=1.0)
    return estimate


def _zero_footprint(n: int, d: int, ctx: KernelContext) -> int:
    return 0


#: The torch containers keep int32 global indices, so the torch specs add
#: bf16 values but not compact indices; the CUDA row-tiled packers store
#: slab-local indices and add int16.
_TORCH_PRECISIONS = ("f32i32", "bf16i32")
_CUDA_STREAM_PRECISIONS = ("f32i32", "bf16i32", "bf16i16")

for _f, _desc in (("csr", "gather + index_add_ segment sum (PyTorch)"),
                  ("ell", "padded slot scan (PyTorch)"),
                  ("bcsr", "batched dense-block bmm (PyTorch)"),
                  ("dia", "static shifted axpy (PyTorch)")):
    register(KernelSpec(
        format=_f, backend="torch", description=_desc,
        prepare=_torch_prepare(_f), run=_torch_run(_f),
        estimate=_torch_estimate(_f), footprint=_zero_footprint,
        supported_precisions=_TORCH_PRECISIONS))


def _binned_estimate(name: str, resolve_slab):
    def estimate(m, d, ctx: KernelContext) -> KernelRoofline:
        slab = resolve_slab(m, ctx)
        touched, visits = binned_layout_stats(m, slab_rows=slab,
                                              row_tile=ctx.row_tile)
        tb = sm.ai_binned(m.n, m.nnz, d, slab_rows=slab,
                          slabs_touched=touched, num_visits=visits,
                          row_tile=ctx.row_tile)
        return KernelRoofline(
            name=name, ai=tb.ai, useful_flops=tb.flops, mxu_flops=tb.flops,
            attainable_flops_per_s=ctx.hardware.attainable(tb.ai),
            mxu_utilization=1.0)
    return estimate


def _torch_slab(m, ctx: KernelContext) -> int:
    from repro_torch.sparse import formats as fmt
    return fmt.default_slab_rows(m.n)


def _cuda_slab(m, ctx: KernelContext) -> int:
    return ctx.resolve_b_tile(m.n) or m.n


def _rowsplit_estimate(name: str):
    def estimate(m, d, ctx: KernelContext) -> KernelRoofline:
        n_nonempty = int(np.unique(np.asarray(m.rows)).shape[0])
        window = rowsplit_window_model(n_nonempty, m.nnz, ctx.chunk)
        tb = sm.ai_rowsplit(m.n, m.nnz, d, window=window, chunk=ctx.chunk)
        return KernelRoofline(
            name=name, ai=tb.ai, useful_flops=tb.flops, mxu_flops=tb.flops,
            attainable_flops_per_s=ctx.hardware.attainable(tb.ai),
            mxu_utilization=1.0)
    return estimate


def _ell_coo_estimate(name: str):
    def estimate(m, d, ctx: KernelContext) -> KernelRoofline:
        k_cut, tail = ell_coo_split_stats(m)
        tb = sm.ai_ell_coo(m.n, m.nnz, d, k_cut=k_cut, tail_nnz=tail)
        issued = max(m.n * k_cut + tail, 1)
        return KernelRoofline(
            name=name, ai=tb.ai, useful_flops=tb.flops,
            mxu_flops=2.0 * d * issued,
            attainable_flops_per_s=ctx.hardware.attainable(tb.ai),
            mxu_utilization=min(1.0, m.nnz / issued))
    return estimate


for _f, _desc, _est in (
        ("binned", "slab-binned gather + index_add_ (PyTorch)",
         _binned_estimate("binned_spmm_torch", _torch_slab)),
        ("rowsplit", "equal-nnz chunk gather + index_add_ (PyTorch)",
         _rowsplit_estimate("rowsplit_spmm_torch")),
        ("ell_coo", "padded-body slot scan + COO-tail index_add_ (PyTorch)",
         _ell_coo_estimate("ell_coo_spmm_torch"))):
    register(KernelSpec(
        format=_f, backend="torch", description=_desc,
        prepare=_torch_prepare(_f), run=_torch_run(_f),
        estimate=_est, footprint=_zero_footprint,
        supported_precisions=_TORCH_PRECISIONS))


# ------------------------------------------------------------------ #
# "cuda" specs: the hand-written kernels
# ------------------------------------------------------------------ #

def _host_csr(m, ctx: KernelContext):
    """Host CSR arrays at the precision's value dtype (bf16 as bits)."""
    from repro_torch.sparse import formats as fmt
    return fmt.csr_host_arrays(m, ctx.precision.value_torch)


def _csr_cuda_prepare(m, ctx: KernelContext):
    bt = ctx.resolve_b_tile(m.n)
    arrays = csr_to_row_tiles(*_host_csr(m, ctx), n=m.n,
                              row_tile=ctx.row_tile, chunk=ctx.chunk,
                              b_tile=bt, index_dtype=ctx.precision.index_np)
    return row_tile_layout(*arrays, n=m.n, b_tile=bt, row_tile=ctx.row_tile,
                           device=ctx.device)


def _reduce_b(b, ctx: KernelContext):
    return b.to(ctx.precision.value_torch) if ctx.precision.reduced else b


def _csr_cuda_run(layout, b, ctx: KernelContext):
    return csr_spmm(layout, _reduce_b(b, ctx))


def _csr_cuda_estimate(m, d, ctx: KernelContext) -> KernelRoofline:
    tb = sm.arithmetic_intensity("random", m.n, m.nnz, d)
    return KernelRoofline(
        name="csr_spmm", ai=tb.ai, useful_flops=tb.flops, mxu_flops=tb.flops,
        attainable_flops_per_s=ctx.hardware.attainable(tb.ai),
        mxu_utilization=1.0)


def _csr_cuda_footprint(n: int, d: int, ctx: KernelContext) -> int:
    bd = min(512, pallas_block_d(d))
    bt = ctx.resolve_b_tile(n) or n
    sv = ctx.precision.sizeof_val
    si = ctx.precision.sizeof_idx
    return (sv * (bt * bd + ctx.chunk * bd + ctx.chunk)
            + si * 2 * ctx.chunk + 4 * ctx.row_tile * bd)


for _f in ("csr", "ell"):
    # ELL lowers to the row-tiled CSR kernel (layout_key="csr": both
    # specs share one cached row-tile packing per matrix).
    register(KernelSpec(
        format=_f, backend="cuda",
        description="row-tiled gather kernel: one warp per work piece over "
                    "the real entries only, hub tiles split, B gathered "
                    "by L2-sized row slabs",
        prepare=_csr_cuda_prepare, run=_csr_cuda_run,
        estimate=_csr_cuda_estimate, footprint=_csr_cuda_footprint,
        layout_key="csr", supported_precisions=_CUDA_STREAM_PRECISIONS))


def _binned_cuda_prepare(m, ctx: KernelContext):
    bt = ctx.resolve_b_tile(m.n)
    arrays = csr_to_slab_bins(*_host_csr(m, ctx), n=m.n,
                              row_tile=ctx.row_tile, chunk=ctx.chunk,
                              b_tile=bt, index_dtype=ctx.precision.index_np)
    return slab_bin_layout(*arrays, n=m.n, b_tile=bt, row_tile=ctx.row_tile,
                           device=ctx.device)


def _binned_cuda_run(layout, b, ctx: KernelContext):
    return binned_spmm(layout, _reduce_b(b, ctx))


register(KernelSpec(
    format="binned", backend="cuda",
    description="two-phase binned kernel: slab-major visits, one warp per "
                "work piece, touched rows folded by fp32 atomics in the "
                "kernel",
    prepare=_binned_cuda_prepare, run=_binned_cuda_run,
    estimate=_binned_estimate("binned_spmm", _cuda_slab),
    footprint=_csr_cuda_footprint,
    layout_key="binned", supported_precisions=_CUDA_STREAM_PRECISIONS))


def _rowsplit_cuda_prepare(m, ctx: KernelContext):
    arrays = pack_rowsplit_chunks(*_host_csr(m, ctx), n=m.n, chunk=ctx.chunk,
                                  index_dtype=ctx.precision.index_np)
    return rowsplit_layout(*arrays, n=m.n, device=ctx.device)


def _rowsplit_cuda_run(layout, b, ctx: KernelContext):
    return rowsplit_spmm(layout, _reduce_b(b, ctx))


def _rowsplit_cuda_footprint(n: int, d: int, ctx: KernelContext) -> int:
    bd = min(512, pallas_block_d(d))
    n_pad = -(-n // 8) * 8
    sv = ctx.precision.sizeof_val
    si = ctx.precision.sizeof_idx
    # The reference's model: all of B, the gathered chunk and its values at
    # the value width, cols/slots at the index width, the fp32 window.
    return (sv * (n_pad * bd + ctx.chunk * bd + ctx.chunk)
            + si * 2 * ctx.chunk + 4 * ctx.chunk * bd)


register(KernelSpec(
    format="rowsplit", backend="cuda",
    description="equal-nnz row-split kernel: one warp per chunk stores "
                "the rows it owns into C, shared end rows go to fp32 "
                "carries that a second launch sums in chunk order",
    prepare=_rowsplit_cuda_prepare, run=_rowsplit_cuda_run,
    estimate=_rowsplit_estimate("rowsplit_spmm"),
    footprint=_rowsplit_cuda_footprint,
    layout_key="rowsplit", supported_precisions=_CUDA_STREAM_PRECISIONS))

# The hybrid ELL/COO pick lowers to the row-tiled CSR kernel (like ELL):
# the chunk packing already splits short rows from hub-row overflow, so
# the pair shares the cached CSR layout and differs only in its estimate.
register(KernelSpec(
    format="ell_coo", backend="cuda",
    description="hybrid ELL/COO pick lowered to the row-tiled CSR kernel "
                "(hub tiles split into work pieces)",
    prepare=_csr_cuda_prepare, run=_csr_cuda_run,
    estimate=_ell_coo_estimate("ell_coo_spmm"),
    footprint=_csr_cuda_footprint,
    layout_key="csr", supported_precisions=_CUDA_STREAM_PRECISIONS))


def _bcsr_cuda_prepare(m, ctx: KernelContext):
    return with_quadrants(pad_empty_block_rows(_convert(ctx, m, "bcsr")))


def _bcsr_cuda_run(layout, b, ctx: KernelContext):
    return bcsr_spmm(layout, _reduce_b(b, ctx))


def _bcsr_estimate(m, d, ctx: KernelContext) -> KernelRoofline:
    from repro_torch.core.classify import block_stats
    t = ctx.bcsr_block
    stats = block_stats(m, t)
    N = max(int(stats["N"]), 1)
    tb = sm.ai_blocked_tpu(m.n, m.nnz, d, t=t, num_blocks=N)
    return KernelRoofline(
        name="bcsr_spmm", ai=tb.ai, useful_flops=tb.flops,
        mxu_flops=2.0 * d * t * t * N,
        attainable_flops_per_s=ctx.hardware.attainable(tb.ai),
        mxu_utilization=sm.mxu_utilization(m.nnz, t, N))


def _bcsr_cuda_footprint(n: int, d: int, ctx: KernelContext) -> int:
    t, bd = ctx.bcsr_block, min(512, pallas_block_d(d))
    sv = ctx.precision.sizeof_val
    return sv * (t * t + t * bd) + 4 * t * bd


register(KernelSpec(
    format="bcsr", backend="cuda",
    description="dense-block kernel: at t = 64 persistent blocks walk a "
                "ring of (A block, B tile) pairs across block rows "
                "(register-tiled fp32 FMA over the quadrants a pack-time "
                "mask holds; TMA + wgmma at bf16), else one block per "
                "block row",
    prepare=_bcsr_cuda_prepare, run=_bcsr_cuda_run,
    estimate=_bcsr_estimate, footprint=_bcsr_cuda_footprint,
    # Block coordinates are per-block metadata, not per-nonzero traffic,
    # so bcsr gains nothing from int16 and keeps int32.
    supported_precisions=_TORCH_PRECISIONS))


def _dia_cuda_prepare(m, ctx: KernelContext):
    # The kernel walks DIA storage as converted (on ctx.device): no band.
    dia = _convert(ctx, m, "dia")
    return dia_layout(dia.data, dia.offsets)


def _dia_cuda_run(layout, b, ctx: KernelContext):
    return banded_spmm(layout, _reduce_b(b, ctx))


def _dia_cuda_estimate(m, d, ctx: KernelContext) -> KernelRoofline:
    return dia_kernel_roofline(m, d, ctx.hardware)


def _dia_cuda_footprint(n: int, d: int, ctx: KernelContext) -> int:
    # What one block of the walk stages: the k diagonal rows of its tile
    # (k at the conversion's cap) and at most the window's budget of B.
    sv = ctx.precision.sizeof_val
    return (sv * ctx.max_dia_offsets * banded_module.ROWS
            + banded_module.WINDOW_BUDGET)


register(KernelSpec(
    format="dia", backend="cuda",
    description="diagonal walk over the DIA storage's diagonals, B window "
                "staged in shared memory (read through L1 past its budget)",
    prepare=_dia_cuda_prepare, run=_dia_cuda_run,
    estimate=_dia_cuda_estimate, footprint=_dia_cuda_footprint,
    # DIA stores no per-nonzero indices, so only the value axis applies.
    supported_precisions=_TORCH_PRECISIONS))


def _grouped_cuda_prepare(operand, ctx: KernelContext):
    # Operand: (w[E, K, N], group_ids[T // bm], bm, bk, bn), on ctx.device.
    w, group_ids, bm, bk, bn = operand
    dev = device_of(ctx.device)
    group_ids = group_ids.to(dev, torch.int32)
    check_group_ids(group_ids, w.shape[0])
    return (w.to(dev), group_ids, bm, bk, bn)


def _grouped_cuda_run(layout, x, ctx: KernelContext):
    w, group_ids, bm, bk, bn = layout
    return grouped_matmul(x, w, group_ids, bm=bm, bk=bk, bn=bn)


def _grouped_estimate(operand, d, ctx: KernelContext) -> KernelRoofline:
    w, group_ids, bm, _, _ = operand
    E, K, N = w.shape
    return grouped_matmul_roofline(int(group_ids.shape[0]) * bm, K, N, E,
                                   hw=ctx.hardware)


def _grouped_footprint(n: int, d: int, ctx: KernelContext) -> int:
    bm = bk = bn = 128
    return 4 * (bm * bk + bk * bn + bm * bn)


register(KernelSpec(
    format="grouped", backend="cuda",
    description="MoE expert FFN as block-diagonal grouped matmul (fp32 FMA, "
                "or bf16 wgmma fed by a TMA ring)",
    prepare=_grouped_cuda_prepare, run=_grouped_cuda_run,
    estimate=_grouped_estimate, footprint=_grouped_footprint,
    operand="moe"))
