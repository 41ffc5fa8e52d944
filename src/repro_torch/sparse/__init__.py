"""Sparse formats, SpMM implementations, dispatcher and streaming layer.

``plan(m, b_spec)`` is the serving entry point: it classifies the matrix,
evaluates each format's sparsity-aware roofline on the device, converts
and packs once, and ``plan.execute(b)`` replays the bound kernel.  Plans
run on the card unless ``device="cpu"`` is passed.

The package attribute ``spmm`` is the :mod:`repro_torch.sparse.spmm`
submodule (the plain PyTorch implementations); the one-shot dispatching
function is :func:`repro_torch.sparse.dispatch.spmm`, or
``Dispatcher.spmm``.  Keeping the two names apart means neither hides
the other.
"""
from repro_torch.sparse import spmm
from repro_torch.sparse.formats import (
    BCSRMatrix, BinnedMatrix, CSRMatrix, DEFAULT_PRECISION, DIAMatrix,
    ELLCOOMatrix, ELLMatrix, INT16_MAX_EXTENT, PRECISION_BF16,
    PRECISION_BF16_I32, PRECISION_FP32, PRECISIONS, Precision,
    RowSplitMatrix, as_precision,
    coo_to_bcsr, coo_to_binned, coo_to_csr, coo_to_dense, coo_to_dia,
    coo_to_ell, coo_to_ell_coo, coo_to_rowsplit, ell_coo_cutoff,
    int16_extent_ok, nnz_balanced_splits,
)
from repro_torch.sparse.spmm import (
    IMPLEMENTATIONS, bcsr_spmm, binned_spmm, csr_spmm, dense_spmm, dia_spmm,
    ell_coo_spmm, ell_spmm, rowsplit_spmm,
)
from repro_torch.sparse.dispatch import (
    DispatchPlan, Dispatcher, FORMATS, STRATEGIES, default_dispatcher,
    plan_spmm,
)
from repro_torch.sparse.stream import BSpec, StreamPlan, as_b_spec, plan

__all__ = [
    "spmm",
    "BCSRMatrix", "BinnedMatrix", "CSRMatrix", "DIAMatrix", "ELLCOOMatrix",
    "ELLMatrix", "RowSplitMatrix",
    "coo_to_bcsr", "coo_to_binned", "coo_to_csr", "coo_to_dense",
    "coo_to_dia", "coo_to_ell", "coo_to_ell_coo", "coo_to_rowsplit",
    "ell_coo_cutoff", "nnz_balanced_splits",
    "Precision", "PRECISIONS", "PRECISION_FP32", "PRECISION_BF16",
    "PRECISION_BF16_I32", "DEFAULT_PRECISION", "INT16_MAX_EXTENT",
    "as_precision", "int16_extent_ok",
    "IMPLEMENTATIONS", "bcsr_spmm", "binned_spmm", "csr_spmm", "dense_spmm",
    "dia_spmm", "ell_coo_spmm", "ell_spmm", "rowsplit_spmm",
    "DispatchPlan", "Dispatcher", "FORMATS", "STRATEGIES",
    "default_dispatcher", "plan_spmm",
    "BSpec", "StreamPlan", "as_b_spec", "plan",
]
