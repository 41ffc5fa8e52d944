"""Hand-written Hopper kernels for the SpMM hot spots and the MoE grouped
matmul, and their registry.

``repro_torch.kernels.registry`` is the uniform entry point: one
``KernelSpec`` (layout prep, launch, roofline estimate, footprint) per
``(format, backend)`` pair.  Each kernel module holds the host packer, the
CUDA wrapper, the plain PyTorch version and a launch counter
(``<module>.LAUNCHES``); :func:`launch_counts` reads them all.
"""
from repro_torch.kernels import (banded_spmm, bcsr_spmm, binned_spmm,
                                 csr_spmm, grouped_matmul, registry,
                                 rowsplit_spmm)
from repro_torch.kernels.registry import (
    KernelContext, KernelRoofline, KernelSpec, band_to_blocks,
    choose_b_tile, feature_matrix, formats_for, pad_empty_block_rows,
)

#: The kernel modules, by the name of their CUDA source (``csrc/<name>.cu``).
KERNEL_MODULES = {"csr_spmm": csr_spmm, "binned_spmm": binned_spmm,
                  "rowsplit_spmm": rowsplit_spmm, "bcsr_spmm": bcsr_spmm,
                  "banded_spmm": banded_spmm,
                  "grouped_matmul": grouped_matmul}


def launch_counts() -> dict:
    """``kernel name -> launches`` since the last :func:`reset_launch_counts`."""
    return {name: mod.LAUNCHES for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    for mod in KERNEL_MODULES.values():
        mod.LAUNCHES = 0


__all__ = [
    "registry", "KERNEL_MODULES", "launch_counts", "reset_launch_counts",
    "KernelContext", "KernelRoofline", "KernelSpec", "band_to_blocks",
    "choose_b_tile", "feature_matrix", "formats_for",
    "pad_empty_block_rows",
]
