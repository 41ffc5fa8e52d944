"""Core contribution: sparsity-aware roofline models for SpMM (port)."""
from repro_torch.core.hardware import (
    H100, H100_PCIE, H100_SXM, HOST_CPU, HardwareSpec, by_name,
    h100_from_device)
from repro_torch.core.roofline import ComputeCeiling
from repro_torch.core.sparsity_models import (
    TrafficBreakdown,
    ai_blocked,
    ai_blocked_tpu,
    ai_diagonal,
    ai_random,
    ai_scale_free,
    arithmetic_intensity,
    expected_occupied_columns,
    flops_spmm,
    hub_edge_fraction,
    mxu_utilization,
)
from repro_torch.core.patterns import (
    COOMatrix, banded, block_diagonal, blocked, erdos_renyi, fit_generator,
    paper_suite, scale_free, serving_suite,
)
from repro_torch.core.classify import StructureReport, classify

__all__ = [
    "HardwareSpec", "HOST_CPU", "H100", "H100_SXM",
    "H100_PCIE", "by_name", "h100_from_device",
    "ComputeCeiling",
    "TrafficBreakdown", "ai_blocked", "ai_blocked_tpu", "ai_diagonal",
    "ai_random", "ai_scale_free", "arithmetic_intensity",
    "expected_occupied_columns", "flops_spmm", "hub_edge_fraction",
    "mxu_utilization",
    "COOMatrix", "banded", "block_diagonal", "blocked", "erdos_renyi",
    "fit_generator", "paper_suite", "scale_free", "serving_suite",
    "StructureReport", "classify",
]
