"""Hardware descriptions used by the roofline models.

The port's deployment target is one NVIDIA H100; the CPU spec describes
the host the plain PyTorch path runs on, and :data:`PERLMUTTER_MILAN` the
paper's own evaluation node.  All are expressed with the same dataclass so
every roofline routine is hardware-agnostic.

``vmem_bytes`` on the H100 is the 50 MB L2 cache, not the 227 KB of shared
memory a thread block may use.  The field sizes the B row slab of the
row-tiled kernels (``registry.choose_b_tile``), the binned traffic model
and int16 index legality.  The port's kernels gather B through L2, and a
slab sized to shared memory (~440 rows at d = 64) would scatter each row
tile's nonzeros over thousands of slabs, one padded chunk each.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    """Architectural ceilings for a single device (card / socket)."""

    name: str
    peak_flops: float          # FLOP/s (per device) at the relevant precision
    hbm_bandwidth: float       # bytes/s main-memory bandwidth (per device)
    link_bandwidth: float      # bytes/s per inter-device link (0 => none)
    vmem_bytes: int = 0        # cache budget the slab sizing may fill
    hbm_bytes: int = 0         # main memory capacity per device
    mxu_tile: tuple = (128, 128)  # native arithmetic tile (rows, cols)
    #: Aggregate interconnect bandwidth one device can drive during a
    #: collective (bytes/s).  0 means "unknown": model collectives at the
    #: per-link ``link_bandwidth``, or — when that is 0 too — at
    #: ``hbm_bandwidth``.
    ici_bytes_per_s: float = 0.0
    #: Fixed launch/synchronization latency per collective hop (seconds).
    collective_latency_s: float = 10e-6

    @property
    def ridge_point(self) -> float:
        """Arithmetic intensity where memory-bound meets compute-bound."""
        return self.peak_flops / self.hbm_bandwidth

    def attainable(self, ai: float) -> float:
        """Classic roofline: P = min(beta * AI, pi)."""
        return min(self.hbm_bandwidth * ai, self.peak_flops)

    @property
    def collective_bandwidth(self) -> float:
        """Effective bytes/s a device moves during collectives."""
        return (self.ici_bytes_per_s or self.link_bandwidth
                or self.hbm_bandwidth)

    def fingerprint(self) -> str:
        """Stable id of this spec's *compute* identity (12 hex chars).

        Keys persisted kernel calibrations (``repro_torch.core.calibrate``):
        a calibration fitted on one device must not be applied to another.
        Bandwidth and interconnect fields are excluded, exactly as in the
        reference package, so the same fields give the same fingerprint in
        both packages.
        """
        payload = json.dumps({
            "name": self.name, "peak_flops": self.peak_flops,
            "vmem_bytes": self.vmem_bytes,
            "mxu_tile": list(self.mxu_tile),
        }, sort_keys=True)
        return hashlib.sha256(payload.encode()).hexdigest()[:12]


# --- The paper's evaluation platform (Table IV + measured STREAM beta),
# field for field as the reference package has it. ---
PERLMUTTER_MILAN = HardwareSpec(
    name="amd-epyc-7763-1socket",
    peak_flops=64 * 2.45e9 * 16,      # 64 cores x 2.45 GHz x (AVX2 FMA: 16 dp flop/cyc)
    hbm_bandwidth=122.6e9,            # STREAM-measured in the paper
    link_bandwidth=0.0,
    vmem_bytes=256 * 2**20,           # 256 MiB L3 per socket
    hbm_bytes=512 * 2**30,
    mxu_tile=(1, 4),                  # AVX2 dp vector as the "tile"
)

# Host CPU (used for CPU runs of the plain PyTorch backend; the same
# fields as the reference's HOST_CPU so plans compare like with like).
HOST_CPU = HardwareSpec(
    name="container-host-cpu",
    peak_flops=50e9,
    hbm_bandwidth=10e9,
    link_bandwidth=0.0,
    vmem_bytes=32 * 2**20,
    hbm_bytes=35 * 2**30,
    mxu_tile=(1, 4),
    collective_latency_s=20e-6,
)

#: L2 cache of the H100 (both parts), the slab budget (module docstring).
H100_L2_BYTES = 50 * 2**20

# --- NVIDIA H100 (vendor datasheet figures, dense rates). ---
# ``peak_flops`` is the fp32 rate of the CUDA cores, because this port's
# kernels run on CUDA cores; a tensor-core kernel would revisit it.
H100_SXM = HardwareSpec(
    name="nvidia-h100-sxm",
    peak_flops=67e12,                 # fp32, CUDA cores
    hbm_bandwidth=3.35e12,            # HBM3
    link_bandwidth=450e9,             # NVLink, each way
    vmem_bytes=H100_L2_BYTES,
    hbm_bytes=80 * 2**30,
    mxu_tile=(1, 32),                 # one warp of fp32 lanes
    ici_bytes_per_s=450e9,
)

H100_PCIE = HardwareSpec(
    name="nvidia-h100-pcie",
    peak_flops=51e12,                 # fp32, CUDA cores
    hbm_bandwidth=2.0e12,             # HBM2e
    link_bandwidth=64e9,              # PCIe 5.0 x16
    vmem_bytes=H100_L2_BYTES,
    hbm_bytes=80 * 2**30,
    mxu_tile=(1, 32),
)

#: The default H100 description (the SXM part).
H100 = H100_SXM

#: Dense bf16 tensor-core rates of the two parts (vendor datasheet
#: figures, at the full power limit).
BF16_TENSOR_FLOPS = {H100_SXM.name: 989e12, H100_PCIE.name: 756e12}


def tensor_core(hw: HardwareSpec) -> HardwareSpec:
    """``hw`` with ``peak_flops`` at its bf16 tensor-core rate: the
    ceiling of a model step, whose products run in bf16 on the tensor
    cores, where ``hw.peak_flops`` is the fp32 CUDA-core rate the SpMM
    kernels run at.  A spec without a tensor-core rate is returned as it
    is."""
    rate = BF16_TENSOR_FLOPS.get(hw.name)
    if rate is None:
        return hw
    return dataclasses.replace(hw, peak_flops=rate)


#: The H100 SXM at its bf16 tensor-core rate: the dry run's default.
H100_BF16 = tensor_core(H100_SXM)


def h100_from_device(device=None) -> HardwareSpec:
    """The H100 spec of a CUDA device, from its reported properties.

    The part (SXM or PCIe) is read from the device name; the L2 size and
    memory capacity from ``torch.cuda.get_device_properties``.  Rates come
    from the vendor datasheet, since the device does not report them.

    Args:
        device: a CUDA device (index, string or ``torch.device``).

    Returns:
        The matching :class:`HardwareSpec`.
    """
    import torch
    props = torch.cuda.get_device_properties(device)
    base = H100_PCIE if "pcie" in props.name.lower() else H100_SXM
    l2 = int(getattr(props, "L2_cache_size", 0) or base.vmem_bytes)
    return dataclasses.replace(base, vmem_bytes=l2,
                               hbm_bytes=int(props.total_memory))


def by_name(name: str) -> HardwareSpec:
    """Resolve a spec by its ``name`` or a short alias."""
    table = {h.name: h for h in (PERLMUTTER_MILAN, HOST_CPU, H100_SXM,
                                 H100_PCIE)}
    table.update({"milan": PERLMUTTER_MILAN, "host": HOST_CPU, "h100": H100_SXM, "h100-sxm": H100_SXM,
                  "h100-pcie": H100_PCIE})
    return table[name]
