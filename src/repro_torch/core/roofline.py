"""Roofline model plumbing (paper Section II-C), plus the three-term
distributed extension the dry run (``repro_torch.launch.dryrun``) feeds.

The classic single-device roofline is ``P = min(beta * AI, pi)``
(``HardwareSpec.attainable``); :class:`RooflinePoint` / :func:`place` put
one kernel or workload on it.  The dispatcher caps it with a per-format
:class:`ComputeCeiling`.  The sharded tier (``repro_torch.sparse.shard``)
adds a collective term: :func:`collective_time` prices a collective over
``HardwareSpec.collective_bandwidth`` and :class:`ShardRoofline` puts the
critical shard's local time beside it.  For a cluster step
:class:`DistributedRoofline` reports three time terms:

  compute    = FLOPs / (chips * peak_flops)
  memory     = bytes / (chips * hbm_bandwidth)
  collective = collective_bytes / (chips * link_bandwidth)

The step can never run faster than the largest term under perfect
overlap.  ``link_bandwidth`` is one link's rate (NVLink's 450 GB/s on the
H100 SXM), which is optimistic for a mesh axis that leaves an 8-card
NVLink node: such traffic crosses the slower network between nodes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.core.hardware import HardwareSpec
from repro_torch.core.sparsity_models import TrafficBreakdown


@dataclasses.dataclass(frozen=True)
class ComputeCeiling:
    """A format implementation's compute ceiling on one device.

    The dispatcher caps the bandwidth roofline ``beta * AI`` with

        peak * peak_fraction * useful_fraction * d / (d + d_half)

    in useful FLOP/s: ``peak_fraction`` is the fraction of hardware peak
    the implementation sustains at large d on its *issued* FLOPs,
    ``d_half`` the dense width at which per-nonzero index/bookkeeping
    overhead halves throughput.  ``source`` records provenance:
    ``"default"`` (the baked-in constants), ``"calibrated"`` (a persisted
    calibration for this device), or ``"override"``
    (``Dispatcher(efficiency=...)``).
    """

    peak_fraction: float
    d_half: float
    source: str = "default"

    def attainable(self, peak_flops: float, useful_fraction: float,
                   d: int) -> float:
        """The ceiling in useful FLOP/s for dense width ``d``."""
        return (peak_flops * self.peak_fraction * useful_fraction
                * d / (d + self.d_half))


@dataclasses.dataclass(frozen=True)
class RooflinePoint:
    """One kernel/workload placed on a device roofline."""

    name: str
    ai: float                       # FLOPs / byte
    flops: float                    # total useful FLOPs
    hardware: HardwareSpec
    attained_flops_per_s: Optional[float] = None   # measured, if available

    @property
    def bound(self) -> str:
        return "compute" if self.ai >= self.hardware.ridge_point else "memory"

    @property
    def attainable_flops_per_s(self) -> float:
        return self.hardware.attainable(self.ai)

    @property
    def roofline_fraction(self) -> Optional[float]:
        """Measured / attainable; None when nothing was measured."""
        if self.attained_flops_per_s is None:
            return None
        return self.attained_flops_per_s / self.attainable_flops_per_s


def place(name: str, traffic: TrafficBreakdown, hw: HardwareSpec,
          attained: Optional[float] = None) -> RooflinePoint:
    """Place a sparsity-model traffic estimate on a hardware roofline."""
    return RooflinePoint(name=name, ai=traffic.ai, flops=traffic.flops,
                         hardware=hw, attained_flops_per_s=attained)


def collective_time(bytes_on_wire: float, hw: HardwareSpec,
                    devices: int, *, collectives: int = 1) -> float:
    """Seconds one device spends moving ``bytes_on_wire`` collectively.

    A bandwidth term (bytes over ``hw.collective_bandwidth``) plus a
    latency term of ``collectives * collective_latency_s *
    ceil(log2(devices))``: each collective synchronizes the mesh over
    about log2(D) hops whatever its payload.  One device has no wire and
    costs 0.

    Args:
        bytes_on_wire: per-device bytes the collective moves (for a ring
            all-gather or reduce-scatter of an ``S``-byte buffer,
            ``(D-1)/D * S``).
        hw: hardware spec supplying ``collective_bandwidth`` and
            ``collective_latency_s``.
        devices: mesh size D.
        collectives: number of distinct collective launches to charge
            latency for.

    Returns:
        Modeled seconds.
    """
    if devices <= 1:
        return 0.0
    hops = math.ceil(math.log2(devices))
    bw = hw.collective_bandwidth
    transfer = bytes_on_wire / bw if bw > 0 else 0.0
    return transfer + collectives * hw.collective_latency_s * hops


@dataclasses.dataclass(frozen=True)
class ShardRoofline:
    """Per-shard roofline: the sparsity-aware AI of the *critical* shard
    plus the collective term of the chosen B-distribution strategy.

    The local side is evaluated on the most loaded shard (the sharded
    replay runs at the speed of its slowest shard) and the communication
    side adds the strategy's collective bytes at ``collective_bandwidth``.
    ``predicted_flops_per_s`` is the whole-matrix useful FLOP rate with
    no overlap of compute and communication.
    """

    strategy: str                  # "replicate" | "all_gather" | "reduce_scatter"
    devices: int
    shard_ai: float                # AI of the most loaded shard
    critical_flops: float          # useful FLOPs on the most loaded shard
    total_flops: float             # useful FLOPs of the whole SpMM
    compute_s: float               # critical shard local kernel time
    collective_s: float            # strategy's collective cost
    collective_bytes: float        # per-device bytes on the wire

    @property
    def total_s(self) -> float:
        """Zero-overlap step time: local compute + collectives."""
        return self.compute_s + self.collective_s

    @property
    def predicted_flops_per_s(self) -> float:
        """Whole-matrix useful FLOP/s implied by ``total_s``."""
        if self.total_s <= 0:
            return 0.0
        return self.total_flops / self.total_s

    @property
    def dominant(self) -> str:
        """Which term binds: ``"compute"`` or ``"collective"``."""
        return ("collective" if self.collective_s > self.compute_s
                else "compute")


@dataclasses.dataclass(frozen=True)
class DistributedRoofline:
    """Three-term roofline for one (arch x shape x mesh) dry-run cell.

    ``hlo_flops`` / ``hlo_bytes`` keep the reference's field names: in the
    port they are the counted step's FLOPs and bytes over all chips
    (``core.step_cost``), not an HLO module's."""

    name: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    hardware: HardwareSpec
    model_flops: float = 0.0        # 6*N*D (+attention) useful FLOPs

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * self.hardware.peak_flops)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * self.hardware.hbm_bandwidth)

    @property
    def collective_s(self) -> float:
        if self.hardware.link_bandwidth <= 0:
            return 0.0
        return self.collective_bytes / (self.chips
                                        * self.hardware.link_bandwidth)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_lower_bound_s(self) -> float:
        """Perfect-overlap bound: the slowest of the three pipes."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_compute_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: catches recompute and padding."""
        if self.hlo_flops <= 0:
            return 0.0
        return self.model_flops / self.hlo_flops

    @property
    def mfu_upper_bound(self) -> float:
        """Model-FLOPs utilization ceiling implied by the dominant term."""
        denom = self.step_time_lower_bound_s * self.chips * \
            self.hardware.peak_flops
        if denom <= 0:
            return 0.0
        return self.model_flops / denom

    def as_dict(self) -> dict:
        return {
            "name": self.name,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "useful_compute_ratio": self.useful_compute_ratio,
            "mfu_upper_bound": self.mfu_upper_bound,
            "step_time_lower_bound_s": self.step_time_lower_bound_s,
        }
