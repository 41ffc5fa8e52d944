"""Roofline model plumbing (paper Section II-C).

The classic single-device roofline is ``P = min(beta * AI, pi)``
(``HardwareSpec.attainable``).  The dispatcher caps it with a per-format
:class:`ComputeCeiling`.  The sharded tier (``repro_torch.sparse.shard``)
adds a collective term: :func:`collective_time` prices a collective over
``HardwareSpec.collective_bandwidth`` and :class:`ShardRoofline` puts the
critical shard's local time beside it.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hardware import HardwareSpec


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
