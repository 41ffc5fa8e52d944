"""Roofline model plumbing (paper Section II-C).

The classic single-device roofline is ``P = min(beta * AI, pi)``
(``HardwareSpec.attainable``).  The dispatcher caps it with a per-format
:class:`ComputeCeiling`.
"""
from __future__ import annotations

import dataclasses


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
