"""Persisted per-format compute ceilings (the calibration store).

The dispatcher caps every bandwidth roofline with a format compute
ceiling ``peak * peak_fraction * useful * d / (d + d_half)``.  A
calibration replaces the baked-in ``(peak_fraction, d_half)`` defaults
with values fitted on the device the code runs on.  This module holds
the records and their store; the sweep that fits them on the card comes
in a later slice.

Files live under ``$REPRO_CALIBRATION_DIR`` (or
``~/.cache/repro/calibrations``) as ``<HardwareSpec.name>-<backend>.json``.
The port's backends are ``"torch"`` and ``"cuda"``, so its files never
collide with the reference's ``"jax"`` / ``"pallas"`` ones.  A file is
stamped with the spec's fingerprint and the port's kernel
``REGISTRY_VERSION``; a stale file is ignored.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import time
from typing import Dict, Optional, Tuple

from repro_torch.core.hardware import HardwareSpec


@dataclasses.dataclass(frozen=True)
class FormatCalibration:
    """Fitted ceiling for one (format, backend, precision) on one device."""

    format: str
    backend: str
    peak_fraction: float
    d_half: float
    sustained_gflops: float           # fitted asymptote, useful GFLOP/s
    useful_fraction: float            # of the calibration matrix
    measured: Dict[int, float]        # d -> measured useful GFLOP/s
    precision: str = "f32i32"


@dataclasses.dataclass(frozen=True)
class Calibration:
    """A full calibration run: per-format ceilings + provenance."""

    hardware: str                     # HardwareSpec.name
    fingerprint: str                  # HardwareSpec.fingerprint()
    backend: str
    entries: Tuple[FormatCalibration, ...]
    #: ``repro_torch.kernels.registry.REGISTRY_VERSION`` at fit time.
    registry_version: int = 0

    def efficiency(self, precision: str = "f32i32"
                   ) -> Dict[str, Tuple[float, float]]:
        """The ``format -> (peak_fraction, d_half)`` ceiling table.

        A format's entry for the requested precision token wins; formats
        calibrated only at fp32 fall back to that fit.
        """
        out = {e.format: (e.peak_fraction, e.d_half)
               for e in self.entries if e.precision == "f32i32"}
        if precision != "f32i32":
            out.update({e.format: (e.peak_fraction, e.d_half)
                        for e in self.entries if e.precision == precision})
        return out


def _default_root() -> pathlib.Path:
    return pathlib.Path(os.environ.get("REPRO_CALIBRATION_DIR") or (
        pathlib.Path.home() / ".cache" / "repro" / "calibrations"))


class CalibrationStore:
    """Persistence for :class:`Calibration` results, one file per
    (device, backend); ``load`` refuses a stale or foreign file."""

    def __init__(self, root: Optional[os.PathLike] = None):
        """Open (without touching the filesystem) the store at ``root``."""
        self.root = pathlib.Path(root) if root is not None \
            else _default_root()

    def path_for(self, hw: HardwareSpec,
                 backend: str = "torch") -> pathlib.Path:
        """The JSON path holding ``hw``'s calibration for ``backend``."""
        return self.root / f"{hw.name}-{backend}.json"

    def save(self, cal: Calibration) -> pathlib.Path:
        """Write ``cal`` (creating the store directory) and return the path."""
        self.root.mkdir(parents=True, exist_ok=True)
        path = self.root / f"{cal.hardware}-{cal.backend}.json"
        payload = dataclasses.asdict(cal)
        payload["saved_unix"] = time.time()
        path.write_text(json.dumps(payload, indent=2), encoding="utf-8")
        return path

    def _payload(self, hw: HardwareSpec, backend: str):
        path = self.path_for(hw, backend)
        if not path.is_file():
            return path, None
        try:
            return path, json.loads(path.read_text(encoding="utf-8"))
        except (OSError, json.JSONDecodeError):
            return path, "unreadable"

    def load(self, hw: HardwareSpec,
             backend: str = "torch") -> Optional[Calibration]:
        """Read the calibration for ``(hw, backend)``; None when absent,
        unreadable, fitted for another fingerprint, or another backend."""
        _, payload = self._payload(hw, backend)
        if not isinstance(payload, dict):
            return None
        if payload.get("fingerprint") != hw.fingerprint():
            return None
        if payload.get("backend") != backend:
            return None
        entries = tuple(
            FormatCalibration(
                format=e["format"], backend=e["backend"],
                peak_fraction=float(e["peak_fraction"]),
                d_half=float(e["d_half"]),
                sustained_gflops=float(e["sustained_gflops"]),
                useful_fraction=float(e["useful_fraction"]),
                measured={int(k): float(v)
                          for k, v in e["measured"].items()},
                precision=e.get("precision", "f32i32"))
            for e in payload.get("entries", ()))
        return Calibration(hardware=payload["hardware"],
                           fingerprint=payload["fingerprint"],
                           backend=payload["backend"], entries=entries,
                           registry_version=int(
                               payload.get("registry_version", 0)))

    def staleness_note(self, hw: HardwareSpec,
                       backend: str = "torch") -> Optional[str]:
        """One-line staleness warning for ``(hw, backend)``, or ``None``.

        A missing file is not stale (defaults are then intended); an
        unreadable file, a fingerprint mismatch, or a calibration fitted
        against an older kernel registry each earn a note.
        """
        path, payload = self._payload(hw, backend)
        if payload is None:
            return None
        if not isinstance(payload, dict):
            return (f"calibration file {path.name} is unreadable; using "
                    f"default ceilings")
        if payload.get("fingerprint") != hw.fingerprint():
            return (f"calibration {path.name} was fitted for fingerprint "
                    f"{payload.get('fingerprint')}, active spec is "
                    f"{hw.fingerprint()}; using default ceilings")
        from repro_torch.kernels import registry
        stored = int(payload.get("registry_version", 0))
        if stored < registry.REGISTRY_VERSION:
            return (f"calibration {path.name} predates kernel registry "
                    f"v{registry.REGISTRY_VERSION} (fitted at "
                    f"v{stored}); ceilings may describe retired kernels")
        return None
